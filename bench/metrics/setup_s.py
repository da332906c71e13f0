"""Set-up: process start to the first timed unit of work (host clock)."""


def read(run):
    return run.setup_s
