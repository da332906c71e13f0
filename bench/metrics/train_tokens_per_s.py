"""Tokens of every optimizer step completed in the window, over the
window's seconds (host clock, the device synchronised at the close)."""


def read(run):
    if not run.records or not run.window_s:
        return None
    return sum(r["tokens"] for r in run.records) / run.window_s
