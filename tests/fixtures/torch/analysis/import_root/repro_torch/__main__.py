"""A lazy command line: its own imports are all in function bodies."""

import sys


def main(argv=None):
    from repro_torch.workloads import plan
    return plan(sys.argv[1:] if argv is None else argv)
