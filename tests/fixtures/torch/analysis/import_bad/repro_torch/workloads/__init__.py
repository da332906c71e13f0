"""Violating twin: two import-time leaks from a declared-pure package.

`repro_torch.helper` is internal and stdlib-looking, but its own top-level
`import numpy` executes the moment this package is imported — the
transitive chain the subprocess probes could only witness one ordering
of.  The try-block torch import also runs at import time (the rule counts
both branches conservatively).
"""

from repro_torch.helper import centroid

try:
    import torch
except ImportError:
    torch = None


def plan():
    return centroid([1, 2, 3])
