"""Clean twin: the lazy-import idiom the contracts are built on.

Function-body imports never run at module import time, and
``if TYPE_CHECKING:`` blocks are annotation-only — both are exactly
what the import-purity rule must *not* flag.
"""

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import numpy


def lower(xs):
    import numpy as np  # lazy: runs only when a backend actually lowers
    return np.asarray(xs, dtype=np.int64)
