"""Pure policy specs: numpy/stdlib only."""

import numpy as np


def get_policy(spec):
    return {"name": str(spec), "itemsize": np.dtype(np.float64).itemsize}
