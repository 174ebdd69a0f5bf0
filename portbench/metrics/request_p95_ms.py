"""The 95th percentile, over every request of the window, of the host time
from handing the request's host batch to the entry until its answer is
back on the host."""

import numpy as np


def read(run):
    if run.trace is not None or not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 95)) * 1e3
