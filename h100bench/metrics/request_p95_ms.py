"""The 95th percentile of every call's latency in the window, from the call
to its host fetch, in milliseconds (host clock)."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies, 95)) * 1e3
