"""The 95th percentile of one pipeline call's wall latency over every call
of the window, numpy in to numpy out (host clock)."""

import numpy as np


def read(run):
    if not run.scenes_per_call or not run.latencies:
        return None
    return float(np.percentile(np.asarray(run.latencies) * 1e3, 95))
