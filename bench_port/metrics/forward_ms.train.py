"""Device time of ``GraspBalance.forward_train`` (the forward with label
matching) per step: CUDA events around the call, mean over the window's
steps."""

import statistics


def read(run):
    ms = run.spans.get("forward")
    return statistics.fmean(ms) if ms else None
