"""Device time from ``forward_train``'s return to the optimizer step's
pre-hook (the loss and the autograd backward, the scatter-add kernel
inside) per step: CUDA events, mean over the window's steps."""

import statistics


def read(run):
    ms = run.spans.get("backward")
    return statistics.fmean(ms) if ms else None
