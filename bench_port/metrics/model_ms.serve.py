"""Device time of ``GraspBalance.forward`` (backbone, OBS re-seeding,
heads) per call: CUDA events from its forward pre-hook to its forward
hook, mean over the window's calls."""

import statistics


def read(run):
    ms = run.spans.get("model")
    return statistics.fmean(ms) if ms else None
