"""Device time of ``GraspInference.segment`` (the shared FPS, the DSN, mean
shift) per call: CUDA events around it, mean over the window's calls.
Layer: segmentation + OBS half."""

import statistics


def read(run):
    ms = run.spans.get("segment")
    return statistics.fmean(ms) if ms else None
