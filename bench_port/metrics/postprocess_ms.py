"""Device time of ``GraspInference.postprocess`` (grasp NMS, voxel
downsample, collision filter) per call: CUDA events, mean over the
window's calls."""

import statistics


def read(run):
    ms = run.spans.get("postprocess")
    return statistics.fmean(ms) if ms else None
