"""K9, the kNN kernel (``ops/knn.py``), against its roofline over every
launch of one training step: the least time of all their operations and
bytes (``counts/knn.py``) at the CUDA cores' float32 peak and the
configuration's memory bandwidth, over their summed device time (CUDA
events over repeated launches on the step's own inputs, captured by its
probe, ``kernels/knn.py``), in %."""

from bench_port.counts.kernels import roofline_ms
from bench_port.counts.knn import CUDA_CORE_FLOPS

PROBE = "knn"


def read(run):
    timed = run.kernels.get(PROBE)
    if not timed or not timed[0]:
        return None
    ms, ops, nbytes = timed
    return 100.0 * roofline_ms(ops, nbytes, CUDA_CORE_FLOPS, run.peak_bytes)[0] / ms
