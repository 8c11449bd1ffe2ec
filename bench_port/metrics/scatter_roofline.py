"""The gather backward's kernel entry (``ops/scatter.py:scatter_add``, K11)
against its roofline, over every gather shape of one training step: the
least time of all their operations and bytes (``counts/kernels.py:scatter_add``)
at the configuration's peaks over their summed device time (CUDA events over
repeated launches on the step's own cotangents and indices, captured by its
probe, ``kernels/scatter.py``), in %."""

from bench_port.counts.kernels import roofline_ms

PROBE = "scatter"


def read(run):
    timed = run.kernels.get(PROBE)
    if not timed or not timed[0]:
        return None
    ms, ops, nbytes = timed
    return 100.0 * roofline_ms(ops, nbytes, run.peak_flops, run.peak_bytes)[0] / ms
