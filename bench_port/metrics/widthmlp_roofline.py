"""The width head's kernel entry (``ops/widthmlp.py:width_mlp_fused_rot``,
K5) against its roofline: the least time its operations and bytes
(``counts/kernels.py:widthmlp``) take at the configuration's peaks, over its
device time per launch (CUDA events over repeated launches on inputs
captured from the cell's own path by its probe, ``kernels/widthmlp.py``), in %."""

from bench_port.counts.kernels import roofline_ms

PROBE = "widthmlp"


def read(run):
    timed = run.kernels.get(PROBE)
    if not timed:
        return None
    ms, ops, nbytes = timed
    return 100.0 * roofline_ms(ops, nbytes, run.peak_flops, run.peak_bytes)[0] / ms
