"""K11's probe: the gather backward's kernel entry (``ops/scatter.py:scatter_add``),
which ``ops/gather.py`` calls for every gather of a training step.
``measure`` captures the cotangents and indices of every call in one step of
the cell's own path, times each with CUDA events over repeated launches and
counts their operations and bytes (``counts/kernels.py:scatter_add``)."""

from __future__ import annotations

import torch

from bench_port.counts import kernels as kernel_counts


def measure(drive, reps: int = 5):
    """(device ms, operations, bytes), each summed over the calls that one
    ``drive()`` makes, or None where it makes none."""
    from graspbalance_tpu_torch.ops import gather
    from graspbalance_tpu_torch.ops.scatter import scatter_add

    entry, seen = gather.scatter_add, []

    def keep(ct, idx, n):
        seen.append((ct, idx, n))
        return entry(ct, idx, n)

    gather.scatter_add = keep
    try:
        drive()
    finally:
        gather.scatter_add = entry
    if not seen:
        return None
    total_ms = total_ops = total_bytes = 0.0
    for ct, idx, n in seen:
        scatter_add(ct, idx, n)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            scatter_add(ct, idx, n)
        end.record()
        torch.cuda.synchronize()
        total_ms += start.elapsed_time(end) / reps
        ops, nbytes = kernel_counts.scatter_add(*ct.shape, n)
        total_ops += ops
        total_bytes += nbytes
    return total_ms, total_ops, total_bytes
