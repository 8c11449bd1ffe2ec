"""K5's probe: the width head's kernel entry (``models/heads.py``'s
``width_mlp_fused_rot``, ``ops/widthmlp.py``). ``measure`` captures its
inputs from one call of the cell's own path, times them with CUDA events
over repeated launches and counts their operations and bytes
(``counts/kernels.py:widthmlp``)."""

from __future__ import annotations

import torch

from bench_port.counts import kernels as kernel_counts


def measure(drive, reps: int = 20):
    """(device ms per launch, operations, bytes) of the entry on the inputs
    that ``drive()`` hands it first, or None where it is not called."""
    from graspbalance_tpu_torch.models import heads

    entry, seen = heads.width_mlp_fused_rot, []

    def keep_args(*args):
        seen.append(args)
        return entry(*args)

    heads.width_mlp_fused_rot = keep_args
    try:
        drive()
    finally:
        heads.width_mlp_fused_rot = entry
    if not seen:
        return None
    args = seen[0]
    entry(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        entry(*args)
    end.record()
    torch.cuda.synchronize()
    b, s, r, h, k, _ = args[0].shape
    widths = tuple(w[0].shape[1] for w in args[3][0])
    ops, nbytes = kernel_counts.widthmlp(b, s, r, h, k, widths)
    return start.elapsed_time(end) / reps, ops, nbytes
