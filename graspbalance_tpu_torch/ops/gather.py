"""Gather/group ops, channels-last (port of graspbalance_tpu/ops/gather.py).

Precondition for both: every index lies in [0, N). The query and sampling
ops of this package never emit anything else (no -1 sentinels).

The gradient with respect to ``points`` is ``ops/scatter.scatter_add``:
on a CUDA tensor its kernel (``csrc/scatter.cu``, deterministic), on a CPU
tensor its plain version. Both sum in float32: a bfloat16 cotangent is cast
to float32 and the sums back to the points' dtype, as the JAX package's
kernel path does (graspbalance_tpu/ops/gather.py:_flat_take_pallas_bwd).
Indices get no gradient.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from graspbalance_tpu_torch.ops.scatter import scatter_add


def _flat_take(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batch gather through global row indices into a (B*N, C) view."""
    b, n, c = points.shape
    offs = (torch.arange(b, device=idx.device, dtype=torch.int64) * n).reshape(
        (b,) + (1,) * (idx.ndim - 1)
    )
    rows = (idx.to(torch.int64) + offs).reshape(-1)
    return points.reshape(b * n, c).index_select(0, rows).reshape(idx.shape + (c,))


class _Take(torch.autograd.Function):
    """``_flat_take`` with the scatter-add as its backward."""

    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        ctx.dtype = points.dtype
        return _flat_take(points, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        b, c = idx.shape[0], grad.shape[-1]
        ct = grad.reshape(b, -1, c).float().contiguous()
        rows = idx.reshape(b, -1).to(torch.int32).contiguous()
        return scatter_add(ct, rows, ctx.n).to(ctx.dtype), None


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M) int -> (B, M, C)."""
    return _Take.apply(points, idx)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M, K) int -> (B, M, K, C)."""
    return _Take.apply(points, idx)
