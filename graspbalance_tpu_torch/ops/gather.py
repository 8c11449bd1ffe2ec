"""Gather/group ops, channels-last (port of graspbalance_tpu/ops/gather.py).

Precondition for both: every index lies in [0, N). The query and sampling
ops of this package never emit anything else (no -1 sentinels).
"""

from __future__ import annotations

import torch


def _flat_take(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batch gather through global row indices into a (B*N, C) view."""
    b, n, c = points.shape
    offs = (torch.arange(b, device=idx.device, dtype=torch.int64) * n).reshape(
        (b,) + (1,) * (idx.ndim - 1)
    )
    rows = (idx.to(torch.int64) + offs).reshape(-1)
    return points.reshape(b * n, c).index_select(0, rows).reshape(idx.shape + (c,))


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M) int -> (B, M, C)."""
    return _flat_take(points, idx)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M, K) int -> (B, M, K, C)."""
    return _flat_take(points, idx)
