"""Exact three nearest neighbours (port of graspbalance_tpu/ops/knn.py,
``three_nn`` with ``impl='exact'``). Ties go to the lower index."""

from __future__ import annotations

import torch


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """unknown (B, N, 3), known (B, M, 3) -> dist (B, N, 3) euclidean,
    idx (B, N, 3) int32, nearest first.

    Three argmin passes over the (B, N, M) squared-distance matrix, each
    masking its winner; torch.argmin returns the first minimum, so ties
    resolve to the lower index as in the reference kernel."""
    q = unknown.unsqueeze(2)  # (B, N, 1, 3)
    r = known.unsqueeze(1)  # (B, 1, M, 3)
    dx = q[..., 0] - r[..., 0]
    dy = q[..., 1] - r[..., 1]
    dz = q[..., 2] - r[..., 2]
    cur = dx * dx + dy * dy + dz * dz  # (B, N, M)
    idxs, vals = [], []
    for _ in range(3):
        val, i = torch.min(cur, dim=-1, keepdim=True)
        idxs.append(i)
        vals.append(val)
        cur = cur.scatter(-1, i, float("inf"))
    dist = torch.sqrt(torch.clamp(torch.cat(vals, dim=-1), min=0.0))
    return dist, torch.cat(idxs, dim=-1).to(torch.int32)
