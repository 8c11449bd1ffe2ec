"""Grasp pose NMS (port of graspbalance_tpu/eval/nms.py).

Greedy suppression in score order: two grasps conflict iff their centers
are closer than ``translation_thresh`` and the angle between their rotations
is below ``rotation_thresh``. Plain PyTorch: the JAX package has no kernel
for it.
"""

from __future__ import annotations

import math

import torch

from graspbalance_tpu_torch import trace


def grasp_nms(
    grasps: torch.Tensor,
    valid: torch.Tensor | None = None,
    *,
    translation_thresh: float = 0.03,
    rotation_thresh: float = 30.0 / 180.0 * math.pi,
) -> torch.Tensor:
    """grasps ([B,] G, 17) decoded rows; valid optional ([B,] G) bool.

    Returns the keep mask ([B,] G) bool: valid and not suppressed. The greedy
    recurrence ``keep[i] = valid[i] & ~any_{j<i}(C[j, i] & keep[j])`` (in
    score order, stable, invalid rows last) is Jacobi-iterated to its
    fixpoint, which is exactly the greedy result; each sweep reads one bool
    on the host to test for the fixpoint (``trace.host_read`` site "nms").
    The sweeps go to the counter ``nms.sweeps``."""
    single = grasps.ndim == 2
    if single:
        grasps = grasps.unsqueeze(0)
        valid = None if valid is None else valid.unsqueeze(0)
    b, g, _ = grasps.shape
    if valid is None:
        valid = torch.ones((b, g), dtype=torch.bool, device=grasps.device)
    scores = torch.where(valid, grasps[..., 0], -math.inf)
    trans = grasps[..., 13:16]
    rot = grasps[..., 4:13]  # row-major 3x3: trace(R_i^T R_j) = <rot9_i, rot9_j>

    delta = trans.unsqueeze(2) - trans.unsqueeze(1)  # (B, G, G, 3)
    d2 = (delta * delta).sum(dim=-1)
    tr = rot @ rot.transpose(1, 2)
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    conflict = (d2 < translation_thresh**2) & (torch.arccos(cos) < rotation_thresh)
    conflict &= valid.unsqueeze(2) & valid.unsqueeze(1)

    order = torch.sort(-scores, dim=1, stable=True).indices  # best first
    conflict_o = conflict.gather(1, order.unsqueeze(2).expand(b, g, g))
    conflict_o = conflict_o.gather(2, order.unsqueeze(1).expand(b, g, g))
    valid_o = valid.gather(1, order)
    ii = torch.arange(g, device=grasps.device)
    lower = conflict_o & (ii.unsqueeze(1) < ii.unsqueeze(0))  # C[j, i] for j < i

    def step(k):
        return valid_o & ~(lower & k.unsqueeze(2)).any(dim=1)

    prev, k, sweeps = valid_o, step(valid_o), 1
    while sweeps < g and trace.host_read("nms", lambda: bool((k != prev).any())):
        prev, k, sweeps = k, step(k), sweeps + 1
    trace.count("nms.sweeps", sweeps)
    keep = torch.zeros_like(valid_o).scatter_(1, order, k)
    return keep[0] if single else keep
