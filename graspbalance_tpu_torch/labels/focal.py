"""Focal losses (port of graspbalance_tpu/labels/focal.py). The reference
defines them but its live loss does not use them; they are here for
experiments that replace the graspable cross-entropy. Their means divide
by the count over every rank under data-parallel training
(``parallel.mesh.global_sum``, ``global_mean``), as labels/losses.py's do."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from graspbalance_tpu_torch.parallel.mesh import global_mean, global_sum


def focal_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    *,
    alpha: torch.Tensor | None = None,
    gamma: float = 2.0,
    smooth: float = 1e-4,
    valid: torch.Tensor | None = None,
    reduction: str = "mean",
):
    """Multi-class focal loss: per sample -alpha_c * (1 - p_c)^gamma *
    log(p_c + smooth) at the target class c. logits (..., C), target (...,)
    int, alpha optional (C,), valid optional (...,) weights; with ``valid``
    the mean is over sum(valid) + 1e-6."""
    prob = torch.softmax(logits, dim=-1)
    pt = prob.gather(-1, target.long().unsqueeze(-1))[..., 0] + smooth
    logpt = torch.log(pt)
    a = 1.0 if alpha is None else alpha[target.long()]
    loss = -a * torch.pow(1.0 - pt, gamma) * logpt
    if valid is not None:
        loss = loss * valid
        if reduction == "mean":
            return loss.sum() / (global_sum(valid.sum()) + 1e-6)
    if reduction == "mean":
        return global_mean(loss)
    if reduction == "sum":
        return loss.sum()
    return loss


def binary_focal_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    *,
    alpha: float = 3.0,
    gamma: float = 2.0,
    smooth: float = 1e-6,
):
    """Binary focal loss: the positive term (1 - p)^gamma * -log(p), the
    negative alpha * p^gamma * -logsigmoid(-x), their weights without
    gradient (the reference detaches them); the mean over all elements."""
    prob = torch.clamp(torch.sigmoid(logits), smooth, 1.0 - smooth)
    pos = (target == 1).to(logits.dtype)
    neg = (target == 0).to(logits.dtype)
    pos_w = (pos * torch.pow(1.0 - prob, gamma)).detach()
    neg_w = (neg * torch.pow(prob, gamma)).detach()
    pos_loss = -pos_w * torch.log(prob)
    neg_loss = -alpha * neg_w * F.logsigmoid(-logits)
    return global_mean(pos_loss + neg_loss)
