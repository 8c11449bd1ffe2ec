"""Instance-segmentation losses of the DSN (port of
graspbalance_tpu/labels/seg_losses.py).

Weighted losses where each point's weight is the inverse of its label's
population in its batch item, so that small objects count as much as large
ones. The counts are a per-item bincount of ``num_classes`` bins: a label
at or past ``num_classes`` adds to no bin and reads the last one, as the
JAX package's ``jnp.bincount(length=num_classes)`` and clamped gather do.

The counts are per batch item, so they stay on the item's rank under
data-parallel training; the weighted means' denominators sum over the ranks
(``parallel.mesh.global_sum``), as labels/losses.py's do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from graspbalance_tpu_torch.parallel.mesh import global_sum


def inverse_frequency_weights(labels: torch.Tensor, num_classes: int, *, ignore_zero: bool = False) -> torch.Tensor:
    """(B, N) int -> (B, N) float32: w = 1 / count(label) per batch item;
    with ``ignore_zero`` label 0 weighs 0."""
    lab = labels.long()
    slot = lab.clamp(max=num_classes - 1)
    counts = torch.zeros(lab.shape[0], num_classes, dtype=torch.int64, device=lab.device)
    counts.scatter_add_(1, slot, (lab < num_classes).long())
    w = 1.0 / counts.gather(1, slot).clamp(min=1).float()
    if ignore_zero:
        w = torch.where(lab == 0, 0.0, w)
    return w


def ce_loss_weighted(logits: torch.Tensor, target: torch.Tensor, num_classes: int = 2) -> torch.Tensor:
    """Cross entropy weighted by the inverse class frequency of the target
    labels. logits (B, N, C), target (B, N) int."""
    logp = F.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, target.long().unsqueeze(-1))[..., 0]
    w = inverse_frequency_weights(target, num_classes)
    return torch.sum(ce * w) / global_sum(torch.sum(w))


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def smooth_l1_loss_weighted(
    pred: torch.Tensor, target: torch.Tensor, mask_labels: torch.Tensor, num_classes: int
) -> torch.Tensor:
    """Per-point smooth L1 summed over the 3 offset channels, weighted by the
    inverse instance-label frequency. pred/target (B, N, 3); mask_labels
    (B, N) int instance ids."""
    per_point = torch.sum(smooth_l1(pred - target), dim=-1)
    w = inverse_frequency_weights(mask_labels, num_classes)
    return torch.sum(per_point * w) / global_sum(torch.sum(w))


def bce_with_logits_weighted(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy on logits for {0, 1} targets, weighted by the
    inverse frequency of each target value."""
    bce = torch.clamp(logits, min=0) - logits * target + torch.log1p(torch.exp(-torch.abs(logits)))
    w = inverse_frequency_weights(target.int(), 2)
    return torch.sum(bce * w) / global_sum(torch.sum(w))


def cluster_loss_weighted(
    x1: torch.Tensor, y1: torch.Tensor, x2: torch.Tensor, y2: torch.Tensor, delta: float, num_classes: int
) -> torch.Tensor:
    """Pull same-label pairs together (squared distance), push
    different-label pairs past ``delta`` (squared hinge), weighted by the
    outer product of the inverse label frequencies. x (N, D), y (N,) int."""
    w1 = inverse_frequency_weights(y1[None], num_classes)[0]
    w2 = inverse_frequency_weights(y2[None], num_classes)[0]
    wmat = w1[:, None] * w2[None, :]
    same = (y1[:, None] == y2[None, :]).float()
    dist = torch.linalg.vector_norm(x1[:, None, :] - x2[None, :, :], dim=-1)
    pos = same * dist**2
    neg = (1.0 - same) * torch.clamp(delta - dist, min=0.0) ** 2
    return torch.sum(wmat * (pos + neg))


def get_seg_loss(end_points: dict, num_classes: int) -> tuple[torch.Tensor, dict]:
    """The DSN loss: 0.5 * weighted foreground CE + 0.5 * weighted smooth L1
    on the 3-D center offsets. Reads foreground_logits (B, N, 2),
    center_offsets (B, N, 3), foreground_label (B, N), instance_label
    (B, N) and center_offset_label (B, N, 3)."""
    fg_loss = ce_loss_weighted(end_points["foreground_logits"], end_points["foreground_label"], 2)
    center_loss = smooth_l1_loss_weighted(
        end_points["center_offsets"], end_points["center_offset_label"], end_points["instance_label"], num_classes
    )
    loss = 0.5 * fg_loss + 0.5 * center_loss
    return loss, {"loss/fg_loss": fg_loss, "loss/center_loss": center_loss, "loss/seg_loss": loss}
