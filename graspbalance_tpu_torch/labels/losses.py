"""Multi-task loss with object-scale reweighting (port of
graspbalance_tpu/labels/losses.py).

total = graspable CE + view MSE + 0.2 * (score huber + angle CE + width huber
+ tolerance huber); every stage-2 term is masked by objectness and
graspability and reweighted by the inverse-log object-scale prior. Masked
means are nan-free (0 on an empty mask), as in the JAX package. The metric
keys are the JAX package's.

Under ``parallel.mesh.data_parallel`` (data-parallel training) every
denominator, masked or a plain mean's element count, is the sum over the
ranks (``global_sum``, ``global_mean``): each rank's loss and metrics are
then its share of the global-batch value, and the shares add up to it.
Outside it both are the one-process denominators.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from graspbalance_tpu_torch import trace
from graspbalance_tpu_torch.labels.geometry import (
    GRASP_MAX_TOLERANCE,
    GRASP_MAX_WIDTH,
    THRESH_BAD,
    THRESH_GOOD,
)
from graspbalance_tpu_torch.labels.scale_prior import SCALE_BIN_EDGES, scale_prior_weights
from graspbalance_tpu_torch.parallel.mesh import global_mean, global_sum


def huber_loss(error: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    abs_err = error.abs()
    quad = torch.clamp(abs_err, max=delta)
    return 0.5 * quad * quad + delta * (abs_err - quad)


def _softmax_ce(logits: torch.Tensor, labels: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Integer-label cross entropy along ``dim``, no reduction."""
    logp = F.log_softmax(logits, dim=dim)
    return -logp.gather(dim, labels.long().unsqueeze(dim)).squeeze(dim)


def _masked_mean(values: torch.Tensor, mask: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    m = mask.float()
    return (values * m).sum() / (global_sum(m.sum()) + eps)


def reweight_from_target_width(target_w: torch.Tensor) -> torch.Tensor:
    """Scale-prior weight (B, Ns) of the per-seed target width (B, Ns): its
    bin among the 32 scale intervals, strict inequalities, out of range ->
    bin 0. The uploads of the edges and the weights wait for the card
    (``trace.host_read`` site "scale_bins")."""
    dev = target_w.device
    edges = trace.host_read("scale_bins", lambda: torch.from_numpy(SCALE_BIN_EDGES.astype("float32")).to(dev))
    w = target_w.unsqueeze(-1)
    in_bin = (edges[:-1] < w) & (edges[1:] > w)  # (B, Ns, 32)
    bin_id = (in_bin.long() * torch.arange(in_bin.shape[-1], device=dev)).sum(dim=-1)
    return trace.host_read("scale_bins", lambda: torch.from_numpy(scale_prior_weights()).to(dev))[bin_id]


def generate_reweight_mask(label_all: torch.Tensor, width_all: torch.Tensor) -> torch.Tensor:
    """Per-seed scale-prior weight (B, Ns): the width at each seed's best
    label over (V, A, D) (first index on ties), binned."""
    b, ns = label_all.shape[:2]
    inds = label_all.reshape(b, ns, -1).argmax(dim=2, keepdim=True)
    target_w = width_all.reshape(b, ns, -1).gather(2, inds).squeeze(2)
    return reweight_from_target_width(target_w)


def compute_robust_graspable_loss(objectness_score, per_view, seed_objectness):
    """CE objectness loss and acc/prec/recall: a seed is graspable iff it
    lies on an object and more than 10 views have a label above THRESH_BAD."""
    graspable = ((per_view > THRESH_BAD).sum(dim=-1) > 10).long() * seed_objectness
    loss = global_mean(_softmax_ce(objectness_score, graspable))
    pred = objectness_score.argmax(dim=-1)
    correct = (pred == graspable).float()
    metrics = {
        "loss/stage1_graspable_loss": loss,
        "stage1_graspable_acc": global_mean(correct),
        "stage1_graspable_prec": _masked_mean(correct, pred == 1),
        "stage1_graspable_recall": _masked_mean(correct, graspable == 1),
    }
    return loss, graspable, metrics


def compute_weighted_view_loss(view_score, view_label, graspable, weight_mask):
    """Masked, reweighted MSE over the view scores; the mask is repeated
    over the V views, so the denominator carries a factor V."""
    objectness_mask = (graspable > 0).unsqueeze(-1)
    loss_mask = objectness_mask.float() * weight_mask.unsqueeze(-1)
    sq = (view_score - view_label) ** 2
    v = view_score.shape[-1]
    loss = (sq * loss_mask).sum() / (global_sum(loss_mask.sum()) * v + 1e-6)
    pos_count = ((view_score >= THRESH_GOOD) & objectness_mask).sum()
    return loss, {"loss/stage1_view_loss": loss, "stage1_pos_view_pred_count": pos_count}


def compute_weighted_grasp_loss(ep: dict, seed_objectness, weight_mask):
    """Stage-2 losses at the predicted top view; predictions and top-view
    labels (B, Ns, A, D) from ``ep``."""
    label = ep["batch_grasp_label"]
    a = label.shape[2]
    target_inds = label.argmax(dim=2, keepdim=True)  # (B, Ns, 1, D)

    def at_target(x):
        return x.gather(2, target_inds).squeeze(2)

    target_labels = at_target(label)
    target_widths = at_target(ep["batch_grasp_width"])
    target_tol = at_target(ep["batch_grasp_tolerance"])
    target_cls = target_inds.squeeze(2)  # (B, Ns, D)

    obj_mask = (seed_objectness > 0).unsqueeze(-1)
    loss_mask = (obj_mask & (target_labels > THRESH_BAD)).float() * weight_mask.unsqueeze(-1)
    depth_loss_mask = loss_mask.amax(dim=2, keepdim=True).expand_as(loss_mask)
    denom = global_sum(loss_mask.sum()) + 1e-6

    score_el = huber_loss(at_target(ep["grasp_score_pred"]) - target_labels)
    score_loss = (score_el * depth_loss_mask).sum() / (global_sum(depth_loss_mask.sum()) + 1e-6)

    angle_logits = ep["grasp_angle_cls_pred"]
    angle_loss = (_softmax_ce(angle_logits, target_cls, dim=2) * loss_mask).sum() / denom
    angle_pred = angle_logits.argmax(dim=2)
    diff = (angle_pred - target_cls).abs()
    lm = loss_mask > 0

    width_el = huber_loss((at_target(ep["grasp_width_pred"]) - target_widths) / GRASP_MAX_WIDTH)
    width_loss = (width_el * loss_mask).sum() / denom
    tol_el = huber_loss((at_target(ep["grasp_tolerance_pred"]) - target_tol) / GRASP_MAX_TOLERANCE)
    tol_loss = (tol_el * loss_mask).sum() / denom

    metrics = {
        "loss/stage2_grasp_score_loss": score_loss,
        "loss/stage2_grasp_angle_class_loss": angle_loss,
        "loss/stage2_grasp_width_loss": width_loss,
        "loss/stage2_grasp_tolerance_loss": tol_loss,
        "stage2_grasp_angle_class_acc/0_degree": _masked_mean((angle_pred == target_cls).float(), lm),
        "stage2_grasp_angle_class_acc/15_degree": _masked_mean(((diff <= 1) | (diff >= a - 1)).float(), lm),
        "stage2_grasp_angle_class_acc/30_degree": _masked_mean(((diff <= 2) | (diff >= a - 2)).float(), lm),
    }
    return score_loss + angle_loss + width_loss + tol_loss, metrics


def get_loss(ep: dict) -> tuple[torch.Tensor, dict]:
    """Total multi-task loss and its metrics. Reads from ``ep``:
    objectness_score, view_score, grasp_*_pred, the batch_grasp_* labels
    (with the *_all tensors), objectness_label (B, N), fp2_inds (B, Ns)."""
    seed_objectness = ep["objectness_label"].long().gather(1, ep["fp2_inds"].long())
    weight_mask = generate_reweight_mask(ep["batch_grasp_label_all"], ep["batch_grasp_width_all"])
    per_view = ep["batch_grasp_view_label"]
    objectness_loss, graspable, m1 = compute_robust_graspable_loss(
        ep["objectness_score"], per_view, seed_objectness
    )
    view_loss, m2 = compute_weighted_view_loss(ep["view_score"], per_view, graspable, weight_mask)
    grasp_loss, m3 = compute_weighted_grasp_loss(ep, seed_objectness, weight_mask)
    loss = objectness_loss + view_loss + 0.2 * grasp_loss
    return loss, {"loss/overall_loss": loss, **m1, **m2, **m3}
