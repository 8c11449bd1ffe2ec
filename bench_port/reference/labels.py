"""Label expansion, label matching and the multi-task loss of the plain
reference (plain PyTorch, float32), for the training step.

Labels are the analytic rule of synthetic scenes: per (point, view, angle,
depth) the friction score (lower = better), the gripper width an object's
box needs along the closing axis, and a tolerance; matching takes each
seed's nearest label point, re-indexes the template views by the object's
pose, log-rescales the scores by the batch's largest and keeps the scores
at each seed's predicted top view. The loss: objectness cross entropy,
view MSE, and 0.2 x (score Huber + angle cross entropy + width Huber +
tolerance Huber), every stage-2 term masked by objectness and
graspability and reweighted by an inverse-log prior of the object's scale.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference import ops

GRASP_MAX_WIDTH = 0.1
GRASP_MAX_TOLERANCE = 0.05
THRESH_GOOD = 0.7
THRESH_BAD = 0.1

# the analytic rule
WIDTH_MARGIN = 0.005
ALIGN_GAIN = 2.0
ANGLE_PENALTY = 0.3
DEPTH_PENALTY = 0.1
U_MAX = 1.2
ALIGN_MIN = 0.03

# the object-scale prior: 32 bins of grasp width (0.003..0.1 m) and their counts
SCALE_BIN_COUNTS = np.array(
    [1485, 1214, 3983, 5132, 5351, 6246, 8498, 8951, 10123, 13301, 15814, 22138, 20040, 21743, 22042, 23140,
     26960, 29436, 29675, 30826, 30801, 33987, 32947, 29472, 29762, 31892, 33119, 27972, 27850, 27633, 32244,
     39441], dtype=np.float64)
SCALE_BIN_EDGES = np.array([
    0.0030035809613764286, 0.006034715610439889, 0.00906585025950335, 0.01209698490856681, 0.01512811955763027,
    0.01815925420669373, 0.021190388855757192, 0.024221523504820652, 0.027252658153884113, 0.030283792802947573,
    0.033314927452011034, 0.036346062101074494, 0.039377196750137955, 0.042408331399201415, 0.045439466048264876,
    0.04847060069732834, 0.0515017353463918, 0.05453286999545526, 0.05756400464451872, 0.06059513929358218,
    0.06362627394264564, 0.0666574085917091, 0.06968854324077256, 0.07271967788983602, 0.07575081253889948,
    0.07878194718796294, 0.0818130818370264, 0.08484421648608986, 0.08787535113515332, 0.09090648578421678,
    0.09393762043328024, 0.0969687550823437, 0.09999988973140717,
], dtype=np.float64)


# --------------------------------------------------------------- expansion
def _frame_axes(towards):
    ax = towards
    ay = np.stack([-ax[..., 1], ax[..., 0], np.zeros_like(ax[..., 0])], axis=-1)
    norm_ay = np.sqrt(np.sum(ay * ay, axis=-1, keepdims=True))
    fallback = np.broadcast_to(np.asarray([0.0, 1.0, 0.0], dtype=ax.dtype), ay.shape)
    ay = np.where(norm_ay == 0, fallback, ay / np.maximum(norm_ay, 1e-12))
    ax = ax / np.sqrt(np.sum(ax * ax, axis=-1, keepdims=True))
    return ax, ay, np.cross(ax, ay)


def view_grids(num_views, num_angles, num_depths):
    """float32 numpy: align (V,), closing axes (V, A, 3), friction (V, A, D)."""
    towards = -ops.grasp_views(num_views).numpy()
    align = np.clip(towards[:, 2], 0.0, 1.0)
    _, ay, az = _frame_axes(towards)
    angles = np.arange(num_angles, dtype=np.float32) / num_angles * np.pi
    closing = np.cos(angles)[None, :, None] * ay[:, None, :] + np.sin(angles)[None, :, None] * az[:, None, :]
    depth_frac = np.arange(num_depths, dtype=np.float32) / max(num_depths - 1, 1)
    u = np.clip(U_MAX * np.exp(-ALIGN_GAIN * align[:, None, None] + ANGLE_PENALTY * np.sin(angles)[None, :, None] ** 2
                               + DEPTH_PENALTY * depth_frac[None, None, :]), 1e-4, U_MAX)
    return align, closing, u


def expand_labels(batch, num_views, num_angles, num_depths):
    """``batch`` plus its (B, P, V, A, D) label, width and tolerance tensors."""
    sizes = batch["obj_sizes"]
    dev = sizes.device
    align, closing, u = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                         for a in view_grids(num_views, num_angles, num_depths))
    c = closing.abs()
    s = sizes.gather(1, batch["grasp_pt_obj"].long()[..., None].expand(-1, -1, 3))[:, :, None, None, :]
    req = c[..., 0] * s[..., 0]
    req = req + c[..., 1] * s[..., 1]
    req = req + c[..., 2] * s[..., 2]
    req = req + WIDTH_MARGIN
    graspable = (align[:, None] > ALIGN_MIN) & (req <= GRASP_MAX_WIDTH) & batch["grasp_pt_mask"][:, :, None, None]
    labels = torch.where(graspable[..., None], u, 0.0)
    out = dict(batch)
    out["grasp_labels"] = labels
    out["grasp_widths"] = req[..., None].expand(labels.shape)
    out["grasp_tolerance"] = (GRASP_MAX_TOLERANCE * align)[:, None, None].expand(labels.shape)
    return out


# ----------------------------------------------------------------- matching
def _sq_dist(a, b):
    d = a - b
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _matvec(m, v):
    return (m * v.unsqueeze(-2)).sum(dim=-1)


def match_labels(seed_xyz, top_view_inds, labels):
    """The labels of each seed's nearest valid label point, views re-indexed
    by its object's pose, scores log-rescaled by the batch's largest, taken
    at the seed's top view (and kept for every view where the loss needs
    them)."""
    b = seed_xyz.shape[0]
    dev = seed_xyz.device
    poses = labels["object_poses"]
    rot_o, trans_o = poses[..., :3], poses[..., 3]
    pt_obj = labels["grasp_pt_obj"].long()
    v = labels["grasp_labels"].shape[2]
    bb = torch.arange(b, device=dev)[:, None]
    pts_cam = _matvec(rot_o[bb, pt_obj], labels["grasp_points"]) + trans_o[bb, pt_obj]
    views = ops.grasp_views(v, device=dev)
    views_cam = _matvec(rot_o.unsqueeze(2), views)
    templates = ops.viewpoint_to_matrix(-views, torch.zeros_like(views[:, 0]))
    views_rot_cam = (rot_o[:, :, None, :, :, None] * templates[:, None, :, :]).sum(dim=-2)
    view_inds = _sq_dist(views[:, None, :], views_cam.unsqueeze(2)).argmin(dim=-1)
    d2 = _sq_dist(seed_xyz.unsqueeze(2), pts_cam.unsqueeze(1))
    valid = labels["grasp_pt_mask"] & labels["obj_mask"].gather(1, pt_obj)
    nn_inds = torch.where(valid.unsqueeze(1), d2, torch.inf).argmin(dim=-1)
    seed_obj = pt_obj.gather(1, nn_inds)
    svi = view_inds[bb, seed_obj]
    bs, os_, ps = bb[:, :, None], seed_obj[:, :, None], nn_inds[:, :, None]
    view_rot = views_rot_cam[bs, os_, svi]
    width = labels["grasp_widths"][bs, ps, svi]
    tol = labels["grasp_tolerance"][bs, ps, svi]
    raw = labels["grasp_labels"][bs, ps, svi]
    mask = (raw > 0) & (width <= GRASP_MAX_WIDTH)
    label = torch.where(mask, torch.log(raw.amax() / torch.clamp(raw, min=1e-12)), 0.0)
    ss = torch.arange(seed_xyz.shape[1], device=dev)[None, :]
    top = top_view_inds.long()
    return {
        "batch_grasp_point": pts_cam[bb, nn_inds],
        "batch_grasp_view_rot": view_rot[bb, ss, top],
        "batch_grasp_label": label[bb, ss, top],
        "batch_grasp_label_all": label,
        "batch_grasp_width": width[bb, ss, top],
        "batch_grasp_width_all": width,
        "batch_grasp_tolerance": tol[bb, ss, top],
        "batch_grasp_view_label": label.amax(dim=(-2, -1)),
    }


# --------------------------------------------------------------------- loss
def _huber(error, delta=1.0):
    abs_err = error.abs()
    quad = torch.clamp(abs_err, max=delta)
    return 0.5 * quad * quad + delta * (abs_err - quad)


def _ce(logits, labels, dim=-1):
    return -F.log_softmax(logits, dim=dim).gather(dim, labels.long().unsqueeze(dim)).squeeze(dim)


def _masked_mean(values, mask, eps=1e-6):
    m = mask.float()
    return (values * m).sum() / (m.sum() + eps)


def _scale_weights(label_all, width_all):
    """Per-seed prior weight -log(n_bin / n_max) + 1 of the width at the
    seed's best label (first on ties); out of range: bin 0."""
    b, ns = label_all.shape[:2]
    inds = label_all.reshape(b, ns, -1).argmax(dim=2, keepdim=True)
    w = width_all.reshape(b, ns, -1).gather(2, inds)
    edges = torch.from_numpy(SCALE_BIN_EDGES.astype(np.float32)).to(w.device)
    in_bin = (edges[:-1] < w) & (edges[1:] > w)
    bin_id = (in_bin.long() * torch.arange(in_bin.shape[-1], device=w.device)).sum(dim=-1)
    prior = (-np.log(SCALE_BIN_COUNTS / SCALE_BIN_COUNTS.max()) + 1.0).astype(np.float32)
    return torch.from_numpy(prior).to(w.device)[bin_id]


def get_loss(ep):
    """(loss, metrics) of the end points and matched labels ``ep``."""
    seed_obj = ep["objectness_label"].long().gather(1, ep["fp2_inds"].long())
    weight = _scale_weights(ep["batch_grasp_label_all"], ep["batch_grasp_width_all"])
    per_view = ep["batch_grasp_view_label"]

    obj_score = ep["objectness_score"]
    graspable = ((per_view > THRESH_BAD).sum(dim=-1) > 10).long() * seed_obj
    obj_loss = _ce(obj_score, graspable).mean()
    pred = obj_score.argmax(dim=-1)
    correct = (pred == graspable).float()
    metrics = {"loss/stage1_graspable_loss": obj_loss, "stage1_graspable_acc": correct.mean(),
               "stage1_graspable_prec": _masked_mean(correct, pred == 1),
               "stage1_graspable_recall": _masked_mean(correct, graspable == 1)}

    view_score = ep["view_score"]
    objectness_mask = (graspable > 0).unsqueeze(-1)
    loss_mask = objectness_mask.float() * weight.unsqueeze(-1)
    view_loss = (((view_score - per_view) ** 2) * loss_mask).sum() / (loss_mask.sum() * view_score.shape[-1] + 1e-6)
    metrics["loss/stage1_view_loss"] = view_loss
    metrics["stage1_pos_view_pred_count"] = ((view_score >= THRESH_GOOD) & objectness_mask).sum()

    label = ep["batch_grasp_label"]
    a = label.shape[2]
    target = label.argmax(dim=2, keepdim=True)

    def at_target(x):
        return x.gather(2, target).squeeze(2)

    t_label = at_target(label)
    t_width = at_target(ep["batch_grasp_width"])
    t_tol = at_target(ep["batch_grasp_tolerance"])
    t_cls = target.squeeze(2)
    mask = ((seed_obj > 0).unsqueeze(-1) & (t_label > THRESH_BAD)).float() * weight.unsqueeze(-1)
    depth_mask = mask.amax(dim=2, keepdim=True).expand_as(mask)
    denom = mask.sum() + 1e-6
    score_loss = (_huber(at_target(ep["grasp_score_pred"]) - t_label) * depth_mask).sum() / (depth_mask.sum() + 1e-6)
    angle_logits = ep["grasp_angle_cls_pred"]
    angle_loss = (_ce(angle_logits, t_cls, dim=2) * mask).sum() / denom
    angle_pred = angle_logits.argmax(dim=2)
    diff = (angle_pred - t_cls).abs()
    lm = mask > 0
    width_loss = (_huber((at_target(ep["grasp_width_pred"]) - t_width) / GRASP_MAX_WIDTH) * mask).sum() / denom
    tol_loss = (_huber((at_target(ep["grasp_tolerance_pred"]) - t_tol) / GRASP_MAX_TOLERANCE) * mask).sum() / denom
    metrics.update({
        "loss/stage2_grasp_score_loss": score_loss,
        "loss/stage2_grasp_angle_class_loss": angle_loss,
        "loss/stage2_grasp_width_loss": width_loss,
        "loss/stage2_grasp_tolerance_loss": tol_loss,
        "stage2_grasp_angle_class_acc/0_degree": _masked_mean((angle_pred == t_cls).float(), lm),
        "stage2_grasp_angle_class_acc/15_degree": _masked_mean(((diff <= 1) | (diff >= a - 1)).float(), lm),
        "stage2_grasp_angle_class_acc/30_degree": _masked_mean(((diff <= 2) | (diff >= a - 2)).float(), lm),
    })
    loss = obj_loss + view_loss + 0.2 * (score_loss + angle_loss + width_loss + tol_loss)
    metrics["loss/overall_loss"] = loss
    return loss, metrics
