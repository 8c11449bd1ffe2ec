"""Grasp label generation and matching on the device (port of
graspbalance_tpu/labels/label_gen.py, impl ``'full'``).

Batched label inputs (the collate layout of data/synthetic.make_batch):
  object_poses    (B, O, 3, 4) float32   object -> camera pose per slot
  obj_mask        (B, O)       bool      valid object slots
  grasp_points    (B, P, 3)    float32   label points, object frame
  grasp_pt_obj    (B, P)       int       owning object slot per point
  grasp_pt_mask   (B, P)       bool      valid point slots
  grasp_labels    (B, P, V, A, D) float32  friction scores (lower = better)
  grasp_widths    (B, P, V, A, D) float32
  grasp_tolerance (B, P, V, A, D) float32

Steps (the reference semantics):
  1. transform label points and template views by each object pose;
  2. re-index views: for template view v, the object's transformed view
     nearest to v;
  3. per seed, the nearest valid label point, and its view-re-indexed
     labels;
  4. scores log-rescaled by the batch-global maximum, u = log(u_max / u)
     where label > 0 and width <= GRASP_MAX_WIDTH, else 0;
  5. per-view score = max over (A, D).

Every argmin/argmax takes the first index on ties, as the JAX package does.
The 3x3 products are written as broadcast sums, so no library matmul (and no
TF32) touches them on the card. The view permutation is an exact gather
(the JAX package's one-hot einsum exists only for the TPU's matrix unit).
"""

from __future__ import annotations

import torch

from graspbalance_tpu_torch.labels.geometry import (
    GRASP_MAX_WIDTH,
    batch_viewpoint_params_to_matrix,
    generate_grasp_views,
)
from graspbalance_tpu_torch.parallel.mesh import global_max


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distance over the last axis of size 3, summed in order."""
    d = a - b
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) -> (..., 3) as a broadcast sum."""
    return (m * v.unsqueeze(-2)).sum(dim=-1)


def process_grasp_labels(seed_xyz: torch.Tensor, labels: dict) -> dict:
    """seed_xyz (B, Ns, 3); ``labels`` the batched arrays of the module
    docstring, on seed_xyz's device. Returns the batch_grasp_* dict:
    point (B, Ns, 3), view (B, Ns, V, 3), view_rot (B, Ns, V, 3, 3),
    label (rescaled), width and tolerance (B, Ns, V, A, D), and
    view_label (B, Ns, V)."""
    b = seed_xyz.shape[0]
    dev = seed_xyz.device
    poses = labels["object_poses"]
    rot_o, trans_o = poses[..., :3], poses[..., 3]  # (B, O, 3, 3), (B, O, 3)
    pt_obj = labels["grasp_pt_obj"].long()  # (B, P)
    v = labels["grasp_labels"].shape[2]
    bb = torch.arange(b, device=dev)[:, None]

    # 1. label points and template views in the camera frame
    pts_cam = _matvec(rot_o[bb, pt_obj], labels["grasp_points"]) + trans_o[bb, pt_obj]  # (B, P, 3)
    views = generate_grasp_views(v, device=dev)  # (V, 3)
    views_cam = _matvec(rot_o.unsqueeze(2), views)  # (B, O, V, 3)
    templates = batch_viewpoint_params_to_matrix(-views, torch.zeros_like(views[:, 0]))  # (V, 3, 3)
    # rot_o @ template per (object, view): sum over j of R[i, j] T[j, k]
    views_rot_cam = (rot_o[:, :, None, :, :, None] * templates[:, None, :, :]).sum(dim=-2)  # (B, O, V, 3, 3)

    # 2. for each template view, the nearest transformed view of each object
    view_inds = _sq_dist(views[:, None, :], views_cam.unsqueeze(2)).argmin(dim=-1)  # (B, O, V)

    # 3. nearest valid label point per seed
    d2 = _sq_dist(seed_xyz.unsqueeze(2), pts_cam.unsqueeze(1))  # (B, Ns, P)
    valid = labels["grasp_pt_mask"] & labels["obj_mask"].gather(1, pt_obj)
    d2 = torch.where(valid.unsqueeze(1), d2, torch.inf)
    nn_inds = d2.argmin(dim=-1)  # (B, Ns)
    seed_obj = pt_obj.gather(1, nn_inds)  # (B, Ns)
    svi = view_inds[bb, seed_obj]  # (B, Ns, V): transformed view per template view

    bs, os_, ps = bb[:, :, None], seed_obj[:, :, None], nn_inds[:, :, None]
    out = {
        "batch_grasp_point": pts_cam[bb, nn_inds],
        "batch_grasp_view": views_cam[bs, os_, svi],
        "batch_grasp_view_rot": views_rot_cam[bs, os_, svi],
        "batch_grasp_width": labels["grasp_widths"][bs, ps, svi],
        "batch_grasp_tolerance": labels["grasp_tolerance"][bs, ps, svi],
    }
    raw = labels["grasp_labels"][bs, ps, svi]  # (B, Ns, V, A, D)

    # 4.-5. log-rescale by the batch-global maximum; per-view maxima
    u_max = global_max(raw.amax())  # over every rank's rows under data-parallel training
    mask = (raw > 0) & (out["batch_grasp_width"] <= GRASP_MAX_WIDTH)
    rescaled = torch.where(mask, torch.log(u_max / torch.clamp(raw, min=1e-12)), 0.0)
    out["batch_grasp_label"] = rescaled
    out["batch_grasp_view_label"] = rescaled.amax(dim=(-2, -1))
    return out


def match_grasp_view_and_label(top_view_inds: torch.Tensor, grasp_labels: dict) -> dict:
    """The labels at each seed's predicted top view. top_view_inds (B, Ns);
    ``grasp_labels`` from ``process_grasp_labels``. Returns the top-view
    slices and the full-view *_all tensors the loss reweighting reads."""
    b, ns = top_view_inds.shape
    dev = top_view_inds.device
    bb = torch.arange(b, device=dev)[:, None]
    ss = torch.arange(ns, device=dev)[None, :]
    top = top_view_inds.long()

    def at_top(arr):
        return arr[bb, ss, top]

    return {
        "batch_grasp_view_rot": at_top(grasp_labels["batch_grasp_view_rot"]),
        "batch_grasp_view": at_top(grasp_labels["batch_grasp_view"]),
        "batch_grasp_view_all": grasp_labels["batch_grasp_view"],
        "batch_grasp_label": at_top(grasp_labels["batch_grasp_label"]),
        "batch_grasp_label_all": grasp_labels["batch_grasp_label"],
        "batch_grasp_width": at_top(grasp_labels["batch_grasp_width"]),
        "batch_grasp_width_all": grasp_labels["batch_grasp_width"],
        "batch_grasp_tolerance": at_top(grasp_labels["batch_grasp_tolerance"]),
        "batch_grasp_point": grasp_labels["batch_grasp_point"],
        "batch_grasp_view_label": grasp_labels["batch_grasp_view_label"],
    }
