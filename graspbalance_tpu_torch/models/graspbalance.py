"""GraspBalance forward (port of graspbalance_tpu/models/graspbalance.py):
the eval forward (``match_labels=False``) and the training forward
(``train=True``), for every model the JAX package builds.

  Stage 1: the backbone (``backbone='drp'``, DRP, ``'pointnet2'``, the
           PointNet++ SSG backbone, or ``'pt'``, Point Transformer,
           models/pt_backbone.py) -> optional OBS re-seeding from a DSN
           instance clustering (eval) -> GraspableDetection (objectness,
           view scores, top view and its approach rotation).
  Labels:  (training) label matching on the device, labels/label_gen.py.
  Stage 2: cylinder width grouping at ``len(scales)`` radii and
           ``num_depth`` depths; with ``multi_scale=True`` (the default,
           four scales) a 1x1 fuse and gated fusion with the seed features,
           with ``multi_scale=False`` the single scale's features as they
           are (the reference's plain stage 2); then the grasp parameter and
           tolerance heads over ``num_angle`` angles. Centred on the seeds
           with their top-view rotations (eval), or on the matched label
           grasp points with the label view rotations (training).

The end-point keys are those of the JAX forward: input_xyz,
input_features, sa1_inds, sa{1..4}_{xyz,features}, fp2_{features,xyz,inds},
objectness_score, view_score, grasp_top_view_{inds,score,xyz,rot},
grasp_{score,angle_cls,width}_pred, grasp_tolerance_pred; with OBS also
fp2_inds_fps (the backbone's own seed indices); in training also the
batch_grasp_* labels of match_grasp_view_and_label.

Spans (``trace.py``): ``gb.backbone``, ``gb.obs_reseed`` (OBS),
``gb.graspable``, ``gb.label_match`` (training) and ``gb.heads`` (stage 2).
"""

from __future__ import annotations

import torch
from torch import nn

from graspbalance_tpu_torch import trace
from graspbalance_tpu_torch.eval.obs import object_balance_indices
from graspbalance_tpu_torch.labels.label_gen import match_grasp_view_and_label, process_grasp_labels
from graspbalance_tpu_torch.models.backbone import SSG_STAGES, Pointnet2Backbone
from graspbalance_tpu_torch.models.drp import DRP, DRP_STAGES
from graspbalance_tpu_torch.models.pt_backbone import PT_STAGES, PTBackbone
from graspbalance_tpu_torch.models.heads import (
    CYLINDER_RADIUS,
    HMAX_LIST,
    HMIN,
    NUM_ANGLE,
    SCALES,
    SEED_FEATURES,
    GraspableDetection,
    GraspParametersHead,
    MultiScaleWidthGrouping,
    ToleranceHead,
)
from graspbalance_tpu_torch.nn.layers import Dense
from graspbalance_tpu_torch.ops.gather import gather_points
from graspbalance_tpu_torch.ops.interpolate import interpolate_features


BACKBONES = {"drp": (DRP, DRP_STAGES), "pointnet2": (Pointnet2Backbone, SSG_STAGES), "pt": (PTBackbone, PT_STAGES)}


def fps_length(backbone: str, stages=None) -> int:
    """The length of the one raw-cloud FPS whose prefixes backbone
    ``backbone`` takes at ``stages`` (None: its full table)."""
    cls, default = BACKBONES[backbone]
    return cls.fps_prefix(stages or default)


class GraspBalance(nn.Module):
    """The JAX model's fields, with its defaults: ``num_view``,
    ``num_angle``, ``num_depth``, ``cylinder_radius``, ``hmin``,
    ``hmax_list`` (``num_depth`` entries), ``backbone`` (a key of
    ``BACKBONES``: 'drp' | 'pointnet2' | 'pt'), ``backbone_stages``
    (None: the backbone's full table), ``multi_scale``, ``num_seed`` and ``query_order`` ('index' |
    'nearest', every query of the model).

    The fused eval configuration, off by default: ``fused_backbone_min_nsample``
    (see ``DRP``) fuses the backbone's grouping modules, and
    ``width_impl='fused_pallas'`` runs the width head on the query's
    gripper-frame coordinates (``MultiScaleWidthGrouping``'s ``impl``). Both
    keep the same variables.

    ``dtype`` is the compute dtype of every module (float32 or bfloat16;
    parameters and BatchNorm statistics stay float32, the heads' outputs are
    float32); ``width_mlp_dtype`` overrides it for the width head's
    per-scale MLPs alone."""

    def __init__(
        self,
        *,
        num_view: int = 300,
        num_angle: int = NUM_ANGLE,
        num_depth: int = len(HMAX_LIST),
        cylinder_radius: float = CYLINDER_RADIUS,
        hmin: float = HMIN,
        hmax_list=HMAX_LIST,
        backbone: str = "drp",
        backbone_stages=None,
        multi_scale: bool = True,
        num_seed: int = 1024,
        query_order: str = "index",
        fused_backbone_min_nsample: int | None = None,
        width_impl: str = "auto",
        dtype=torch.float32,
        width_mlp_dtype=None,
    ):
        super().__init__()
        if backbone not in BACKBONES:
            raise ValueError(f"backbone must be one of {sorted(BACKBONES)}, got {backbone!r}")
        if len(hmax_list) != num_depth:
            raise ValueError(f"hmax_list needs num_depth = {num_depth} entries, got {tuple(hmax_list)}")
        bb_cls, stages = BACKBONES[backbone]
        self.multi_scale = multi_scale
        self.backbone = bb_cls(backbone_stages or stages, num_seed=num_seed, query_order=query_order,
                               fused_backbone_min_nsample=fused_backbone_min_nsample, dtype=dtype)
        self.graspable = GraspableDetection(num_view, dtype=dtype)
        self.width_grouping = MultiScaleWidthGrouping(
            cylinder_radius=cylinder_radius, hmin=hmin, hmax_list=hmax_list,
            scales=SCALES if multi_scale else (1.0,), query_order=query_order, impl=width_impl,
            dtype=width_mlp_dtype or dtype,
        )
        if multi_scale:
            self.fuse_multi_scale = Dense(self.width_grouping.out_features, 256, dtype=dtype)
            self.gate_fusion = Dense(SEED_FEATURES, 256, dtype=dtype)
        self.grasp_params = GraspParametersHead(num_angle=num_angle, num_depth=num_depth, dtype=dtype)
        self.tolerance = ToleranceHead(num_angle=num_angle, num_depth=num_depth, dtype=dtype)

    @torch.no_grad()
    def forward(
        self, point_clouds: torch.Tensor, *, sa_inds=None, seed_cluster=None, plain: bool = False
    ) -> dict:
        """point_clouds (B, N, 3) -> end points (see the module docstring).
        ``seed_cluster`` (B, N) int instance ids (0 = background) turns on
        OBS re-seeding.

        The fused width MLP kernel has no backward, so the eval forward runs
        without gradients (``forward_train`` is the training forward).
        ``plain`` runs the kernels' plain PyTorch versions instead (to compare
        against them on the card); on CPU tensors they run either way."""
        with trace.span("gb.backbone"):
            ep = self.backbone(point_clouds, sa_inds=sa_inds, plain=plain)
        seed_xyz, seed_features = ep["fp2_xyz"], ep["fp2_features"]
        if seed_cluster is not None:
            with trace.span("gb.obs_reseed"):
                # select first (OBS never reads features), then interpolate
                # the seed features at just the chosen points
                obs_inds = object_balance_indices(
                    ep["input_xyz"], seed_cluster, num_seed=self.backbone.num_seed, plain=plain
                )
                obs_xyz = gather_points(ep["input_xyz"], obs_inds)
                obs_feats = interpolate_features(obs_xyz, seed_xyz, seed_features)
            ep["fp2_inds_fps"] = ep["fp2_inds"]
            seed_xyz = ep["fp2_xyz"] = obs_xyz
            seed_features = ep["fp2_features"] = obs_feats
            ep["fp2_inds"] = obs_inds
        with trace.span("gb.graspable"):
            ep.update(self.graspable(seed_xyz, seed_features))
        return self._stage2(ep, seed_xyz, ep["grasp_top_view_rot"], plain)

    def forward_train(self, batch: dict, *, plain: bool = False) -> dict:
        """The training forward, with gradients. ``batch``: point_clouds
        (B, N, 3), optional sa_inds, and the padded label arrays of
        labels/label_gen.py, all on the model's device. BatchNorm follows
        the module's mode: the training step puts the model in train mode
        (batch statistics), the eval step in eval mode (running statistics,
        and the width head's fused MLP, which has no backward: it runs
        under ``torch.no_grad()``). ``plain`` runs the plain PyTorch versions of FPS,
        the cylinder query and (eval mode) the width MLP; the gathers'
        backward follows the device (``ops/gather.py``)."""
        with trace.span("gb.backbone"):
            ep = self.backbone(batch["point_clouds"], sa_inds=batch.get("sa_inds"), plain=plain)
        with trace.span("gb.graspable"):
            ep.update(self.graspable(ep["fp2_xyz"], ep["fp2_features"]))
        with trace.span("gb.label_match"):
            matched = match_grasp_view_and_label(
                ep["grasp_top_view_inds"], process_grasp_labels(ep["fp2_xyz"], batch)
            )
        ep.update(matched)
        return self._stage2(ep, matched["batch_grasp_point"], matched["batch_grasp_view_rot"], plain)

    def _stage2(self, ep: dict, centers, rot, plain: bool) -> dict:
        """Width grouping at ``centers`` (B, Ns, 3) with rotations ``rot``
        (B, Ns, 3, 3), gated fusion with ep's seed features, the heads: the
        span ``gb.heads``."""
        with trace.span("gb.heads"):
            seed_features = ep["fp2_features"]
            vp = self.width_grouping(centers, ep["input_xyz"], rot, plain=plain)  # (B, Ns, D, R*256)
            if self.multi_scale:
                gate = torch.sigmoid(self.gate_fusion(seed_features))
                vp_features = self.fuse_multi_scale(vp) + (gate * seed_features.to(gate.dtype)).unsqueeze(2)
            else:  # the plain single-scale stage 2
                vp_features = vp
            ep.update(self.grasp_params(vp_features))
            ep.update(self.tolerance(vp_features))
            return ep
