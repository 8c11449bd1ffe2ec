"""DSN: the instance segmentation head that feeds object-balanced sampling
(port of graspbalance_tpu/models/dsn.py).

Point-transformer backbone -> foreground logits + 3-D center offsets at the
seed level -> inverse-distance upsampling to the full cloud. ``cluster``
runs mean shift over the predicted centers; ``compute_center_offset_labels``
gives the offsets' training targets (the seg losses are in
labels/seg_losses.py, the training step in train/seg_step.py).
"""

from __future__ import annotations

import torch
from torch import nn

from graspbalance_tpu_torch.eval.meanshift import gumbel_noise, mean_shift_cluster, subsampled_count
from graspbalance_tpu_torch.models.point_transformer import PT_STAGES, PointTransformerSeg
from graspbalance_tpu_torch.nn.layers import Dense, MLPBlock
from graspbalance_tpu_torch.ops.interpolate import interpolate_features


class DSN(nn.Module):
    """``dtype``: the compute dtype of the backbone and the heads (float32,
    or bfloat16 with the JAX package's casts: float32 parameters, the
    backbone's output, the heads' outputs and their interpolation in
    float32)."""

    def __init__(self, pt_stages=PT_STAGES, *, dtype=torch.float32):
        super().__init__()
        self.pt_stages = tuple(pt_stages)
        self.dtype = dtype
        self.backbone = PointTransformerSeg(self.pt_stages, dtype=dtype)
        self.fg1 = MLPBlock(256, 256, dtype=dtype)
        self.fg2 = Dense(256, 2, dtype=dtype)
        self.off1 = MLPBlock(256, 256, dtype=dtype)
        self.off2 = Dense(256, 3, dtype=dtype)

    @torch.no_grad()
    def forward(self, pointcloud: torch.Tensor, *, sa_inds=None, plain: bool = False) -> dict:
        """pointcloud (B, N, 3) -> dict with seed_xyz, foreground_logits
        (B, N, 2) and center_offsets (B, N, 3), upsampled to the full cloud,
        without gradients (the serving call). ``plain`` runs the kernels'
        plain versions."""
        return self.forward_train(pointcloud, sa_inds=sa_inds, plain=plain)

    def forward_train(self, pointcloud: torch.Tensor, *, sa_inds=None, plain: bool = False) -> dict:
        """``forward`` with gradients. BatchNorm follows the module's mode:
        in train mode (the training step's) it normalises with the batch
        statistics and updates the running ones at its ``momentum`` (the
        DSN's constant 0.1); on the card the gathers' backward is the
        scatter-add kernel (``ops/gather.py``)."""
        bb = self.backbone(pointcloud, sa_inds=sa_inds, plain=plain)
        feats = bb["seed_features"]
        fg = self.fg2(self.fg1(feats))
        off = self.off2(self.off1(feats))
        # one shared three_nn + gather for both heads
        both = interpolate_features(pointcloud[..., :3], bb["seed_xyz"], torch.cat([fg.float(), off.float()], dim=-1))
        return {
            "seed_xyz": bb["seed_xyz"],
            "foreground_logits": both[..., :2],
            "center_offsets": both[..., 2:],
        }


def cluster(
    xyz: torch.Tensor,
    offsets: torch.Tensor,
    fg_mask: torch.Tensor,
    *,
    gumbel: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    num_seeds: int = 50,
    subsample_factor: int = 5,
    **kw,
):
    """Mean shift over the predicted centers (xyz + offsets), restricted to
    the foreground: (labels (B, N) int32 with 0 background, centers,
    center_valid). The seed draws' Gumbel noise is ``gumbel``
    (B, 1 + num_seeds, m), or is drawn from ``generator``."""
    if gumbel is None:
        if generator is None:
            raise ValueError("cluster needs gumbel noise or a torch.Generator to draw it")
        m = subsampled_count(xyz.shape[1], subsample_factor)
        gumbel = gumbel_noise((xyz.shape[0], 1 + num_seeds, m), generator, xyz.device)
    return mean_shift_cluster(
        xyz + offsets, fg_mask, gumbel, num_seeds=num_seeds, subsample_factor=subsample_factor, **kw
    )


def compute_center_offset_labels(xyz: torch.Tensor, instance_label: torch.Tensor, max_objects: int) -> torch.Tensor:
    """The offsets' targets: from each point to its instance's centroid,
    zero on the background (label 0). xyz (B, N, 3), instance_label (B, N)
    int in [0, max_objects] -> (B, N, 3). As in the JAX package, a label
    past max_objects joins no centroid and reads the last one (its one-hot
    row is zero, its gather clamped)."""
    lab = instance_label.long()
    slots = torch.arange(max_objects + 1, device=lab.device)
    onehot = (lab.unsqueeze(-1) == slots).to(xyz.dtype)  # (B, N, O+1)
    sums = torch.einsum("bno,bnc->boc", onehot, xyz)
    centroids = sums / torch.clamp(onehot.sum(dim=1), min=1.0).unsqueeze(-1)
    target = centroids.gather(1, lab.clamp(max=max_objects).unsqueeze(-1).expand(-1, -1, 3))
    return torch.where((lab > 0).unsqueeze(-1), target - xyz, 0.0)
