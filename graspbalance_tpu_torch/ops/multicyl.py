"""The grasp head's cylinder queries (4 radii x 4 depths in the default
model, up to 28 combos of at most 7 radii and 7 depths) in one pass, with the neighbours'
gripper-frame coordinates on request (port of
graspbalance_tpu/ops/pallas/multicyl_kernel.py).

``multi_cylinder_group`` launches the CUDA kernel (``csrc/multicyl.cu``) on
CUDA tensors and runs ``multi_cylinder_group_plain`` on CPU tensors. Both
return ``(idx, rel)``:

  idx: (B, R, H, M, K) int32, first-k-by-index with the reference padding;
  rel: (B, R, H, M, K, 3) float32, R^T (p_idx - c), or None unless
       ``emit_rel``. A seed with no hit gets index 0 and point 0's rotated
       coordinates.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from graspbalance_tpu_torch import _build
from graspbalance_tpu_torch.ops.query import (
    check_ascending,
    cylinder_thresholds,
    multi_cylinder_query,
    rot_planes,
)

MAX_COMBOS = 28  # radii x depths the kernel keeps counts for, a lane each


def _check(cloud, centers, rot):
    b, n, _ = cloud.shape
    m = centers.shape[1]
    if cloud.shape[-1] != 3 or centers.shape != (b, m, 3) or rot.shape != (b, m, 3, 3):
        raise ValueError(
            f"need cloud (B, N, 3), centers (B, M, 3), rot (B, M, 3, 3); got "
            f"{tuple(cloud.shape)}, {tuple(centers.shape)}, {tuple(rot.shape)}"
        )


def multi_cylinder_group_plain(
    cloud: torch.Tensor,
    centers: torch.Tensor,
    rot: torch.Tensor,
    radii: Sequence[float],
    hmin: float,
    hmaxs: Sequence[float],
    nsample: int,
    *,
    emit_rel: bool = False,
):
    """Plain PyTorch version: the chunked index query, then a gather of
    each selected point's rotated coordinates (same op order as the kernel)."""
    _check(cloud, centers, rot)
    idx = multi_cylinder_query(cloud, centers, rot, radii, hmin, hmaxs, nsample)
    if not emit_rel:
        return idx, None
    b, n_r, n_h, m, k = idx.shape
    sel = idx.permute(0, 3, 1, 2, 4).reshape(b, m, n_r * n_h * k)  # seed-major
    rel = []
    chunk = 256
    for lo in range(0, m, chunk):
        planes = rot_planes(cloud, centers[:, lo : lo + chunk], rot[:, lo : lo + chunk])
        rows = sel[:, lo : lo + chunk].to(torch.int64)
        rel.append(torch.stack([p.gather(2, rows) for p in planes], dim=-1))
    rel = torch.cat(rel, dim=1).reshape(b, m, n_r, n_h, k, 3).permute(0, 2, 3, 1, 4, 5)
    return idx, rel.contiguous()


def multi_cylinder_group(
    cloud: torch.Tensor,
    centers: torch.Tensor,
    rot: torch.Tensor,
    radii: Sequence[float],
    hmin: float,
    hmaxs: Sequence[float],
    nsample: int,
    *,
    emit_rel: bool = False,
):
    """All len(radii) x len(hmaxs) cylinder queries (+ optional rotated
    grouping). See the module docstring for the outputs."""
    _check(cloud, centers, rot)
    check_ascending(radii, hmaxs)
    if cloud.device.type == "cpu":
        return multi_cylinder_group_plain(
            cloud, centers, rot, radii, hmin, hmaxs, nsample, emit_rel=emit_rel
        )
    for name, t, nd in (("cloud", cloud, 3), ("centers", centers, 3), ("rot", rot, 4)):
        _build.require_cuda(name, t, torch.float32, nd)
    n_r, n_h = len(radii), len(hmaxs)
    if not 1 <= n_r * n_h <= MAX_COMBOS:
        raise ValueError(f"the kernel takes 1..{MAX_COMBOS} combos, got {n_r * n_h}")
    if nsample < 1:
        raise ValueError(f"nsample must be >= 1, got {nsample}")
    b, n, _ = cloud.shape
    m = centers.shape[1]
    r2, hmin32, hm = cylinder_thresholds(radii, hmin, hmaxs)
    # host arrays, copied into the launch's by-value parameters
    r2_arr = (ctypes.c_float * len(r2))(*r2)
    hm_arr = (ctypes.c_float * len(hm))(*hm)
    planes = cloud.transpose(1, 2).contiguous()  # (B, 3, N)
    idx = torch.empty((b, n_r, n_h, m, nsample), dtype=torch.int32, device=cloud.device)
    rel = (
        torch.empty((b, n_r, n_h, m, nsample, 3), dtype=torch.float32, device=cloud.device)
        if emit_rel
        else None
    )
    lib = _build.library()
    with torch.cuda.device(cloud.device):
        err = lib.gb_multicyl(
            planes.data_ptr(), centers.data_ptr(), rot.data_ptr(),
            r2_arr, hm_arr, hmin32, n_r * n_h, n_h,
            idx.data_ptr(), rel.data_ptr() if rel is not None else None,
            b, n, m, nsample, _build.stream_of(cloud),
        )
    _build.check(err, "multicyl")
    return idx, rel

