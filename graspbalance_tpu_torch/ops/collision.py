"""Box-occupancy counts of the collision filter (port of
graspbalance_tpu/ops/pallas/collision_kernel.py).

For every grasp and every valid scene point: the point's gripper-frame
coordinates, the eight box tests of graspbalance_tpu/eval/collision.py and
six counts ``[left, right, bottom, shifting, overall, inner]``.

``collision_counts`` launches the CUDA kernel (``csrc/collision.cu``) on CUDA
tensors and runs ``collision_counts_plain`` on CPU tensors. Both take a
leading batch axis: points (B, N, 3), valid (B, N) bool, params (B, G, 24)
from ``pack_grasp_params``, and return (B, G, 6) float32 integer counts.
"""

from __future__ import annotations

import torch

from graspbalance_tpu_torch import _build

N_COUNTS = 6  # left, right, bottom, shifting, overall, inner
N_PARAMS = 24


def pack_grasp_params(
    grasps: torch.Tensor, approach_dist: float, finger_width: float, finger_length: float
) -> torch.Tensor:
    """(..., G, 17) decoded grasp rows -> (..., G, 24) f32 parameters.

    Columns: 0-2 rx, 3-5 ry, 6-8 rz (gripper-frame axes = rotation
    columns), 9-11 translation, 12 -h/2, 13 h/2, 14 depth, 15 d-FL,
    16 d-FL-FW, 17 d-FL-FW-A, 18 w/2, 19 w/2+FW, 20-23 zero."""
    widths, heights, depths = grasps[..., 1], grasps[..., 2], grasps[..., 3]
    rot = grasps[..., 4:13].reshape(grasps.shape[:-1] + (3, 3))
    cols = [
        rot[..., :, 0], rot[..., :, 1], rot[..., :, 2],
        grasps[..., 13:16],
        (-heights / 2)[..., None],
        (heights / 2)[..., None],
        depths[..., None],
        (depths - finger_length)[..., None],
        (depths - finger_length - finger_width)[..., None],
        (depths - finger_length - finger_width - approach_dist)[..., None],
        (widths / 2)[..., None],
        (widths / 2 + finger_width)[..., None],
        torch.zeros(grasps.shape[:-1] + (4,), dtype=grasps.dtype, device=grasps.device),
    ]
    return torch.cat(cols, dim=-1).float()


def _check(points, valid, params):
    b, n, _ = points.shape
    if points.shape[-1] != 3 or valid.shape != (b, n) or params.ndim != 3 or params.shape[0] != b \
            or params.shape[-1] != N_PARAMS:
        raise ValueError(
            f"need points (B, N, 3), valid (B, N), params (B, G, {N_PARAMS}); got "
            f"{tuple(points.shape)}, {tuple(valid.shape)}, {tuple(params.shape)}"
        )


def collision_counts_plain(
    points: torch.Tensor, valid: torch.Tensor, params: torch.Tensor, *, chunk: int = 256
) -> torch.Tensor:
    """Plain PyTorch version: the (grasps, N) coordinate planes of a chunk
    of grasps at a time, in the kernel's association
    ``x = (d0*rx0 + d1*rx1) + d2*rx2``, every operation rounded on its own."""
    _check(points, valid, params)
    vld = valid.bool().unsqueeze(1)  # (B, 1, N)
    p = [points[..., j].unsqueeze(1) for j in range(3)]  # (B, 1, N)
    outs = []
    for lo in range(0, params.shape[1], chunk):
        par = params[:, lo : lo + chunk].unsqueeze(-1)  # (B, g, 24, 1)

        def col(c):
            return par[:, :, c]  # (B, g, 1)

        d = [p[j] - col(9 + j) for j in range(3)]
        x = d[0] * col(0) + d[1] * col(1) + d[2] * col(2)
        y = d[0] * col(3) + d[1] * col(4) + d[2] * col(5)
        z = d[0] * col(6) + d[1] * col(7) + d[2] * col(8)
        dfl, dflw, w2, w2fw = col(15), col(16), col(18), col(19)
        m_h = (z > col(12)) & (z < col(13)) & vld
        m_d = (x > dfl) & (x < col(14))
        m_lo, m_li = y > -w2fw, y < -w2
        m_ro, m_ri = y < w2fw, y > w2
        m_b = (x <= dfl) & (x > dflw)
        m_s = (x <= dflw) & (x > col(17))
        left = m_h & m_d & m_lo & m_li
        right = m_h & m_d & m_ro & m_ri
        bottom = m_h & m_lo & m_ro & m_b
        shifting = m_h & m_lo & m_ro & m_s
        overall = left | right | bottom | shifting
        inner = m_h & m_d & ~m_li & ~m_ri
        outs.append(
            torch.stack(
                [m.sum(dim=-1) for m in (left, right, bottom, shifting, overall, inner)], dim=-1
            )
        )
    return torch.cat(outs, dim=1).float()


def collision_counts(points: torch.Tensor, valid: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, N) bool, (B, G, 24) -> (B, G, 6) float32 counts."""
    _check(points, valid, params)
    if points.device.type == "cpu":
        return collision_counts_plain(points, valid, params)
    _build.require_cuda("points", points, torch.float32, 3)
    _build.require_cuda("valid", valid, torch.bool, 2)
    _build.require_cuda("params", params, torch.float32, 3)
    b, n, _ = points.shape
    g = params.shape[1]
    planes = points.transpose(1, 2).contiguous()  # (B, 3, N)
    counts = torch.zeros((b, g, N_COUNTS), dtype=torch.int32, device=points.device)
    lib = _build.library()
    with torch.cuda.device(points.device):
        err = lib.gb_collision(
            planes.data_ptr(), valid.data_ptr(), params.data_ptr(), counts.data_ptr(),
            b, n, g, _build.stream_of(points),
        )
    _build.check(err, "collision")
    return counts.float()
