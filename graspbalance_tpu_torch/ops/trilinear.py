"""Trilinear sampling of a dense feature volume at continuous points (port
of graspbalance_tpu/ops/trilinear.py; the reference's TrilinearIntepolation,
which the live model does not use)."""

from __future__ import annotations

import torch


def trilinear_sample(volume: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """volume (B, X, Y, Z, C); points (B, N, 3) in [0, 1]^3 normalised
    coordinates (clipped to it) -> (B, N, C): the eight corners' values
    weighted trilinearly, summed in the JAX package's order."""
    b, x, y, z, c = volume.shape
    dims = torch.tensor([x - 1, y - 1, z - 1], dtype=torch.float32, device=points.device)
    p = torch.clamp(points, 0.0, 1.0) * dims
    p0 = torch.floor(p)
    frac = p - p0
    p0 = p0.to(torch.int64)
    p1 = torch.minimum(p0 + 1, dims.to(torch.int64))
    vol = volume.reshape(b, x * y * z, c)

    def gather(ix, iy, iz):
        flat = (ix * y + iy) * z + iz  # (B, N)
        return vol.gather(1, flat.unsqueeze(-1).expand(-1, -1, c))

    fx, fy, fz = frac[..., 0:1], frac[..., 1:2], frac[..., 2:3]
    return (
        gather(p0[..., 0], p0[..., 1], p0[..., 2]) * (1 - fx) * (1 - fy) * (1 - fz)
        + gather(p1[..., 0], p0[..., 1], p0[..., 2]) * fx * (1 - fy) * (1 - fz)
        + gather(p0[..., 0], p1[..., 1], p0[..., 2]) * (1 - fx) * fy * (1 - fz)
        + gather(p0[..., 0], p0[..., 1], p1[..., 2]) * (1 - fx) * (1 - fy) * fz
        + gather(p1[..., 0], p1[..., 1], p0[..., 2]) * fx * fy * (1 - fz)
        + gather(p1[..., 0], p0[..., 1], p1[..., 2]) * fx * (1 - fy) * fz
        + gather(p0[..., 0], p1[..., 1], p1[..., 2]) * (1 - fx) * fy * fz
        + gather(p1[..., 0], p1[..., 1], p1[..., 2]) * fx * fy * fz
    )
