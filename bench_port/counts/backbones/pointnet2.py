"""The PointNet++ SSG backbone: DRP's count with no inverted-residual
blocks, its stages (npoint, radius, nsample, mlp)."""

from __future__ import annotations

from bench_port.counts.backbones import drp


def forward(stages, batch: int, num_points: int) -> float:
    return drp.forward([[*s, 0, None, None] for s in stages], batch, num_points)
