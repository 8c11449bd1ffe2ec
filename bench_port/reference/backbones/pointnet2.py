"""The PointNet++ SSG backbone (graspnet-baseline's): DRP's set abstraction
and feature propagation without its inverted-residual blocks. A stage is
(npoint, radius, nsample, mlp); the sampling contract is DRP's, one FPS of
the raw cloud whose first stage's npoint prefix it takes."""

from __future__ import annotations

from bench_port.reference.backbones import drp

TINY_STAGES = [s[:4] for s in drp.TINY_STAGES]


class Backbone(drp.Backbone):
    def __init__(self, stages, num_seed):
        super().__init__([[*s, 0, None, None] for s in stages], num_seed)
