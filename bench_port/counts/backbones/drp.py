"""The DRP backbone: set abstraction and the inverted-residual blocks of each
stage (npoint, radius, nsample, mlp, blocks, block radius, block nsample),
and the two feature-propagation stages."""

from __future__ import annotations

from bench_port.counts.model import mlp


def forward(stages, batch: int, num_points: int) -> float:
    total, c = 0.0, 0
    for npoint, _, nsample, widths, blocks, _, _ in stages:
        total += mlp(batch * npoint * nsample, [3 + c, *widths])
        c = widths[-1]
        rows = batch * npoint
        for _ in range(blocks):
            total += 2 * mlp(rows, [3 + c, c])  # the lifted conv on the points and on the centers
            total += mlp(rows, [c, 4 * c, c])
    w = [s[3][-1] for s in stages]
    total += mlp(batch * stages[2][0], [w[3] + w[2], 256, 256])
    total += mlp(batch * stages[1][0], [256 + w[1], 256, 256])
    return total
