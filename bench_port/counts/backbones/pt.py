"""Point Transformer (Seg50): its linear layers at the rows each sees, with
stages (npoint, k, channels, blocks), stage 1 at every one of the cloud's
``num_points`` points. The attention's weighted sum over the neighbours and
its softmax are elementwise work, not counted."""

from __future__ import annotations

from bench_port.counts.model import mlp

SHARE_PLANES = 8
HEAD_FEATURES = 256


def bottleneck(rows: int, k: int, c: int) -> float:
    """One Bottleneck at ``rows`` points of ``c`` channels, ``k`` neighbours each."""
    g = c // SHARE_PLANES
    total = 5 * mlp(rows, [c, c])  # linear1, q, k, v, linear3
    total += mlp(rows * k, [3, 3, c])  # the position code
    return total + mlp(rows * k, [c, g, g])  # the attention weights


def forward(stages, batch: int, num_points: int) -> float:
    points = [num_points] + [s[0] for s in stages[1:]]
    widths = [s[2] for s in stages]
    total, c_in = 0.0, 3
    for i, (_, k, c, blocks) in enumerate(stages):
        rows = batch * points[i]
        total += mlp(rows, [c_in, c]) if i == 0 else mlp(rows * k, [3 + c_in, c])
        total += (blocks + 1) * bottleneck(rows, k, c)  # the encoder's blocks and the decoder's one
        c_in = c
    total += mlp(batch, [widths[-1], widths[-1]]) + mlp(batch * points[-1], [2 * widths[-1], widths[-1]])
    for i in range(len(stages) - 1):
        total += mlp(batch * points[i], [widths[i], widths[i]]) + mlp(batch * points[i + 1], [widths[i + 1], widths[i]])
    return total + mlp(batch * num_points, [widths[0], widths[0], HEAD_FEATURES])
