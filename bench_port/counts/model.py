"""The models' operations per call, counted from a configuration and the
call's shapes: 2 x rows x in x out for every linear layer (and every other
product) of the forward pass, at the rows that layer sees. Elementwise
work, norms, gathers and reductions are not counted.

``graspbalance_forward`` counts the program's eval forward of
``GraspBalance``: the configuration's backbone, by its count file
``backbones/<name>.py``, and the heads; ``dsn_forward`` the DSN's. The CPU
tests hold both equal to ``torch.utils.flop_counter.FlopCounterMode``'s
count of the plain reference's forward.
"""

from __future__ import annotations

from pathlib import Path

from bench_port.harness import load_named

SEED_FEATURES = 256
WIDTH_K = 64
WIDTH_MLP = (64, 128, 256)
N_SCALES = 4
BACKBONES = Path(__file__).resolve().parent / "backbones"


def mlp(rows: int, dims) -> float:
    """A stack of linear layers dims[0] -> dims[1] -> ... over ``rows`` rows."""
    return sum(2.0 * rows * a * b for a, b in zip(dims[:-1], dims[1:]))


def backbone_count(name: str, bench=None):
    """The count file of backbone ``name``: ``<bench>/counts/backbones/<name>.py``
    (with no ``bench``, this package's); raises naming the file where there is none."""
    return load_named(Path(bench) / "counts" / "backbones" if bench else BACKBONES, name, "backbone count")


def graspbalance_forward(model: dict, batch: int, num_points: int, bench=None) -> float:
    """``model``: the configuration's GraspBalance arguments; ``batch``
    clouds of ``num_points`` points."""
    s, v = model["num_seed"], model["num_view"]
    a, d = model["num_angle"], model["num_depth"]
    total = backbone_count(model["backbone"], bench).forward(model["backbone_stages"], batch, num_points)
    total += mlp(batch * s, [SEED_FEATURES, SEED_FEATURES, 2 + v, 2 + v])
    total += N_SCALES * mlp(batch * s * d * WIDTH_K, [3, *WIDTH_MLP])
    total += mlp(batch * s * d, [N_SCALES * WIDTH_MLP[-1], 256]) + mlp(batch * s, [SEED_FEATURES, 256])
    total += mlp(batch * s * d, [256, 128, 128, 3 * a]) + mlp(batch * s * d, [256, 128, 128, a])
    return total


def dsn_forward(pt_stages, batch: int, num_points: int, knn: int = 16) -> float:
    """The point-transformer DSN: embed, per stage the grouping MLP and its
    vector-attention blocks, the projection and the two heads."""
    c = pt_stages[0][3]
    total = mlp(batch * num_points, [3, c])
    for npoint, _, nsample, channels, n_blocks in pt_stages:
        total += mlp(batch * npoint * nsample, [3 + c, channels])
        c, rows = channels, batch * npoint
        for _ in range(n_blocks):
            total += 3 * mlp(rows, [c, c])  # q, k, v
            total += mlp(rows * knn, [3, c, c])  # pos1, pos2
            total += mlp(rows * knn, [c, c, c])  # attn1, attn2
            total += mlp(rows, [c, 2 * c, c])
    rows = batch * pt_stages[-1][0]
    return total + mlp(rows, [c, 256]) + mlp(rows, [256, 256, 2]) + mlp(rows, [256, 256, 3])
