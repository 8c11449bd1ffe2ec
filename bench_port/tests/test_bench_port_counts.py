"""The benchmark's operation counts against FlopCounterMode's count of the
plain reference's forward, each configuration through its backbone's files
(the reference backbone and its count), and the width-MLP kernel's count
against the kernel table's (chip_smoke.py, K5 at bs=4)."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port.counts import kernels, model
from bench_port.reference import dsn as ref_dsn
from bench_port.reference import models as ref_models
from bench_port.reference import ops
from bench_port.tests.tiny import MANIFEST, tiny_config


def _cloud(b, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((b, n, 3), generator=g) * 0.4 + torch.tensor([-0.2, -0.2, 0.3])


@pytest.mark.parametrize("name", [c["name"] for c in MANIFEST["configs"]])
def test_model_flops_equal_the_counter(name):
    cfg = tiny_config(name)
    b, n = 2, 256
    m = ref_models.GraspBalance(**cfg["model"]).eval()
    xyz = _cloud(b, n)
    sampled = m.backbone.sample(xyz)
    with FlopCounterMode(display=False) as fc:
        m(xyz, sampled)
    assert fc.get_total_flops() == model.graspbalance_forward(cfg["model"], b, n)


def test_dsn_flops_equal_the_counter():
    cfg = tiny_config("graspbalance-drp")
    b, n = 2, 256
    d = ref_dsn.DSN(cfg["dsn"]["pt_stages"]).eval()
    xyz = _cloud(b, n, 1)
    sa = ops.furthest_point_sample(xyz, cfg["dsn"]["pt_stages"][0][0])
    with FlopCounterMode(display=False) as fc:
        d(xyz, sa)
    assert fc.get_total_flops() == model.dsn_forward(cfg["dsn"]["pt_stages"], b, n)


def test_widthmlp_count_at_the_path_shapes():
    ops_, nbytes = kernels.widthmlp(4, 1024, 4, 4, 64)
    rows = 4 * 1024 * 4 * 64
    tail = 4 * (64 * 128 + 128 * 256)  # chip_smoke.py's widthmlp_bound: 3xTF32 products of layers 1 and 2
    assert 2.0 * tail * rows == 343_597_383_680
    layer0 = 4 * 3 * 64
    fold = 2.0 * 4 * 1024 * (3 * 3 + 3) * 4 * 64
    assert ops_ == 2.0 * (tail + layer0) * rows + fold
    assert nbytes > 4 * rows * 4 * 3  # the grouped input is read at least once


def test_full_size_counts():
    """The counts of the cells' shapes (recorded in PERF.md), to the FLOP."""
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    drp = json.loads((root / "bench_port/configs/graspbalance-drp.json").read_text())
    pn2 = json.loads((root / "bench_port/configs/graspbalance-pointnet2.json").read_text())
    counts = (model.graspbalance_forward(drp["model"], 4, 20000), model.graspbalance_forward(pn2["model"], 4, 20000),
              model.dsn_forward(drp["dsn"]["pt_stages"], 4, 20000))
    g_drp, g_pn2, g_dsn = (c / 1e9 for c in counts)
    assert 400 < g_drp < 1000 and 300 < g_pn2 < g_drp and 10 < g_dsn < 200, (g_drp, g_pn2, g_dsn)
    assert counts == (453_034_672_128, 400_548_200_448, 23_361_536_000)


def test_scatter_count_is_the_kernel_tables():
    """chip_smoke.py's K11 bound counts the cotangents, the indices and the
    sums as bytes: ct.numel() * 4 + idx.numel() * 4 + b * n * c * 4."""
    b, r, c, n = 8, 2048 * 64, 128, 2048
    ops_, nbytes = kernels.scatter_add(b, r, c, n)
    assert nbytes == b * r * c * 4 + b * r * 4 + b * n * c * 4
    assert ops_ == b * r * c
