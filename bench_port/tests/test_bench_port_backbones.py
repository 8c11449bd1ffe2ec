"""A new backbone is new files only. In a temporary checkout, a toy backbone
(one PointNet layer over every point; as seeds, every 8th point in the order
of x: a sampling contract that is no prefix of an FPS) comes as a reference
file, a count file, a configuration and cell entries, and the program's side
is registered in the port's ``BACKBONES`` within the test alone. Its serving
and training cells run to correct; its count is FlopCounterMode's; the
program's seed indices rolled by one, and the reference's sampling rolled
by one, read not correct; an OBS cell on it is refused by the contract."""

from __future__ import annotations

import json

import pytest
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from bench_port import control, run
from bench_port.counts import model as model_counts
from bench_port.reference import models as ref_models
from bench_port.tests.tiny import MANIFEST, add_cell, add_config, make_checkout, tiny_config

SEED = 2**31 + 5151
TOY_STAGES = [[32, [16, 32]]]  # one stage: seeds, and the point MLP's widths

TOY_REFERENCE = '''"""A toy backbone: one PointNet layer, a shared MLP over every point, and at
each seed its point's features joined to the cloud's max. The seeds, its
sampling contract: every (N // npoint)-th point in the order of x."""

import torch
from torch import nn

from bench_port.reference import ops
from bench_port.reference.layers import MLPBlock, SharedMLP

TINY_STAGES = {stages!r}


class Backbone(nn.Module):
    SAMPLED = ("order_inds",)
    fps_prefix = None

    def __init__(self, stages, num_seed):
        super().__init__()
        ((self.npoint, widths),) = stages
        self.num_seed = num_seed
        self.point_mlp = SharedMLP(3, widths)
        self.seed_mlp = MLPBlock(2 * widths[-1], 256)

    def sample(self, xyz):
        order = torch.argsort(xyz[..., 0], dim=1, stable=True)
        return {{"order_inds": order[:, :: xyz.shape[1] // self.npoint][:, : self.npoint]}}

    def forward(self, xyz, sampled):
        inds = sampled["order_inds"]
        f = self.point_mlp(xyz)
        seed = ops.gather_points(f, inds)
        g = f.amax(dim=1, keepdim=True).expand_as(seed)
        return {{"input_xyz": xyz, "order_inds": inds, "fp2_xyz": ops.gather_points(xyz, inds),
                "fp2_features": self.seed_mlp(torch.cat([seed, g], dim=-1)), "fp2_inds": inds}}
'''.format(stages=TOY_STAGES)

TOY_COUNT = '''"""The toy backbone: its point MLP over every point, its seed MLP over the seeds."""

from bench_port.counts.model import mlp


def forward(stages, batch, num_points):
    ((npoint, widths),) = stages
    return mlp(batch * num_points, [3, *widths]) + mlp(batch * npoint, [2 * widths[-1], 256])
'''


class ToyBackbone(nn.Module):
    """The toy's program side, in the port's layers (the reference's names)."""

    def __init__(self, stages, num_seed=1024, *, query_order="index", fused_backbone_min_nsample=None,
                 dtype=torch.float32):
        from graspbalance_tpu_torch.nn.layers import MLPBlock, SharedMLP

        super().__init__()
        self.stages, self.num_seed = stages, num_seed
        ((self.npoint, widths),) = stages
        self.point_mlp = SharedMLP(3, widths, dtype=dtype)
        self.seed_mlp = MLPBlock(2 * widths[-1], 256, dtype=dtype)

    def forward(self, pointcloud, *, sa_inds=None, plain=False):
        order = torch.argsort(pointcloud[..., 0], dim=1, stable=True)
        inds = order[:, :: pointcloud.shape[1] // self.npoint][:, : self.npoint]

        def take(t):
            return torch.gather(t, 1, inds.unsqueeze(-1).expand(-1, -1, t.shape[-1]))

        f = self.point_mlp(pointcloud)
        seed = take(f)
        g = f.amax(dim=1, keepdim=True).expand_as(seed)
        inds = inds.to(torch.int32)
        return {"input_xyz": pointcloud, "order_inds": inds, "fp2_xyz": take(pointcloud),
                "fp2_features": self.seed_mlp(torch.cat([seed, g], dim=-1)), "fp2_inds": inds}


class RolledToy(ToyBackbone):
    """The toy with its seed indices rolled by one."""

    def forward(self, pointcloud, **kwargs):
        out = super().forward(pointcloud, **kwargs)
        out["fp2_inds"] = out["fp2_inds"].roll(1, dims=1)
        return out


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    torch.set_num_threads(1)
    root = make_checkout(tmp_path_factory.mktemp("checkout"))
    bench = root / "bench_port"
    (bench / "reference" / "backbones" / "toy.py").write_text(TOY_REFERENCE)
    (bench / "counts" / "backbones" / "toy.py").write_text(TOY_COUNT)
    base = next(c["name"] for c in MANIFEST["configs"] if "dsn" in tiny_config(c["name"]))
    cfg = tiny_config(base)  # a configuration with a DSN, so that an OBS cell could run
    cfg["model"].update(backbone="toy", backbone_stages=TOY_STAGES)
    add_config(root, "tiny-toy", cfg)
    for cell, traffic, like in (("tiny-toy.serve", "tiny-serve.b4", "tiny-pn2.serve.b4"),
                                ("tiny-toy-obs.serve", "tiny-serve-obs.b4", "tiny-drp-obs.serve.b4"),
                                ("tiny-toy.train", "tiny-train.b8", "tiny-drp.train.b8")):
        add_cell(root, cell, "tiny-toy", traffic, like)
    return root


@pytest.fixture
def toy_program(monkeypatch):
    from graspbalance_tpu_torch.models import graspbalance

    monkeypatch.setitem(graspbalance.BACKBONES, "toy", (ToyBackbone, TOY_STAGES))


def test_toy_count_is_the_counters(checkout):
    bench = checkout / "bench_port"
    cfg = json.loads((bench / "configs" / "tiny-toy.json").read_text())
    m = ref_models.GraspBalance(**cfg["model"], bench=bench).eval()
    xyz = torch.rand((2, 256, 3), generator=torch.Generator().manual_seed(3))
    with FlopCounterMode(display=False) as fc:
        m(xyz, m.backbone.sample(xyz))
    assert fc.get_total_flops() == model_counts.graspbalance_forward(cfg["model"], 2, 256, bench=bench)


@pytest.mark.parametrize("cell", ["tiny-toy.serve", "tiny-toy.train"])
def test_toy_cell_runs_and_is_correct(checkout, toy_program, cell):
    result, _ = run.run_cell(checkout, cell, SEED, 1.0, False, device="cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0


@pytest.mark.parametrize("cell", ["tiny-toy.serve", "tiny-toy.train"])
def test_toy_control_is_not_correct(checkout, toy_program, cell):
    out = control.readings(checkout, cell, SEED + 1, program=True, device="cpu")
    assert all(v <= lim for v, lim in out["program"].values()), out
    assert not all(v <= lim for v, lim in out["control"].values()), out


@pytest.mark.parametrize("side", ["program", "reference"])
def test_toy_rolled_seeds_are_not_correct(checkout, toy_program, monkeypatch, side):
    from graspbalance_tpu_torch.models import graspbalance

    if side == "program":
        monkeypatch.setitem(graspbalance.BACKBONES, "toy", (RolledToy, TOY_STAGES))
    else:
        backbone = ref_models.backbone_file("toy", checkout / "bench_port").Backbone
        sample = backbone.sample
        monkeypatch.setattr(backbone, "sample", lambda self, xyz: {
            k: v.roll(1, dims=1) for k, v in sample(self, xyz).items()})
    result, _ = run.run_cell(checkout, "tiny-toy.serve", SEED + 2, 1.0, False, device="cpu")
    assert not result["correct"], result["checks"]
    key = "seed_mismatch" if side == "program" else "fps_mismatch"
    assert result["checks"][key]["value"] > 0, result["checks"]


def test_toy_obs_cell_is_refused_by_the_contract(checkout, toy_program):
    with pytest.raises(ValueError, match="not a prefix of one FPS"):
        run.run_cell(checkout, "tiny-toy-obs.serve", SEED, 1.0, False, device="cpu")
