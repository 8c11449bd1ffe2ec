"""The Point Transformer configuration (``graspbalance-pt``) at the CPU
tests' sizes (``reference/backbones/pt.py:TINY_STAGES``, 256-point scenes):
its serving, OBS-serving and training cells read correct; its count is
FlopCounterMode's; the program's seed indices rolled by one, the training
step on half the batch, a training step that leaves the state unchanged and
the TF32 control read not correct; flax's initialisation starts every norm at scale
1 and offset 0; the benchmark's reference agrees with the tests' own
(``tests/pt_reference.py``) on one draw."""

from __future__ import annotations

import json
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port import control, run, weights
from bench_port.counts import model as model_counts
from bench_port.reference import models as ref_models
from bench_port.reference.layers import BatchNorm
from bench_port.tests.tiny import REPO, add_cell, make_checkout, tiny_config

SEED = 2**31 + 7171
CONFIG = "graspbalance-pt"
SERVE, OBS, TRAIN = "tiny-pt.serve", "tiny-pt-obs.serve", "tiny-pt.train.b8"


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    torch.set_num_threads(1)
    root = make_checkout(tmp_path_factory.mktemp("checkout"))
    add_cell(root, SERVE, f"tiny-{CONFIG}", "tiny-serve.b4", "tiny-pn2.serve.b4")
    add_cell(root, OBS, f"tiny-{CONFIG}", "tiny-serve-obs.b4", "tiny-drp-obs.serve.b4")
    return root


@pytest.mark.parametrize("cell", [SERVE, OBS, TRAIN])
def test_pt_cell_runs_and_is_correct(checkout, cell):
    result, _ = run.run_cell(checkout, cell, SEED, 1.0, False, device="cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0


@pytest.mark.parametrize("cell", [SERVE, TRAIN])
def test_pt_control_is_not_correct(checkout, cell):
    out = control.readings(checkout, cell, SEED + 1, program=True, device="cpu")
    assert all(v <= lim for v, lim in out["program"].values()), out
    assert not all(v <= lim for v, lim in out["control"].values()), out


def test_pt_rolled_seed_indices_are_not_correct(checkout, monkeypatch):
    from graspbalance_tpu_torch.models import pt_backbone

    forward = pt_backbone.PTBackbone.forward

    def rolled(self, *args, **kwargs):
        out = forward(self, *args, **kwargs)
        out["fp2_inds"] = out["fp2_inds"].roll(1, dims=1)
        return out

    monkeypatch.setattr(pt_backbone.PTBackbone, "forward", rolled)
    result, _ = run.run_cell(checkout, SERVE, SEED + 2, 1.0, False, device="cpu")
    assert not result["correct"], result["checks"]
    assert result["checks"]["seed_mismatch"]["value"] > 0, result["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_pt_training_fault_is_not_correct(checkout, fault):
    out = control.readings(checkout, TRAIN, SEED + 3, program=True, device="cpu", fault=fault)
    assert not all(v <= lim for v, lim in out[f"fault:{fault}"].values()), out


def test_pt_count_is_the_counters():
    cfg = tiny_config(CONFIG)
    m = ref_models.GraspBalance(**cfg["model"]).eval()
    xyz = torch.rand((2, 256, 3), generator=torch.Generator().manual_seed(3)) + torch.tensor([-0.5, -0.5, 0.3])
    with FlopCounterMode(display=False) as fc:
        m(xyz, m.backbone.sample(xyz))
    assert fc.get_total_flops() == model_counts.graspbalance_forward(cfg["model"], 2, 256)


def test_pt_full_size_count():
    """The training cell's forward at bs=8 on 20,000 points (recorded in
    PERF.md), to the FLOP: the backbone, and the backbone with the heads."""
    from bench_port.counts.backbones import pt

    cfg = json.loads((REPO / "bench_port" / "configs" / f"{CONFIG}.json").read_text())
    assert pt.forward(cfg["model"]["backbone_stages"], 8, 20000) == 60_809_546_240
    assert model_counts.graspbalance_forward(cfg["model"], 8, 20000) == 780_158_962_176


def test_pt_flax_init_starts_every_norm_at_one_and_zero():
    cfg = json.loads((REPO / "bench_port" / "configs" / f"{CONFIG}.json").read_text())
    with torch.device("meta"):
        m = ref_models.GraspBalance(**cfg["model"])
    state = weights.flax_init_state(weights.shapes_of(m), SEED, "cpu", salt=4)
    norms = [name for name, mod in m.named_modules() if isinstance(mod, BatchNorm)]
    assert len(norms) > 100
    for name in norms:
        assert torch.equal(state[f"{name}.weight"], torch.ones_like(state[f"{name}.weight"])), name
        assert not state[f"{name}.bias"].any(), name
        assert not state[f"{name}.running_mean"].any(), name
    linears = [k for k, v in state.items() if v.ndim == 2]
    assert all(float(state[k].abs().max()) > 0 for k in linears)


@pytest.mark.parametrize("train", [False, True])
def test_pt_references_agree(train):
    sys.path.insert(0, str(REPO / "tests"))
    try:
        from pt_reference import PTReference
    finally:
        sys.path.remove(str(REPO / "tests"))
    cfg = tiny_config(CONFIG)["model"]
    stages, num_seed = cfg["backbone_stages"], cfg["num_seed"]
    bench = ref_models.backbone_file("pt").Backbone(stages, num_seed)
    state = weights.random_state(weights.shapes_of(bench), SEED, "cpu", salt=1)
    bench.load_state_dict(state)
    tests = PTReference(stages, num_seed)
    tests.load_state_dict(state)
    bench.train(train)
    tests.train(train)
    xyz = torch.rand((2, 256, 3), generator=torch.Generator().manual_seed(4)) + torch.tensor([-0.5, -0.5, 0.3])
    with torch.no_grad():
        sampled = bench.sample(xyz)
        got, want = bench(xyz, sampled), tests(xyz, sampled["fps_inds"])
    for key in ("fps_inds", "fp2_inds", "fp2_xyz"):
        assert torch.equal(got[key].long() if "inds" in key else got[key],
                           want[key].long() if "inds" in key else want[key]), key
    scale = float(want["fp2_features"].abs().max())
    assert float((got["fp2_features"] - want["fp2_features"]).abs().max()) <= 1e-5 * scale
