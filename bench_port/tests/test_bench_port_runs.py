"""Tiny cells driven through the harness on the CPU (the program's plain
versions run there): added as files in a temporary checkout and picked up
by name; sound runs come out correct; the control and faults planted in the
timed path come out not correct: a stale answer, half of the batch, an
altered grasp or label, shifted seeds, flipped views, moved seed indices
(serving); half of the batch, the state left
unchanged (training). The cells run on one chip, so no exchange between
chips can be left out."""

from __future__ import annotations

import json

import pytest
import torch

from bench_port import control, run
from bench_port.tests.tiny import make_checkout

SEED = 2**31 + 977
CELLS = ("tiny-drp-obs.serve.b4", "tiny-pn2.serve.b4")


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    torch.set_num_threads(1)
    root = make_checkout(tmp_path_factory.mktemp("checkout"))
    bench = root / "bench_port"
    # a throwaway end-to-end metric and a throwaway per-layer metric, as files and entries only
    (bench / "metrics" / "calls_n.py").write_text("def read(run):\n    return run.attempted\n")
    (bench / "metrics" / "empty_reader.py").write_text("def read(run):\n    return None\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["end_to_end"].append({"name": "calls_n", "unit": "calls", "better": "higher", "bound": 0.1,
                                   "source": "host_clock", "workloads": list(CELLS)})
    manifest["per_layer"].append({"name": "empty_reader", "unit": "ms", "better": "lower", "source": "program_span",
                                  "layer": "model", "moves": "calls_n", "workloads": list(CELLS)})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


@pytest.mark.parametrize("cell", CELLS)
def test_added_cell_runs_and_is_correct(checkout, cell):
    result, r = run.run_cell(checkout, cell, SEED, 1.0, False, device="cpu")
    assert result["correct"], result["checks"]
    rate = {"tiny-drp-obs.serve.b4": {"scenes_per_s.obs", "call_p95_ms.obs"},
            "tiny-pn2.serve.b4": {"scenes_per_s", "call_p95_ms"}}
    assert set(result["metrics"]) == rate[cell] | {"setup_s", "calls_n"}
    assert result["metrics"]["calls_n"]["value"] == result["attempted"] > 0
    assert list(result)[-1] == "checks"
    traced, _ = run.run_cell(checkout, cell, SEED, 1.0, True, device="cpu")
    assert "empty_reader" not in traced["metrics"]  # a reader that finds nothing leaves its metric out


@pytest.mark.parametrize("cell", CELLS + ("tiny-drp.train.b8",))
def test_control_is_not_correct(checkout, cell):
    out = control.readings(checkout, cell, SEED + 1, program=True, device="cpu")
    prog_pass = all(v <= lim for v, lim in out["program"].values())
    ctl_pass = all(v <= lim for v, lim in out["control"].values())
    assert prog_pass and not ctl_pass, out


def test_training_cell_runs_and_is_correct(checkout):
    result, r = run.run_cell(checkout, "tiny-drp.train.b8", SEED, 1.0, False, device="cpu")
    assert result["correct"], result["checks"]
    assert {"train_clouds_per_s", "setup_s"} <= set(result["metrics"]) and result["attempted"] > 0
    assert set(result["checks"]) == {"loss1_err", "metric1_err", "grad_gap", "change_gap"}


def _train_fault(monkeypatch, kind):
    from graspbalance_tpu_torch.train import train_step as ts

    step = ts.train_step

    def faulty(model, opt, sched, batch, epoch, cfg, **kw):
        if kind == "half_batch":  # the mean over the first half of the rows
            h = next(iter(batch.values())).shape[0] // 2
            return step(model, opt, sched, {k: v[:h] for k, v in batch.items()}, epoch, cfg, **kw)
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        out = step(model, opt, sched, batch, epoch, cfg, **kw)
        with torch.no_grad():  # the state left as it was
            for k, p in model.named_parameters():
                p.copy_(before[k])
        return out

    monkeypatch.setattr(ts, "train_step", faulty)


@pytest.mark.parametrize("kind", ["half_batch", "unchanged"])
def test_training_fault_is_not_correct(checkout, kind, monkeypatch):
    _train_fault(monkeypatch, kind)
    result, _ = run.run_cell(checkout, "tiny-drp.train.b8", SEED + 3, 1.0, False, device="cpu")
    assert not result["correct"], result["checks"]


def _stale(monkeypatch):
    from graspbalance_tpu_torch.models.graspbalance import GraspBalance

    orig, first = GraspBalance.forward, []

    def stale(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        if not first:
            first.append(out)
        return first[0]

    monkeypatch.setattr(GraspBalance, "forward", stale)


def _half_batch(monkeypatch):
    from graspbalance_tpu_torch.eval.pipeline import GraspInference

    orig = GraspInference.forward

    def half(self, cloud, **kwargs):
        h = max(cloud.shape[0] // 2, 1)
        kwargs = {k: v[:h] if torch.is_tensor(v) else v for k, v in kwargs.items()}
        ep = orig(self, cloud[:h], **kwargs)
        return {k: v.repeat((cloud.shape[0] + h - 1) // h, *([1] * (v.ndim - 1)))[: cloud.shape[0]]
                if torch.is_tensor(v) else v for k, v in ep.items()}

    monkeypatch.setattr(GraspInference, "forward", half)


def _altered_grasp(monkeypatch):
    from graspbalance_tpu_torch.eval import pipeline

    orig = pipeline.pred_decode

    def altered(ep):
        grasps, valid = orig(ep)
        grasps = grasps.clone()
        grasps[0, 0, 0] += 1e-3
        return grasps, valid

    monkeypatch.setattr(pipeline, "pred_decode", altered)


def _altered_label(monkeypatch):
    from graspbalance_tpu_torch.eval import pipeline

    orig = pipeline.cluster

    def altered(*args, **kwargs):
        labels, centers, keep = orig(*args, **kwargs)
        labels = labels.clone()
        labels[0, 0] += 1
        return labels, centers, keep

    monkeypatch.setattr(pipeline, "cluster", altered)


def _altered_seeds(key, change):
    def plant(monkeypatch):
        from graspbalance_tpu_torch.models.graspbalance import GraspBalance

        orig = GraspBalance.forward

        def altered(self, *args, **kwargs):
            out = dict(orig(self, *args, **kwargs))
            out[key] = change(out[key])
            return out

        monkeypatch.setattr(GraspBalance, "forward", altered)

    return plant


FAULTS = {"stale": _stale, "half_batch": _half_batch, "altered_grasp": _altered_grasp,
          "altered_label": _altered_label,
          # the seeds' positions and approach vectors feed the decode, which the check redoes from them
          "shifted_seeds": _altered_seeds("fp2_xyz", lambda v: v + 1e-3),
          "flipped_views": _altered_seeds("grasp_top_view_xyz", lambda v: -v),
          "rolled_seed_inds": _altered_seeds("fp2_inds", lambda v: v.roll(1, dims=1))}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(checkout, cell, fault, monkeypatch):
    if fault == "altered_label" and cell == "tiny-pn2.serve.b4":
        pytest.skip("the cell runs no segmentation")
    FAULTS[fault](monkeypatch)
    result, _ = run.run_cell(checkout, cell, SEED + 2, 2.0, False, device="cpu")
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
def test_tiny_cells_on_the_card(checkout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in CELLS + ("tiny-drp.train.b8",):
        result, _ = run.run_cell(checkout, cell, SEED, 2.0, True, device="cuda")
        assert result["correct"], result["checks"]
        assert result["device"]["busy_s"] > 0
