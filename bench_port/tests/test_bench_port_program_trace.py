"""The per-layer metrics read from the program's own spans and counters
(``program_trace.py``) on tiny cells on the CPU: a traced run of each
serving cell reports ``dispatch_ms.*`` and ``sync_wait_ms.*``, which add up
to the pass's call time, with the per-span table in its notes; a training
run's table holds the step's spans; a run with ``--trace 0`` never switches
the tracer on; a program without the tracer module gives none of them and
raises nothing. On the card, each tiny cell's traced run also reports
``label_ms.train`` and keeps nearly all device work inside the top-level
spans."""

from __future__ import annotations

import sys

import pytest
import torch

from bench_port import program_trace, run
from bench_port.tests.tiny import make_checkout

SEED = 2**31 + 4242
SERVE = {"tiny-drp-obs.serve.b4": ("dispatch_ms.obs", "sync_wait_ms.obs"),
         "tiny-pn2.serve.b4": ("dispatch_ms.serve", "sync_wait_ms.serve")}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    torch.set_num_threads(1)
    return make_checkout(tmp_path_factory.mktemp("checkout"))


def _command(monkeypatch, cell, seed=SEED):
    monkeypatch.setattr(sys, "argv", ["bench_port/run.py", "--workload", cell, "--seed", str(seed), "--seconds", "1",
                                      "--trace", "1"])


@pytest.mark.parametrize("cell", sorted(SERVE))
def test_traced_serving_run_reports_dispatch_and_waits(checkout, cell, monkeypatch):
    _command(monkeypatch, cell)
    result, r = run.run_cell(checkout, cell, SEED, 1.0, True, device="cpu")
    assert result["correct"], result["checks"]
    dispatch, wait = (result["metrics"][name]["value"] for name in SERVE[cell])
    assert dispatch > 0 and wait > 0
    window, spans, counters = (result["notes"][k] for k in ("program_window", "program_spans", "counters"))
    assert window["calls"] == 2 * 4  # twice over the tiny pool's 4 batches
    # the call's host time is its dispatch and its waits, and nearly all of the pass's time a call
    assert dispatch + wait == pytest.approx(spans["gb.call"]["host_ms"])
    assert 0.9 * window["call_ms"] <= dispatch + wait <= window["call_ms"]
    assert counters["sync.upload"] == 1 and counters["sync.copy_out"] == 2
    assert counters["sync.nms"] == counters["nms.sweeps"] >= 1
    assert spans["gb.call"]["wait_ms"] == pytest.approx(wait)
    assert ("gb.obs_reseed" in spans) == (cell == "tiny-drp-obs.serve.b4")
    assert window["top_level"] == ["gb.call"] and window["ops"] == 0  # no device on the CPU


def test_traced_training_run_holds_the_step_spans(checkout, monkeypatch):
    _command(monkeypatch, "tiny-drp.train.b8")
    result, r = run.run_cell(checkout, "tiny-drp.train.b8", SEED, 1.0, True, device="cpu")
    assert result["correct"], result["checks"]
    spans = result["notes"]["program_spans"]
    assert {"gb.train_step", "gb.transfer", "gb.make_batch", "gb.label_expand", "gb.label_match",
            "gb.backward", "gb.optimizer"} <= set(spans)
    assert spans["gb.train_step"]["calls"] == 1 and result["notes"]["program_window"]["calls"] == 4
    assert "label_ms.train" not in result["metrics"]  # its device events need a card


def test_untraced_run_never_switches_the_tracer_on(checkout, monkeypatch):
    from graspbalance_tpu_torch import trace

    switched = []
    monkeypatch.setattr(trace, "enable", lambda **kw: switched.append(kw))
    _command(monkeypatch, "tiny-pn2.serve.b4")
    for cell in ("tiny-pn2.serve.b4", "tiny-drp.train.b8"):
        result, r = run.run_cell(checkout, cell, SEED, 1.0, False, device="cpu")
        assert result["correct"] and not switched
        assert getattr(r, "program", None) is None and "program_spans" not in result["notes"]


def test_program_without_the_tracer_gives_nothing(checkout, monkeypatch):
    monkeypatch.setattr(program_trace, "program_has_tracer", lambda: False)
    _command(monkeypatch, "tiny-pn2.serve.b4")
    result, r = run.run_cell(checkout, "tiny-pn2.serve.b4", SEED, 1.0, True, device="cpu")
    assert result["correct"] and r.program == {}
    assert not {"dispatch_ms.serve", "sync_wait_ms.serve"} & set(result["metrics"])


def test_without_the_command_line_nothing_is_measured(checkout, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["pytest"])
    result, r = run.run_cell(checkout, "tiny-pn2.serve.b4", SEED, 1.0, True, device="cpu")
    assert r.program == {} and "dispatch_ms.serve" not in result["metrics"]


@pytest.mark.cuda
def test_tiny_cells_trace_the_program_on_the_card(checkout, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell, names in [*SERVE.items(), ("tiny-drp.train.b8", ("label_ms.train",))]:
        _command(monkeypatch, cell)
        result, _ = run.run_cell(checkout, cell, SEED, 2.0, True, device="cuda")
        assert result["correct"], result["checks"]
        assert all(result["metrics"][name]["value"] > 0 for name in names), result["metrics"]
        assert result["notes"]["program_window"]["top_level_busy_share"] >= 0.95
