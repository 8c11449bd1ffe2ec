"""Twins of the loop tests of tests/test_train.py on the port alone (the
CPU): resume continuity, the refusal to resume under another model config,
checkpoint round trips and best-loss retention, the data source's telemetry
in the metric stream, the aggregator's lazy mean; and the loop's prefetch
thread and transfer cache.

Tolerance: exact. The resumed run's parameters, BatchNorm statistics and
Adam moments are bit-equal to the uninterrupted run's; a restored
checkpoint is bit-equal to what was saved and continues the same way.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import graspbalance_tpu_torch.train.loop as loop
from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
from graspbalance_tpu_torch.train.checkpoints import CheckpointManager, load_config, load_inference_variables
from graspbalance_tpu_torch.train.config import Config, DataConfig, ModelConfig, TrainConfig
from graspbalance_tpu_torch.train.metrics import MetricAggregator
from graspbalance_tpu_torch.train.train_step import build_model, create_train_state, train_step
from tiny import TINY_NUM_SEED, TINY_NUM_VIEW, TINY_SCENE, TINY_STAGES
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

TINY_PORT_SCENE = SceneConfig(**{f.name: getattr(TINY_SCENE, f.name) for f in dataclasses.fields(SceneConfig)})


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _ckpt_steps(directory):
    return sorted(int(n[5:-3]) for n in os.listdir(directory) if n.startswith("step_") and n.endswith(".pt"))


def _tiny_cfg(log_dir, **train):
    return Config(
        model=ModelConfig(num_view=TINY_NUM_VIEW, num_seed=TINY_NUM_SEED, backbone_stages=TINY_STAGES),
        data=DataConfig(batch_size=2),
        train=TrainConfig(log_dir=str(log_dir), **train),
    )


def _tiny_batches(steps):
    def batches(epoch):
        for i in range(steps):
            yield make_batch(epoch * steps + i, 2, TINY_PORT_SCENE)

    return batches


def test_interrupted_training_matches_uninterrupted(tmp_path):
    """Stopped after 2 of 3 epochs and resumed, the run ends bit-equal to
    one run straight through (parameters, BatchNorm statistics, the
    optimizer's moments), with the eval stream on."""
    batches = _tiny_batches(2)
    evals = lambda: iter([make_batch(50, 2, TINY_PORT_SCENE)])  # noqa: E731
    kw = dict(max_epoch=3, log_every=10, seed=7)
    full = loop.train(_tiny_cfg(tmp_path / "full", **kw), batches, evals, steps_per_epoch=2, device="cpu")
    loop.train(_tiny_cfg(tmp_path / "res", stop_after_epochs=2, **kw), batches, evals, steps_per_epoch=2,
               device="cpu")
    res = loop.train(_tiny_cfg(tmp_path / "res", **kw), batches, evals, steps_per_epoch=2, device="cpu")
    assert res.step == full.step == 6
    a, b = full.model.state_dict(), res.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = full.optimizer.state_dict()["state"], res.optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"]) for i in sa)
    # the resumed run took epoch 3 only; each run evaluated after each of its epochs
    assert [r["step"] for r in _jsonl(tmp_path / "res" / "test_metrics.jsonl")] == [2, 4, 6]


def test_resume_with_mismatched_model_config_errors(tmp_path):
    cfg = _tiny_cfg(tmp_path / "run", max_epoch=2, log_every=10, seed=7, stop_after_epochs=1)
    loop.train(cfg, _tiny_batches(1), steps_per_epoch=1, device="cpu")
    bad = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, num_seed=2 * TINY_NUM_SEED))
    with pytest.raises(ValueError, match="resume config mismatch.*num_seed"):
        loop.train(bad, _tiny_batches(1), steps_per_epoch=1, device="cpu")
    assert load_config(str(tmp_path / "run" / "checkpoints")).model.num_seed == TINY_NUM_SEED


def _tiny_state(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    batch = make_batch(0, 2, TINY_PORT_SCENE)
    return cfg, batch, create_train_state(cfg, 10, batch, device="cpu")


def _step(state, batch, cfg):
    train_step(state.model, state.optimizer, state.scheduler, batch, 0, cfg)
    state.step += 1


def test_checkpoint_round_trip(tmp_path):
    cfg, batch, state = _tiny_state(tmp_path)
    _step(state, batch, cfg)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state, extra={"epoch": 1})
    fresh = create_train_state(dataclasses.replace(cfg, train=TrainConfig(seed=9)), 10, batch, device="cpu")
    restored, extra = mgr.restore(fresh)
    assert restored.step == 1 and extra == {"epoch": 1}
    a, b = state.model.state_dict(), restored.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert restored.scheduler.last_epoch == state.scheduler.last_epoch == 1
    # both continue the same way
    _step(state, batch, cfg)
    _step(restored, batch, cfg)
    a, b = state.model.state_dict(), restored.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    for step in range(2, 6):  # max_to_keep=3
        mgr.save(step, state)
    assert _ckpt_steps(tmp_path / "ckpt") == [3, 4, 5]
    assert not [n for n in os.listdir(tmp_path / "ckpt") if ".tmp" in n]


def test_best_loss_retention_and_inference_restore(tmp_path):
    cfg, batch, state = _tiny_state(tmp_path)
    _step(state, batch, cfg)
    params1 = {k: v.clone() for k, v in state.model.state_dict().items()}
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state, metrics={"loss": 2.0})
    _step(state, batch, cfg)
    assert mgr.best_loss() == pytest.approx(2.0)
    mgr.save(2, state, metrics={"loss": 3.0})  # worse: the best stays step 1
    assert mgr.best_loss() == pytest.approx(2.0)
    variables, step = load_inference_variables(str(tmp_path / "ckpt"))
    assert step == 2
    best, best_step = load_inference_variables(str(tmp_path / "ckpt"), best=True)
    assert best_step == 1
    assert all(torch.equal(best[k], params1[k]) for k in params1)
    # the restored variables drive the eval forward directly
    model = build_model(cfg, device="cpu")
    model.load_state_dict(variables)
    model.eval()(torch.from_numpy(batch["point_clouds"]))
    with pytest.raises(FileNotFoundError):
        load_inference_variables(str(tmp_path / "nothing"), best=True)


def test_telemetry_counters_reach_metric_stream(tmp_path):
    batches = _tiny_batches(2)
    batches.telemetry = lambda: {"data/truncated_items": 3.0, "data/truncated_points": 99.0}
    loop.train(_tiny_cfg(tmp_path, max_epoch=1, log_every=1), batches, steps_per_epoch=2, device="cpu")
    lines = _jsonl(tmp_path / "train_metrics.jsonl")
    assert any(r.get("data/truncated_items") == 3.0 for r in lines)
    assert any(r.get("data/truncated_points") == 99.0 for r in lines)


def test_aggregator_lazy_mean():
    agg = MetricAggregator()
    for i in range(4):
        agg.update({"loss": torch.tensor(float(i)), "acc": torch.tensor(2.0 * i), "time/step_ms": 1.0})
    out = agg.flush()
    assert out == {"loss": pytest.approx(1.5), "acc": pytest.approx(3.0), "time/step_ms": pytest.approx(1.0)}
    assert agg.flush() == {}


def test_prefetch_raises_the_source_error():
    def source():
        yield 1
        raise KeyError("boom")

    it = iter(loop.Prefetch(source()))
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)


def test_transfer_cache_hits_by_identity():
    cache = loop.TransferCache("cpu")
    static = np.broadcast_to(np.arange(6, dtype=np.float32).reshape(1, 6), (3, 6))
    first = cache.put({"a": static, "b": np.ones(2)})
    second = cache.put({"a": static, "b": np.ones(2)})
    assert second["a"] is first["a"] and second["b"] is not first["b"]
    assert dict(cache.uploads) == {"a": 1, "b": 2}
    assert torch.equal(first["a"], torch.from_numpy(np.array(static)))
    assert cache.uploaded_bytes == 6 * 4 + 2 * 2 * 8  # the broadcast array's one row

