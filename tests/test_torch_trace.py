"""The port's spans and counters (``graspbalance_tpu_torch/trace.py``) on
the CPU: the span tree of one served call without and with OBS (names,
parents, one call id, children within their parents, self time >= 0), the
same answers with the tracer on and off, nothing recorded while it is off,
the host reads counted at each site (NMS's one a fixpoint test, as many as
its sweeps; the constants uploaded a call), one training step's tree, a span on the prefetch thread under
its own parent, and ``step_timer``'s two times."""

import dataclasses

import numpy as np
import pytest
import torch

from graspbalance_tpu_torch import trace
from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
from graspbalance_tpu_torch.eval.pipeline import GraspInference
from graspbalance_tpu_torch.models import DSN, GraspBalance
from graspbalance_tpu_torch.train.config import Config, DataConfig, ModelConfig
from graspbalance_tpu_torch.train.loop import Prefetch
from graspbalance_tpu_torch.train.metrics import step_timer
from graspbalance_tpu_torch.train.train_step import build_model, make_optimizer, train_step
from graspbalance_tpu_torch.weights import init_random_
from tiny import TINY_NUM_SEED, TINY_NUM_VIEW, TINY_QUALITY_SCENE, TINY_SCENE, TINY_STAGES
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

PT_STAGES = ((64, 0.2, 8, 16, 1), (32, 0.4, 8, 32, 1))  # test_torch_dsn.py's tiny DSN
SERVE_PARENTS = {
    "gb.call": None, "gb.upload": "gb.call", "gb.segment": "gb.call", "gb.fps": "gb.segment",
    "gb.dsn": "gb.segment", "gb.cluster": "gb.segment", "gb.model": "gb.call", "gb.backbone": "gb.model",
    "gb.obs_reseed": "gb.model", "gb.graspable": "gb.model", "gb.heads": "gb.model", "gb.decode": "gb.call",
    "gb.postprocess": "gb.call", "gb.nms": "gb.postprocess", "gb.voxel": "gb.postprocess",
    "gb.collision": "gb.postprocess", "gb.copy_out": "gb.call",
}
OBS_ONLY = {"gb.segment", "gb.fps", "gb.dsn", "gb.cluster", "gb.obs_reseed"}
STEP_PARENTS = {
    "gb.train_step": None, "gb.label_expand": "gb.train_step", "gb.forward_train": "gb.train_step",
    "gb.backbone": "gb.forward_train", "gb.graspable": "gb.forward_train", "gb.label_match": "gb.forward_train",
    "gb.heads": "gb.forward_train", "gb.loss": "gb.train_step", "gb.backward": "gb.train_step",
    "gb.optimizer": "gb.train_step",
}


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and its store empty."""
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


@pytest.fixture(scope="module")
def pipelines():
    model = init_random_(GraspBalance(backbone_stages=TINY_STAGES, num_seed=TINY_NUM_SEED, num_view=TINY_NUM_VIEW), 3)
    dsn = init_random_(DSN(PT_STAGES), 4)
    return {obs: GraspInference(model, dsn, use_obs=obs, device="cpu") for obs in (False, True)}


@pytest.fixture(scope="module")
def cloud():
    return make_batch(11, 2, TINY_QUALITY_SCENE)["point_clouds"]


def _traced(fn, **kw):
    trace.enable(**kw)
    try:
        out = fn()
    finally:
        trace.disable()
    return out, trace.take()


def _check_tree(spans, parents):
    """Each name once, under the parent ``parents`` names, within it in
    time, one call id, and no span's children outlasting it."""
    by_id = {s["id"]: s for s in spans}
    names = [s["name"] for s in spans]
    assert sorted(names) == sorted(set(names)), names
    assert set(names) <= set(parents), set(names) - set(parents)
    assert len({s["call"] for s in spans}) == 1
    for s in spans:
        parent = by_id.get(s["parent"])
        assert (parent["name"] if parent else None) == parents[s["name"]], s["name"]
        assert s["t1_ns"] >= s["t0_ns"]
        if parent:
            assert parent["t0_ns"] <= s["t0_ns"] and s["t1_ns"] <= parent["t1_ns"], s["name"]
        children = sum(c["t1_ns"] - c["t0_ns"] for c in spans if c["parent"] == s["id"])
        assert s["t1_ns"] - s["t0_ns"] - children >= 0, s["name"]  # self time
    return set(names)


@pytest.mark.parametrize("use_obs", [False, True])
def test_served_call_span_tree(pipelines, cloud, use_obs):
    _, got = _traced(lambda: pipelines[use_obs](cloud))
    names = _check_tree(got["spans"], SERVE_PARENTS)
    assert names == set(SERVE_PARENTS) - (set() if use_obs else OBS_ONLY)
    assert all(s["thread"] == got["spans"][0]["thread"] for s in got["spans"])


@pytest.mark.parametrize("use_obs", [False, True])
def test_answers_bit_equal_with_the_tracer_on_and_off(pipelines, cloud, use_obs):
    off = pipelines[use_obs](cloud)
    on, _ = _traced(lambda: pipelines[use_obs](cloud))
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_nothing_recorded_while_off(pipelines, cloud):
    assert not trace.enabled()
    pipelines[True](cloud)
    assert trace.take() == {"spans": [], "counters": {}}
    assert trace.span("gb.call") is trace.span("gb.model")  # one shared no-op context
    assert trace.host_read("x", lambda: 7) == 7


@pytest.mark.parametrize("use_obs", [False, True])
def test_host_reads_counted_at_each_site(pipelines, cloud, use_obs):
    _, got = _traced(lambda: pipelines[use_obs](cloud))
    c = got["counters"]
    sweeps = c["nms.sweeps"]
    assert 1 <= sweeps < TINY_NUM_SEED  # the fixpoint ended the loop, not the sweep cap
    # one read a fixpoint test: every sweep tests once, the last finds the fixpoint
    assert c["sync.nms"] == sweeps
    assert c["sync.upload"] == 1 and c["sync.copy_out"] == 2 and c["sync.voxel"] == 1
    # the constants uploaded a call: the template views and the fallback axis
    # of the top view's rotation (GraspableDetection) and of decode's
    assert c["sync.views"] == 1 and c["sync.fallback_axis"] == 2
    reads = sum(v for k, v in c.items() if k.startswith("sync."))
    assert reads == sweeps + 7
    # each read's wait lands in the innermost span open at the time
    assert sum(s["wait_ns"] for s in got["spans"]) == c["sync_wait_ns"] > 0
    waits = {s["name"] for s in got["spans"] if s["wait_ns"]}
    assert waits <= {"gb.upload", "gb.graspable", "gb.decode", "gb.nms", "gb.voxel", "gb.copy_out"}


def test_nms_sweeps_counted_per_call(pipelines, cloud):
    def two_calls():
        pipelines[False](cloud)
        pipelines[False](cloud)

    _, got = _traced(two_calls)
    assert len({s["call"] for s in got["spans"]}) == 2
    assert got["counters"]["sync.nms"] == got["counters"]["nms.sweeps"]
    assert got["counters"]["sync.upload"] == 2


def test_training_step_span_tree():
    scene = dataclasses.replace(SceneConfig(**dataclasses.asdict(TINY_SCENE)), analytic_labels=True,
                                emit_label_tensors=False)
    cfg = Config(model=ModelConfig(num_view=TINY_NUM_VIEW, backbone_stages=TINY_STAGES, num_seed=TINY_NUM_SEED),
                 data=DataConfig(num_points=scene.num_points, max_objects=scene.max_objects,
                                 max_grasp_points=scene.max_grasp_points, batch_size=2, analytic_labels=True))
    model = build_model(cfg, device="cpu")
    optimizer, scheduler = make_optimizer(model, cfg, 4)
    batch = make_batch(5, 2, scene)
    metrics, got = _traced(lambda: train_step(model, optimizer, scheduler, batch, 0, cfg), device_events=True)
    assert np.isfinite(float(metrics["loss/overall_loss"]))
    assert _check_tree(got["spans"], STEP_PARENTS) == set(STEP_PARENTS)
    assert all("device_ms" not in s for s in got["spans"])  # no CUDA device: host stamps only


def test_prefetch_span_under_its_own_parent():
    def source():
        for i in range(3):
            with trace.span("test.item"):
                pass
            yield i

    trace.enable()
    try:
        with trace.span("test.main"):
            assert list(Prefetch(source(), depth=1)) == [0, 1, 2]
    finally:
        trace.disable()
    spans = trace.take()["spans"]
    main = next(s for s in spans if s["name"] == "test.main")
    made = [s for s in spans if s["name"] == "gb.make_batch"]
    items = [s for s in spans if s["name"] == "test.item"]
    assert len(made) == 4 and len(items) == 3  # the fourth finds the source's end
    assert all(s["parent"] is None and s["thread"] != main["thread"] for s in made)
    assert len({s["call"] for s in made} | {main["call"]}) == 5  # each its own call
    ids = {s["id"] for s in made}
    assert all(s["parent"] in ids and s["thread"] == made[0]["thread"] for s in items)


def test_step_timer_on_the_host():
    out = {}
    with step_timer(out, "cpu"):
        sum(range(1000))
    assert set(out) == {"time/dispatch_ms", "time/step_ms"}
    assert out["time/step_ms"] == out["time/dispatch_ms"] >= 0
