"""The port's closed-loop quality pieces against the JAX package's: the
analytic scorers (labels/analytic.py: analytic_grasp_quality,
analytic_average_precision, _per_grasp_quality), eval/quality.py (the
oracle's rows and metrics, evaluate_quality), and a CPU twin of
tests/test_quality.py::TestClosedLoop::test_gate_machinery_runs_and_model_learns,
at tests/tiny.py's sizes.

Tolerances:
  - the scorers: equal, exactly (the same numpy operations on the same
    float32 rows), on random rows with float-valued widths, depths and
    centres, and on tests/test_quality.py's crafted cases;
  - oracle_decode_rows: bit-equal on make_batch scenes of both packages;
  - evaluate_oracle_quality: the keep masks of every batch equal and the
    metrics equal, exactly (the same rows through NMS and the collision
    filter on both sides);
  - evaluate_quality with the JAX model's initial variables: the keep
    masks equal, exactly (every decoded grasp of these scenes clears the
    postprocess's thresholds by more than EVAL_TOL, reported on failure),
    the metrics within EVAL_TOL relative (the decoded rows differ by f32
    rounding, ~1e-6);
  - the gate machinery: the JAX test's own assertions (max recall > 0.2,
    held-out accuracy > 0.7 and 0.1 over the untrained model's, held-out
    recall > 0.3, every metric finite);
  - run_gate: the JAX tool's JSON keys, with its rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspbalance_tpu.data.synthetic import make_batch as j_make_batch
from graspbalance_tpu.eval import quality as jq
from graspbalance_tpu.eval.pipeline import GraspInference as JGraspInference
from graspbalance_tpu.labels import analytic as jan
from graspbalance_tpu.train import train_step as jts
from graspbalance_tpu.train.config import Config as JConfig
from graspbalance_tpu.train.config import DataConfig as JDataConfig
from graspbalance_tpu.train.config import ModelConfig as JModelConfig
from graspbalance_tpu_torch.cli import quality_gate
from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
from graspbalance_tpu_torch.eval import quality
from graspbalance_tpu_torch.eval.pipeline import GraspInference
from graspbalance_tpu_torch.labels import analytic as an
from graspbalance_tpu_torch.train.config import Config, DataConfig, ModelConfig, TrainConfig
from graspbalance_tpu_torch.train.train_step import build_model, create_train_state, train_step
from graspbalance_tpu_torch.weights import load_flax_variables
from tiny import TINY_NUM_SEED, TINY_NUM_VIEW, TINY_QUALITY_SCENE, TINY_SCENE, TINY_STAGES

EVAL_TOL = 1e-5
# the vertical grasp frame: approach +z, closing +y (tests/test_quality.py)
ROT_DOWN = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], np.float32)
# tests/test_quality.py's production-proportioned radii for the compact scene
GATE_STAGES = tuple(
    (n, r, k, m, b, 2 * r, k2)
    for r, (n, _, k, m, b, _, k2) in zip((0.04, 0.10, 0.20, 0.30), TINY_STAGES)
)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one thread while this module runs, so that its sums run in
    one order on any host (see test_gate_machinery_runs_and_model_learns)
    and several test processes do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_scene(jscene) -> SceneConfig:
    return SceneConfig(**{f.name: getattr(jscene, f.name) for f in dataclasses.fields(SceneConfig)})


def _scene(seed=0, jscene=TINY_SCENE):
    b = j_make_batch(seed, 2, dataclasses.replace(jscene, analytic_labels=True, emit_label_tensors=False))
    return b, b["object_poses"][:, :, :, 3]


def _random_rotations(rng, shape):
    q, r = np.linalg.qr(rng.standard_normal(shape + (3, 3)))
    q *= np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., None, :]
    return q.astype(np.float32)


def _random_rows(seed, g=40):
    """Decode rows around a scene's objects: random frames (a third of them
    turned to approach from above), float-valued widths, depths, heights
    and centres near the object boxes, random scores; and a random keep
    mask."""
    rng = np.random.default_rng(seed)
    b, centers = _scene(seed)
    rows = np.zeros((2, g, 17), np.float32)
    rot = _random_rotations(rng, (2, g))
    down = rng.random((2, g)) < 1 / 3
    theta = rng.uniform(0, np.pi, int(down.sum()))  # a turn about the approach axis
    c, s = np.cos(theta), np.sin(theta)
    about_approach = np.zeros((theta.size, 3, 3))
    about_approach[:, 0, 0] = 1
    about_approach[:, 1, 1], about_approach[:, 1, 2], about_approach[:, 2, 1], about_approach[:, 2, 2] = c, -s, s, c
    rot[down] = (ROT_DOWN @ about_approach).astype(np.float32)
    rows[..., 0] = rng.random((2, g))
    rows[..., 1] = rng.uniform(0.0, 0.12, (2, g))
    rows[..., 2] = 0.02
    rows[..., 3] = rng.uniform(0.005, 0.045, (2, g))
    rows[..., 4:13] = rot.reshape(2, g, 9)
    slot = rng.integers(0, 3, (2, g))
    rows[..., 13:16] = np.take_along_axis(centers, slot[..., None], axis=1) + rng.normal(0, 0.03, (2, g, 3))
    rows[..., 16] = -1.0
    keep = rng.random((2, g)) < 0.7
    return rows, keep, (centers, b["obj_sizes"], b["obj_mask"])


def _grasps_at(centers_row, rot, width, depth, g=4):
    grasps = np.zeros((g, 17), np.float32)
    grasps[:, 4:13] = rot.reshape(-1)
    grasps[:, 13:16] = centers_row
    grasps[:, 1] = width
    grasps[:, 3] = depth
    return grasps


def _crafted(case):
    """tests/test_quality.py::TestQualityScorer's grasps: (grasps, keep)."""
    _, centers = _scene()
    if case == "perfect":
        return np.stack([_grasps_at(centers[i, 0], ROT_DOWN, 0.1, 0.01) for i in range(2)]), np.ones((2, 4), bool)
    if case == "garbage":
        bad = np.zeros((2, 4, 17), np.float32)
        bad[..., 4:13] = np.eye(3, dtype=np.float32).reshape(-1)
        bad[..., 13:16] = 5.0
        return bad, np.ones((2, 4), bool)
    if case == "zero_width":
        return np.stack([_grasps_at(centers[i, 0], ROT_DOWN, 0.0, 0.01) for i in range(2)]), np.ones((2, 4), bool)
    if case == "sideways":
        rot = np.eye(3, dtype=np.float32)
        return np.stack([_grasps_at(centers[i, 0], rot, 0.1, 0.01) for i in range(2)]), np.ones((2, 4), bool)
    if case == "none_kept":
        return np.stack([_grasps_at(centers[i, 0], ROT_DOWN, 0.1, 0.01) for i in range(2)]), np.zeros((2, 4), bool)
    raise ValueError(case)


CRAFTED = ("perfect", "garbage", "zero_width", "sideways", "none_kept")


@pytest.mark.parametrize("case", [f"random{s}" for s in range(3)] + list(CRAFTED))
def test_analytic_grasp_quality_matches_jax(case):
    b, centers = _scene()
    if case.startswith("random"):
        grasps, keep, geometry = _random_rows(int(case[6:]))
    else:
        (grasps, keep), geometry = _crafted(case), (centers, b["obj_sizes"], b["obj_mask"])
    for num_depths in (4, 3):
        want = jan.analytic_grasp_quality(grasps, keep, *geometry, num_depths=num_depths)
        got = an.analytic_grasp_quality(grasps, keep, *geometry, num_depths=num_depths)
        assert got == want, (num_depths, got, want)
    if case == "perfect":  # the crafted cases score as in tests/test_quality.py
        assert got["quality_mean"] > 0.7 and got["good_frac"] == 1.0 and got["on_object_frac"] == 1.0
    elif case in ("garbage", "sideways", "zero_width", "none_kept"):
        assert got["quality_mean"] == 0.0
    if case.startswith("random"):  # the rows span every outcome of the rule
        q = an._per_grasp_quality(grasps.reshape(-1, 17), geometry[0][0], geometry[1][0], geometry[2][0], 4)
        assert 0 < (q > 0).mean() < 1 and 0.0 < got["on_object_frac"] < 1.0


@pytest.mark.parametrize("seed", range(3))
def test_per_grasp_quality_matches_jax(seed):
    grasps, _, (centers, sizes, mask) = _random_rows(seed)
    for i in range(2):
        for num_depths in (4, 2):
            want = jan._per_grasp_quality(grasps[i], centers[i], sizes[i], mask[i], num_depths)
            got = an._per_grasp_quality(grasps[i], centers[i], sizes[i], mask[i], num_depths)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


def _ap_ranking_grasps(centers, good_first):
    g = np.zeros((8, 17), np.float32)
    for j in range(8):
        good = j < 4 if good_first else j >= 4
        g[j, 4:13] = (ROT_DOWN if good else np.eye(3, dtype=np.float32)).reshape(-1)
        g[j, 13:16] = centers[0, 0] if good else 5.0
        g[j, 1] = 0.1
        g[j, 3] = 0.01
        g[j, 0] = 1.0 - j * 0.1
    return g[None], np.ones((1, 8), bool)


@pytest.mark.parametrize("case", ["random0", "random1", "good_first", "bad_first", "capped", "empty"])
def test_average_precision_matches_jax(case):
    assert an.AP_TOP_K == jan.AP_TOP_K and an.AP_QUALITY_THRESHOLDS == jan.AP_QUALITY_THRESHOLDS
    b, centers = _scene()
    geometry = (centers[:1], b["obj_sizes"][:1], b["obj_mask"][:1])
    if case.startswith("random"):
        grasps, keep, geometry = _random_rows(10 + int(case[6:]), g=80)  # more rows than AP_TOP_K
    elif case in ("good_first", "bad_first"):
        grasps, keep = _ap_ranking_grasps(centers, case == "good_first")
    else:
        g = np.zeros((60, 17), np.float32)
        g[:, 0] = 1.0
        g[:, 1], g[:, 3] = 0.1, 0.01
        g[:, 4:13] = ROT_DOWN.reshape(-1)
        g[:, 13:16] = centers[0, 0]
        grasps, keep = g[None], np.full((1, 60), case == "capped")
    want = jan.analytic_average_precision(grasps, keep, *geometry)
    got = an.analytic_average_precision(grasps, keep, *geometry)
    assert got == want
    if case == "capped":
        assert got > 0.9
    elif case == "empty":
        assert got == 0.0
    elif case == "good_first":
        bad = an.analytic_average_precision(*_ap_ranking_grasps(centers, False), *geometry)
        assert got > bad > 0.0


@pytest.mark.parametrize("seed, jscene", [(0, TINY_QUALITY_SCENE), (7, TINY_QUALITY_SCENE),
                                          (3, dataclasses.replace(TINY_SCENE, analytic_labels=True,
                                                                  emit_label_tensors=False))])
def test_oracle_rows_match_jax(seed, jscene):
    batch = make_batch(seed, 2, _port_scene(jscene))
    jbatch = j_make_batch(seed, 2, jscene)
    for num_seed in (TINY_NUM_SEED, 64):
        want_g, want_v = jq.oracle_decode_rows(jbatch, num_seed=num_seed, num_depths=jscene.num_depths)
        got_g, got_v = quality.oracle_decode_rows(batch, num_seed=num_seed)
        assert got_g.dtype == np.float32 and got_g.shape == (2, num_seed, 17)
        np.testing.assert_array_equal(got_g, want_g)
        np.testing.assert_array_equal(got_v, want_v)
    assert got_v.any()


def test_oracle_quality_matches_jax():
    """At the gate's compact scenes: the keep masks of every batch, then
    the metrics of evaluate_oracle_quality, exactly."""
    from graspbalance_tpu.eval.pipeline import make_postprocess as j_make_postprocess

    jscene, seed0, n = TINY_QUALITY_SCENE, 20, 2
    postprocess = j_make_postprocess(0.05)
    for i in range(n):
        jbatch = j_make_batch(seed0 + i, 2, jscene)
        grasps, valid = jq.oracle_decode_rows(jbatch, num_seed=TINY_NUM_SEED)
        want = np.asarray(postprocess(jnp.asarray(grasps), jnp.asarray(valid),
                                      jnp.asarray(jbatch["point_clouds"][..., :3])))
        got_grasps, got = quality.oracle_keep(make_batch(seed0 + i, 2, _port_scene(jscene)), TINY_NUM_SEED,
                                              device="cpu")
        np.testing.assert_array_equal(got_grasps, grasps)
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < valid.sum()  # NMS and the collision filter drop some rows
    kw = dict(num_batches=n, batch_size=2, seed0=seed0, num_seed=TINY_NUM_SEED)
    want = jq.evaluate_oracle_quality(jscene, **kw)
    got = quality.evaluate_oracle_quality(_port_scene(jscene), device="cpu", **kw)
    assert got == want
    assert got["quality_mean"] > 0.9 and got["kept_per_scene"] > 0


@pytest.fixture(scope="module")
def gate_models():
    """The JAX gate model at tiny sizes and its flax initialisation, and
    the port's model with those variables bridged in."""
    jcfg = JConfig(model=JModelConfig(num_view=TINY_NUM_VIEW, num_seed=TINY_NUM_SEED, backbone_stages=GATE_STAGES),
                   data=JDataConfig(analytic_labels=True))
    jmodel, state = jts.create_train_state(jcfg, 10, j_make_batch(0, 2, TINY_QUALITY_SCENE))
    variables = jax.tree_util.tree_map(np.array, {"params": state.params, "batch_stats": state.batch_stats})
    cfg = Config(model=ModelConfig(num_view=TINY_NUM_VIEW, num_seed=TINY_NUM_SEED, backbone_stages=GATE_STAGES))
    return jmodel, variables, load_flax_variables(build_model(cfg, device="cpu"), variables)


def test_evaluate_quality_matches_jax(gate_models):
    jmodel, variables, model = gate_models
    jscene, seed0, n = TINY_QUALITY_SCENE, 30, 2
    jinfer = JGraspInference(jmodel, variables)
    infer = GraspInference(model, device="cpu")
    for i in range(n):
        cloud = j_make_batch(seed0 + i, 2, jscene)["point_clouds"]
        want_g, want_keep = jinfer(jnp.asarray(cloud))
        got_g, got_keep = infer(cloud)
        np.testing.assert_allclose(got_g, want_g, atol=EVAL_TOL, rtol=EVAL_TOL)
        differ = got_keep != np.asarray(want_keep)
        assert not differ.any(), f"batch {i}: keep masks differ at {np.argwhere(differ).tolist()}"
    kw = dict(num_batches=n, batch_size=2, seed0=seed0)
    want = jq.evaluate_quality(jmodel, variables, jscene, **kw)
    got = quality.evaluate_quality(model, _port_scene(jscene), device="cpu", **kw)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=EVAL_TOL, atol=1e-7, err_msg=key)
    assert got["kept_per_scene"] > 0


# held-out batches the gate-machinery twin scores its graspable head on
HELD_OUT_SEEDS = (500, 501, 502, 503)


def test_gate_machinery_runs_and_model_learns(gate_models):
    """The port's twin of tests/test_quality.py's CPU-scale closed loop:
    from the JAX test's own initial weights, train 100 steps on
    device-expanded analytic labels, score through GraspInference -> NMS
    -> collision -> the analytic rule, and hold the graspable head's
    held-out skill to the same bars (scored through the training step's
    batch-statistics forward: at B=2 the running statistics are noise, see
    the JAX test).

    The JAX test scores one held-out batch (seed 500); this twin averages
    the same metrics over HELD_OUT_SEEDS, and runs torch on one thread
    (``one_thread``). A hundred steps at this scale part from any other
    run of them by rounding, and the bars sit inside that spread: with
    torch on 1-2 threads against 4-8 (its sums in other orders), batch
    500's accuracy read 0.78 and 0.69 around the 0.7 bar, the mean over
    the four 0.758 and 0.742, the mean recall 0.43 and 0.25 around the 0.3
    bar; the JAX run itself reads, over the same four batches, accuracy
    0.72-0.75 (mean 0.734) and recall 0.25-0.57 (mean 0.343), so its own
    test passes on batch 500's 0.57. On one thread the port's run is the
    same on every host with the same instruction set."""
    cfg = Config(
        model=ModelConfig(num_view=TINY_NUM_VIEW, num_seed=TINY_NUM_SEED, backbone_stages=GATE_STAGES),
        data=DataConfig(analytic_labels=True),
        train=TrainConfig(max_epoch=1),
    )
    scene = _port_scene(TINY_QUALITY_SCENE)
    state = create_train_state(cfg, 100, make_batch(0, 2, scene), device="cpu")
    load_flax_variables(state.model, gate_models[1])
    eval_model = build_model(cfg, device="cpu")

    def q():
        eval_model.load_state_dict(state.model.state_dict())
        return quality.evaluate_quality(eval_model, scene, num_batches=1, batch_size=2, device="cpu")

    for v in q().values():
        assert np.isfinite(v)
    pool = [make_batch(1 + i, 2, scene) for i in range(2)]
    held = [make_batch(seed, 2, scene) for seed in HELD_OUT_SEEDS]

    def probe():
        """The training forward's metrics on the held-out batches, averaged,
        the state left as it was (parameters, statistics, optimizer)."""
        saved = ({k: v.clone() for k, v in state.model.state_dict().items()},
                 state.optimizer.state_dict(), state.scheduler.state_dict())
        metrics = []
        for batch in held:
            metrics.append({k: float(v) for k, v in train_step(state.model, state.optimizer, state.scheduler, batch,
                                                               0, cfg).items()})
            state.model.load_state_dict(saved[0])
            state.optimizer.load_state_dict(saved[1])
            state.scheduler.load_state_dict(saved[2])
        return {k: float(np.mean([m[k] for m in metrics])) for k in metrics[0]}

    acc_untrained = probe()["stage1_graspable_acc"]
    recalls = []
    for i in range(100):
        metrics = train_step(state.model, state.optimizer, state.scheduler, pool[i % 2], 0, cfg)
        recalls.append(float(metrics["stage1_graspable_recall"]))
    assert np.isfinite(float(metrics["loss/overall_loss"]))
    assert max(recalls) > 0.2, recalls[-10:]
    held_metrics = probe()
    acc_trained, recall_trained = held_metrics["stage1_graspable_acc"], held_metrics["stage1_graspable_recall"]
    assert acc_trained > 0.7, (acc_untrained, acc_trained)
    assert acc_trained > acc_untrained + 0.1, (acc_untrained, acc_trained)
    assert recall_trained > 0.3, recall_trained
    for v in q().values():
        assert np.isfinite(v)


def test_run_gate_record():
    """run_gate end to end at tiny sizes on the CPU, in both dtypes: the
    JAX tool's JSON keys and rounding, finite metrics."""
    model_cfg = ModelConfig(num_view=TINY_NUM_VIEW, num_seed=TINY_NUM_SEED, backbone_stages=GATE_STAGES)
    jscene = TINY_QUALITY_SCENE
    keys = {"config", "steps", "bs", "dtype", "train_wall_s", "first_loss", "last_loss", "untrained", "trained",
            "oracle", "trained_xdist_mild", "oracle_xdist_mild", "trained_xdist", "oracle_xdist", "gate_ratio",
            "quality_frac_of_oracle", "ap_frac_of_oracle"}
    for dtype in ("float32", "bfloat16"):
        lines = []
        out = quality_gate.run_gate(3, 2, dtype, eval_batches=1, num_points=jscene.num_points, log=lines.append,
                                    device="cpu", model_cfg=model_cfg)
        assert out.keys() == keys and out["dtype"] == dtype and out["steps"] == 3
        assert out["config"] == "quality_gate_synthetic" and len(lines) == 8
        for name in ("untrained", "trained", "oracle", "trained_xdist_mild", "trained_xdist"):
            assert out[name].keys() == {*quality.METRICS, "kept_per_scene", "ap_analytic"}
            assert all(np.isfinite(v) for v in out[name].values())
        for name in ("trained_xdist_mild", "trained_xdist"):
            assert all(round(v, 4) == v for v in out[name].values())
        assert round(out["first_loss"], 3) == out["first_loss"] and np.isfinite(out["gate_ratio"])
