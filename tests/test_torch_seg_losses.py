"""The DSN's training pieces that hold no model, against the JAX package's:
the seven functions of labels/seg_losses.py, models/dsn.py's
compute_center_offset_labels, eval/seg_quality.py and the learning-rate
schedule of the DSN's training (optax's cosine_onecycle_schedule).

Tolerances:
  - the seg losses: 1e-5 relative (the same formulas in float32; the sums
    over points run in another order), on float-valued and integer-valued
    inputs, with ignore_zero, an empty item, items whose labels are all
    background, labels absent from an item and labels past num_classes;
    the weights themselves exactly;
  - the offset labels: 1e-6 absolute (the centroid sums run in another
    order), the background exactly 0, labels past max_objects as the JAX
    package treats them;
  - seg_quality: equal, key for key (the same numpy code);
  - the schedule: optax's rates within 1e-6 relative at every step and past
    the end (optax evaluates cos in XLA's float32, the port in numpy's; at
    small T every rate is bit-equal), read from the optimizer as the
    training step sees them; schedules optax makes NaN (T < 4) refused.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graspbalance_tpu.eval.seg_quality import seg_quality as j_seg_quality
from graspbalance_tpu.labels import seg_losses as jl
from graspbalance_tpu.models.dsn import compute_center_offset_labels as j_offsets
from graspbalance_tpu_torch.eval.seg_quality import seg_quality
from graspbalance_tpu_torch.labels import seg_losses as pl
from graspbalance_tpu_torch.models.dsn import compute_center_offset_labels
from graspbalance_tpu_torch.train.seg_step import CosineOneCycle, cosine_onecycle_rate, make_seg_optimizer
from graspbalance_tpu_torch.train.train_step import OneCycleLR
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _labels(rng, b, n, num_classes, kind):
    """(b, n) int32 labels: every class drawn; one item missing class 1 and
    its last class; one item all background; one with labels past
    num_classes (which fall in no bin)."""
    lab = rng.integers(0, num_classes, (b, n)).astype(np.int32)
    if kind == "absent":
        lab[0][(lab[0] == 1) | (lab[0] == num_classes - 1)] = 0
    elif kind == "background":
        lab[1] = 0
    elif kind == "overflow":
        lab[0, : n // 4] = num_classes + rng.integers(0, 3, n // 4)
    return lab


def _values(rng, shape, kind):
    if kind == "int":  # exact in any precision: hides nothing of the sums' order
        return rng.integers(-3, 4, shape).astype(np.float32)
    return (rng.standard_normal(shape) * 1.5).astype(np.float32)


LABEL_KINDS = ["plain", "absent", "background", "overflow"]


@pytest.mark.parametrize("kind", LABEL_KINDS + ["empty"])
@pytest.mark.parametrize("ignore_zero", [False, True])
def test_inverse_frequency_weights_match_jax(kind, ignore_zero):
    rng = np.random.default_rng(len(kind))
    lab = np.zeros((2, 0), np.int32) if kind == "empty" else _labels(rng, 3, 200, 5, kind)
    want = np.asarray(jl.inverse_frequency_weights(jnp.asarray(lab), 5, ignore_zero=ignore_zero))
    got = pl.inverse_frequency_weights(_t(lab), 5, ignore_zero=ignore_zero)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("values", ["float", "int"])
@pytest.mark.parametrize("kind", LABEL_KINDS)
def test_ce_loss_weighted_matches_jax(values, kind):
    rng = np.random.default_rng(11)
    for c in (2, 4):
        logits = _values(rng, (3, 300, c), values)
        target = _labels(rng, 3, 300, c, kind if kind != "overflow" else "plain")
        want = float(jl.ce_loss_weighted(jnp.asarray(logits), jnp.asarray(target), c))
        got = float(pl.ce_loss_weighted(_t(logits), _t(target), c))
        np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("values", ["float", "int"])
def test_smooth_l1_matches_jax(values):
    x = _values(np.random.default_rng(2), (4, 100, 3), values)
    x[0, :5, 0] = [1.0, -1.0, 0.999, -0.5, 0.0]  # both sides of the knee
    np.testing.assert_array_equal(pl.smooth_l1(_t(x)).numpy(), np.asarray(jl.smooth_l1(jnp.asarray(x))))


@pytest.mark.parametrize("values", ["float", "int"])
@pytest.mark.parametrize("kind", LABEL_KINDS)
def test_smooth_l1_loss_weighted_matches_jax(values, kind):
    rng = np.random.default_rng(3)
    pred, target = _values(rng, (3, 256, 3), values), _values(rng, (3, 256, 3), values)
    lab = _labels(rng, 3, 256, 6, kind)
    want = float(jl.smooth_l1_loss_weighted(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(lab), 6))
    got = float(pl.smooth_l1_loss_weighted(_t(pred), _t(target), _t(lab), 6))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("values", ["float", "int"])
def test_bce_with_logits_weighted_matches_jax(values):
    rng = np.random.default_rng(4)
    logits = _values(rng, (2, 300), values)
    target = (rng.random((2, 300)) < 0.3).astype(np.float32)
    target[1] = 0  # an item without a positive
    want = float(jl.bce_with_logits_weighted(jnp.asarray(logits), jnp.asarray(target)))
    got = float(pl.bce_with_logits_weighted(_t(logits), _t(target)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("values", ["float", "int"])
def test_cluster_loss_weighted_matches_jax(values):
    rng = np.random.default_rng(5)
    x1, x2 = _values(rng, (60, 8), values), _values(rng, (50, 8), values)
    y1, y2 = rng.integers(0, 4, 60).astype(np.int32), rng.integers(1, 5, 50).astype(np.int32)
    for delta in (0.5, 4.0):
        want = float(jl.cluster_loss_weighted(*map(jnp.asarray, (x1, y1, x2, y2)), delta, 5))
        got = float(pl.cluster_loss_weighted(*map(_t, (x1, y1, x2, y2)), delta, 5))
        np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("values", ["float", "int"])
@pytest.mark.parametrize("kind", LABEL_KINDS[:3])
def test_get_seg_loss_matches_jax(values, kind):
    rng = np.random.default_rng(6)
    inst = _labels(rng, 3, 400, 5, kind)
    ep = {
        "foreground_logits": _values(rng, (3, 400, 2), values),
        "center_offsets": _values(rng, (3, 400, 3), values) * 0.1,
        "center_offset_label": _values(rng, (3, 400, 3), values) * 0.1,
        "foreground_label": (inst > 0).astype(np.int32),
        "instance_label": inst,
    }
    want_loss, want = jl.get_seg_loss({k: jnp.asarray(v) for k, v in ep.items()}, 5)
    got_loss, got = pl.get_seg_loss({k: _t(v) for k, v in ep.items()}, 5)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=RTOL)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("kind", ["plain", "absent", "background", "overflow"])
def test_center_offset_labels_match_jax(kind):
    rng = np.random.default_rng(7)
    xyz = (rng.random((3, 500, 3)) * 0.6 - 0.3).astype(np.float32)
    xyz[..., 2] += 0.5  # metres from the camera
    inst = _labels(rng, 3, 500, 6, kind)
    want = np.asarray(j_offsets(jnp.asarray(xyz), jnp.asarray(inst), 5))
    got = compute_center_offset_labels(_t(xyz), _t(inst), 5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert not got[inst == 0].any() and not want[inst == 0].any()
    # each object's points plus their offsets meet at its centroid (item 2,
    # which no kind alters)
    obj = inst[2] == 2
    np.testing.assert_allclose(xyz[2][obj] + got[2][obj], np.tile(xyz[2][obj].mean(0), (obj.sum(), 1)), atol=1e-6)


def _seg_case(seed):
    rng = np.random.default_rng(seed)
    inst = rng.integers(0, 5, (3, 300)).astype(np.int32)
    fg = rng.standard_normal((3, 300, 2)).astype(np.float32)
    fg[..., 1] += np.where(inst > 0, 1.0, -1.0)  # mostly right
    labels = np.where(rng.random((3, 300)) < 0.8, inst, rng.integers(0, 7, (3, 300))).astype(np.int32)
    labels[2] = 0  # a scene without a cluster
    return fg, labels, inst


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seg_quality_equals_jax(seed):
    fg, labels, inst = _seg_case(seed)
    want = j_seg_quality(fg, labels, inst)
    got = seg_quality(fg, labels, inst)
    assert got == want and list(got) == list(want)


@pytest.mark.parametrize("total", [4, 5, 10, 37, 300, 500])
def test_seg_schedule_matches_optax(total):
    """The rate each step of the DSN's training uses: the optimizer's rate
    before each step against optax's schedule at that count, to 3 steps
    past the end."""
    lr = 1e-3
    want = optax.cosine_onecycle_schedule(total, lr, pct_start=0.3)
    model = torch.nn.Linear(3, 2)
    optimizer, scheduler = make_seg_optimizer(model, total, lr)
    assert isinstance(scheduler, CosineOneCycle)
    for step in range(total + 3):
        expected = float(want(jnp.int32(step)))
        np.testing.assert_allclose(optimizer.param_groups[0]["lr"], expected, rtol=1e-6, err_msg=str(step))
        model(torch.ones(1, 3)).sum().backward()
        optimizer.step()
        scheduler.step()
    # restores from its state_dict
    other, sched2 = make_seg_optimizer(torch.nn.Linear(3, 2), total, lr)
    sched2.load_state_dict(scheduler.state_dict())
    assert sched2.last_epoch == total + 3


def test_seg_schedule_is_not_torch_onecycle():
    """At T = 10 optax peaks at step 3, torch's OneCycleLR at step 2."""
    rates = [cosine_onecycle_rate(s, 10, 1e-3) for s in range(11)]
    np.testing.assert_allclose(rates[:4], [4e-5, 2.8e-4, 7.6e-4, 1e-3], rtol=1e-5)
    assert rates[10] == pytest.approx(4e-9, rel=1e-5)
    optimizer = torch.optim.Adam(torch.nn.Linear(3, 2).parameters(), lr=1e-3)
    sched = OneCycleLR(optimizer, max_lr=1e-3, total_steps=10, pct_start=0.3, div_factor=25.0,
                       final_div_factor=1e4, anneal_strategy="cos", cycle_momentum=False)
    torch_rates = []
    for _ in range(3):
        torch_rates.append(optimizer.param_groups[0]["lr"])
        optimizer.step()
        sched.step()
    np.testing.assert_allclose(torch_rates, [4e-5, 5.2e-4, 1e-3], rtol=1e-5)


@pytest.mark.parametrize("total", [1, 2, 3])
def test_seg_schedule_refuses_what_optax_makes_nan(total):
    assert np.isnan(float(optax.cosine_onecycle_schedule(total, 1e-3, pct_start=0.3)(jnp.int32(0))))
    with pytest.raises(ValueError, match="NaN"):
        make_seg_optimizer(torch.nn.Linear(3, 2), total)
