"""The port's bfloat16 compute dtypes (ModelConfig.dtype, width_mlp_dtype)
against the JAX package's in bfloat16, on tests/test_torch_train.py's tiny
stage table, scene and flax initialisation (bridged with weights.py).

Both sides cast where the JAX modules cast: each Dense computes in bfloat16
on its float32 parameters cast at the call, each BatchNorm takes float32
batch statistics and normalises in bfloat16, the heads return float32, and
label matching, the loss and Adam run in float32.

The JAX side is compiled with XLA's ``xla_allow_excess_precision`` off, so
that it rounds every op's output to bfloat16 as torch does. With it on (the
default) XLA's CPU backend keeps float32 inside its fusions, and on this
tiny stage table bfloat16 rounding alone moves the deepest features by a
third (the JAX bfloat16 forward against its float32 one: sa4_features 0.34
of their largest value, the heads 0.83), so a comparison with the default
build would measure XLA's fusion choices, not the port. So compiled, the
two backbones agree bit for bit on these inputs (sa1-sa4, fp2, objectness
and view scores); the width head differs by bfloat16 rounding: its
gripper-frame coordinates, computed in float32 by einsums that round
differently, are cast to bfloat16, where one ulp of float32 can cross a
bfloat16 rounding boundary.

The gradients are compared against the JAX package's default gather
backward ('xla'), a scatter-add in the cotangent's dtype (bfloat16); the
port sums the cotangent in float32 (ops/gather.py, as the JAX package's
kernel path does). That difference is bfloat16 rounding of a sum too, and
the cosine bound below covers it.

Tolerances (measured on the CPU, the worst seen in brackets):
  - the train-mode forward: objectness and view scores within FWD_TOL of
    each tensor's largest |value| [0: equal]; the stage-2 head outputs
    within FWD_TOL on the seeds whose top view is the same on both sides
    [9.7e-3], a seed's top view differing only where the JAX view scores'
    top-2 margin is below twice the largest view-score gap (a near tie),
    and on at most a quarter of the seeds [none differ];
  - one training step from the same state: the loss within LOSS_RTOL
    relative [5.3e-4]; each parameter's gradient at cosine >= GRAD_COS to
    the JAX one [0.914, the width MLPs' first BatchNorm offsets, which sum
    the width head's bfloat16 differences], their median >= GRAD_COS_MEDIAN
    [0.9986], except the biases of ZERO_GRADIENT, whose gradient is 0 in
    exact arithmetic (a train-mode BatchNorm follows them) and holds
    rounding noise on both sides;
  - after the step: parameters, BatchNorm statistics and Adam's moments
    float32 on both sides;
  - width_mlp_dtype='bfloat16' with dtype='float32': finite float32 head
    outputs, and in eval mode the width head runs its MLPs as layers (the
    fused width MLP is float32 only; tests/test_model.py's twin);
  - a bfloat16 run's config.json records the dtype, and a run stopped after
    epoch 1 and resumed ends bit-equal to the run straight through;
  - the gathers' backward on a bfloat16 cotangent equals the float32 sums
    rounded once, exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspbalance_tpu.data.synthetic import make_batch as j_make_batch
from graspbalance_tpu.labels.losses import get_loss as j_get_loss
from graspbalance_tpu.nn.layers import bn_momentum_schedule as j_bn_momentum_schedule
from graspbalance_tpu.train import train_step as jts
import graspbalance_tpu_torch.models.heads as heads
import graspbalance_tpu_torch.train.loop as loop
from graspbalance_tpu_torch.data.synthetic import make_batch
from graspbalance_tpu_torch.train.checkpoints import load_config
from graspbalance_tpu_torch.nn.layers import bn_momentum_schedule
from graspbalance_tpu_torch.train.config import TrainConfig
from graspbalance_tpu_torch.train.train_step import (
    build_model,
    make_optimizer,
    set_bn_momentum,
    to_device,
    train_step,
)
from graspbalance_tpu_torch.weights import load_flax_variables, state_dict_from_flax
from test_torch_loop import ZERO_GRADIENT
from test_torch_train import CFG, J_SCENE, JCFG, SCENE

FWD_TOL = 2e-2
LOSS_RTOL = 5e-3
GRAD_COS = 0.8
GRAD_COS_MEDIAN = 0.99
EPOCH = 0
HEAD_KEYS = ("grasp_score_pred", "grasp_angle_cls_pred", "grasp_width_pred", "grasp_tolerance_pred")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one thread while this module runs: its sums in one order on
    any host, and several test processes do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(cfg, **kw):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype="bfloat16", **kw))


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32) if np.asarray(x).dtype != np.int32
                                  else np.asarray(x), tree)


@pytest.fixture(scope="module")
def runs():
    """The JAX bfloat16 model's train-mode forward, loss and gradients, and
    the port's forward and one train_step, from the same flax
    initialisation on the same batch."""
    jcfg = _bf16(JCFG)
    jmodel, state = jts.create_train_state(jcfg, 10, j_make_batch(0, 2, J_SCENE))
    variables = jax.tree_util.tree_map(np.array, {"params": state.params, "batch_stats": state.batch_stats})
    jbatch = {k: jnp.asarray(v) for k, v in j_make_batch(0, 2, J_SCENE).items()}
    momentum = j_bn_momentum_schedule(EPOCH)

    def loss_fn(params, stats, b):
        ep, mutated = jmodel.apply({"params": params, "batch_stats": stats}, b, train=True, bn_momentum=momentum,
                                   mutable=["batch_stats"])
        ep["objectness_label"] = b["objectness_label"]
        loss, _ = j_get_loss(ep)
        return loss, ep

    args = (variables["params"], variables["batch_stats"], jbatch)
    # every op rounded to bfloat16, as torch rounds (see the module docstring)
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(*args).compile(
        {"xla_allow_excess_precision": False})
    (jloss, jep), jgrads = step(*args)
    jep = {k: np.asarray(v) for k, v in jep.items() if v is not None}
    jstate, _ = jts.make_train_step(jmodel, jcfg)(state, jbatch, jnp.int32(EPOCH))

    cfg = _bf16(CFG)
    model = load_flax_variables(build_model(cfg, device="cpu"), variables)
    batch = to_device(make_batch(0, 2, SCENE), "cpu")
    set_bn_momentum(model, bn_momentum_schedule(EPOCH))
    model.train()
    with torch.no_grad():
        ep = model.forward_train({k: v for k, v in batch.items()})
    model = load_flax_variables(build_model(cfg, device="cpu"), variables)
    optimizer, scheduler = make_optimizer(model, cfg, 10)
    metrics = train_step(model, optimizer, scheduler, batch, EPOCH, cfg)
    grads = state_dict_from_flax({"params": _np(jgrads), "batch_stats": variables["batch_stats"]}, model)
    return dict(jep=jep, jloss=float(jloss), jgrads=grads, jstate=jstate, ep=ep, loss=float(metrics["loss/overall_loss"]),
                model=model, optimizer=optimizer)


def _margin(x, axis=-1):
    top2 = -np.sort(-x, axis=axis)
    return np.take(top2, 0, axis=axis) - np.take(top2, 1, axis=axis)


def test_bf16_train_forward_matches_jax(runs):
    jep = runs["jep"]
    ep = {k: (v.float() if v.is_floating_point() else v).numpy() for k, v in runs["ep"].items() if v is not None}
    for key in ("objectness_score", "view_score", *HEAD_KEYS):
        assert ep[key].dtype == jep[key].dtype == np.float32, key
    for key in ("objectness_score", "view_score"):
        scale = float(np.abs(jep[key]).max())
        err = float(np.abs(ep[key] - jep[key]).max())
        assert err <= FWD_TOL * scale, f"{key}: {err:.3g} > {FWD_TOL} x {scale:.3g}"
    gap = float(np.abs(ep["view_score"] - jep["view_score"]).max())
    same = ep["grasp_top_view_inds"] == jep["grasp_top_view_inds"]
    assert (_margin(jep["view_score"])[~same] <= 2 * gap).all(), "a top view differs away from a near tie"
    assert same.mean() >= 0.75, f"{int((~same).sum())} of {same.size} top views differ"
    for key in HEAD_KEYS:
        scale = float(np.abs(jep[key]).max())
        err = float(np.abs(ep[key][same] - jep[key][same]).max())
        assert err <= FWD_TOL * scale, f"{key}: {err:.3g} > {FWD_TOL} x {scale:.3g} on matching seeds"
        assert np.isfinite(ep[key]).all(), key


def test_bf16_step_matches_jax(runs):
    np.testing.assert_allclose(runs["loss"], runs["jloss"], rtol=LOSS_RTOL)
    model, want = runs["model"], runs["jgrads"]
    cosines = []
    for name, p in model.named_parameters():
        if name in ZERO_GRADIENT:
            continue
        g, w = p.grad.double().numpy().ravel(), want[name].double().numpy().ravel()
        cos = float(g @ w / max(np.linalg.norm(g) * np.linalg.norm(w), 1e-30))
        assert cos >= GRAD_COS, f"{name}: cosine {cos:.4f} < {GRAD_COS}"
        cosines.append(cos)
    assert len(cosines) == len(list(model.parameters())) - len(ZERO_GRADIENT)
    assert np.median(cosines) >= GRAD_COS_MEDIAN, np.median(cosines)


def test_bf16_state_stays_float32(runs):
    model, optimizer, jstate = runs["model"], runs["optimizer"], runs["jstate"]
    assert {t.dtype for t in model.state_dict().values()} == {torch.float32}
    for p in model.parameters():
        st = optimizer.state[p]
        assert p.grad.dtype == st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    leaves = jax.tree_util.tree_leaves((jstate.params, jstate.batch_stats, jstate.opt_state))
    assert {x.dtype for x in leaves if jnp.issubdtype(x.dtype, jnp.floating)} == {jnp.dtype(jnp.float32)}


def test_bf16_width_mlp_with_float32_model(monkeypatch):
    """width_mlp_dtype='bfloat16', dtype='float32': finite float32 heads in
    both modes; in eval mode the width head runs its MLPs as layers, not the
    float32 fused width MLP."""
    cfg = dataclasses.replace(CFG, model=dataclasses.replace(CFG.model, width_mlp_dtype="bfloat16"))
    model = build_model(cfg, device="cpu")
    assert model.width_grouping.dtype == torch.bfloat16 and model.grasp_params.conv1.dense.dtype == torch.float32

    def refuse(*a, **k):
        raise AssertionError("the fused width MLP ran on a bfloat16 head")

    monkeypatch.setattr(heads, "width_mlp_fused_rot_plain", refuse)
    monkeypatch.setattr(heads, "width_mlp_fused_rot", refuse)
    batch = to_device(make_batch(0, 2, SCENE), "cpu")
    with torch.no_grad():
        ep = model.eval()(batch["point_clouds"])
        ep_train = model.train().forward_train(batch)
    for out in (ep, ep_train):
        for key in HEAD_KEYS:
            assert out[key].dtype == torch.float32 and bool(torch.isfinite(out[key]).all()), key


def test_bf16_config_round_trips_and_resumes(tmp_path):
    """A bfloat16 run's config.json records its dtype; stopped after epoch
    1 and resumed, it ends bit-equal to the same run straight through."""
    steps = 2
    cfg = _bf16(CFG)

    def batches(epoch):
        return (make_batch(epoch * steps + i, 2, SCENE) for i in range(steps))

    def run(log_dir, **kw):
        c = dataclasses.replace(cfg, train=TrainConfig(max_epoch=2, log_every=1, log_dir=str(log_dir), **kw))
        return loop.train(c, batches, steps_per_epoch=steps, device="cpu")

    straight = run(tmp_path / "straight")
    run(tmp_path / "resumed", stop_after_epochs=1)
    stored = load_config(str(tmp_path / "resumed" / "checkpoints"))
    assert stored.model.dtype == "bfloat16" and stored.model == cfg.model
    resumed = run(tmp_path / "resumed")
    assert resumed.step == straight.step == 2 * steps
    want = straight.model.state_dict()
    for name, t in resumed.model.state_dict().items():
        assert t.dtype == torch.float32
        assert torch.equal(t, want[name]), name


def test_gather_backward_sums_bf16_in_float32():
    """The gathers' backward on a bfloat16 cotangent: summed in float32 (the
    plain version, as the kernel does on the card) and rounded to the
    points' dtype once: equal to the float32 sums rounded (the rows here
    repeat each destination ~256 times)."""
    from graspbalance_tpu_torch.ops.gather import group_points

    gen = torch.Generator().manual_seed(0)
    points = torch.randn(2, 16, 8, generator=gen).to(torch.bfloat16).requires_grad_()
    idx = torch.randint(0, 4, (2, 32, 32), generator=gen)  # 1,024 rows onto 4 destinations
    ct = torch.randn(2, 32, 32, 8, generator=gen).to(torch.bfloat16)
    group_points(points, idx).backward(ct)
    want = torch.zeros(2, 16, 8)
    for b in range(2):
        want[b].index_add_(0, idx[b].reshape(-1), ct[b].reshape(-1, 8).float())
    assert points.grad.dtype == torch.bfloat16
    assert torch.equal(points.grad, want.to(torch.bfloat16))
