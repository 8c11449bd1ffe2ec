"""The DSN's training on the port against the JAX package's, at the stage
table of the JAX closed-loop DSN test (tests/test_quality.py), 512-point
gate scenes, bs=2: one training step from a shared state, and the
train_seg CLI (the DSN gate's CPU twin: tests/test_torch_dsn_gate.py).

The JAX step is written as tools/dsn_quality_gate.py writes it (train-mode
apply with the batch_stats mutable, the labels, get_seg_loss, value_and_grad,
optax.adam at the cosine one-cycle rate); the port's is
train/seg_step.seg_train_step. The reference's BatchNorm sums its rows in
pairs (tests/test_torch_train.py's ``pairwise_bn_mean``, which explains
why), the port's as torch sums them.

Tolerances (one step, from the JAX init bridged by weights.py):
  - the loss and its three parts: 1e-4 relative;
  - every gradient: within GRAD_TOL of its tensor's largest |grad|, but
    those that are 0 in exact arithmetic (ZERO_GRADIENT), which must stay
    within ZERO_NOISE of the model's largest |grad| on both sides;
  - the BatchNorm running statistics after the step: 1e-5 x max(1,
    largest |statistic|);
  - the parameters after the Adam step: within 2 x lr + 1e-7 everywhere
    (Adam moves an element by lr whatever its gradient's size, so an
    element whose gradient is rounding noise may step the other way on each
    side), and within 1e-3 x lr + 2 ulp of the parameter where the JAX
    gradient is larger than FIRM x its tensor's largest |grad| (the step's
    sign is then the same on both sides, and the step is lr x g / (|g| +
    eps) on both; adding it rounds to the parameter's ulp);
  - train_seg: the checkpoint of each epoch restores the final state
    bit-equal.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graspbalance_tpu.data.synthetic import SceneConfig as JSceneConfig
from graspbalance_tpu.data.synthetic import make_batch as j_make_batch
from graspbalance_tpu.labels.seg_losses import get_seg_loss as j_get_seg_loss
from graspbalance_tpu.models.dsn import DSN as JDSN
from graspbalance_tpu.models.dsn import compute_center_offset_labels as j_offsets
import graspbalance_tpu_torch.models.dsn as dsn_module
from graspbalance_tpu_torch.cli import train_seg
from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
from graspbalance_tpu_torch.models.dsn import DSN
from graspbalance_tpu_torch.nn.layers import BatchNorm
from graspbalance_tpu_torch.train.checkpoints import CheckpointManager
from graspbalance_tpu_torch.train.seg_step import DSN_BN_MOMENTUM, init_dsn, make_seg_optimizer, seg_train_step
from graspbalance_tpu_torch.train.train_step import TrainState
from graspbalance_tpu_torch.weights import state_dict_from_flax
from test_torch_train import pairwise_bn_mean  # noqa: F401
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

STAGES = ((128, 0.1, 8, 32, 1), (64, 0.2, 8, 64, 1))  # tests/test_quality.py's DSN gate
MAX_OBJECTS, NUM_OBJECTS, BS, NUM_POINTS = 4, 3, 2, 512
STEPS = 300  # the schedule's length (the gate's)
LR = 1e-3
GRAD_TOL = 2e-4
FIRM = 1e-2
# parameters whose gradient is 0 in exact arithmetic: each attention's last
# bias (softmax over the neighbours ignores a constant), and the biases that
# shift a stage's output features by a per-channel constant, which the
# train-mode BatchNorm after the next dense layer removes (the last block of
# each stage, the projection); their gradients must stay within ZERO_NOISE of
# the model's largest |grad| on both sides
ZERO_GRADIENT = {f"backbone.block{i}_{j}.attn.attn2.bias" for i, s in enumerate(STAGES) for j in range(s[4])}
ZERO_GRADIENT |= {f"backbone.block{i}_{s[4] - 1}.mlp2.bias" for i, s in enumerate(STAGES)} | {"backbone.proj.bias"}
ZERO_NOISE = 1e-6
LOSS_KEYS = ("loss/fg_loss", "loss/center_loss", "loss/seg_loss")
# the gate's scene at these sizes (tools/dsn_quality_gate.py)
SCENE_KW = dict(num_points=NUM_POINTS, table_extent=0.15, object_scatter=0.12, num_objects=NUM_OBJECTS,
                max_objects=MAX_OBJECTS, analytic_labels=True, emit_label_tensors=False)
J_SCENE = JSceneConfig(**SCENE_KW)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _port_tree(variables):
    """A flax-layout tree as the port's state_dict keys (weights.py)."""
    return state_dict_from_flax(variables, DSN(STAGES))


@pytest.fixture(scope="module")
def jax_step(pairwise_bn_mean):
    """The JAX init at PRNGKey(0) on make_batch(0)'s clouds (the gate's),
    then one step of the gate's step function on make_batch(1): (initial
    variables, loss metrics, grads, new variables)."""
    model = JDSN(pt_stages=STAGES)
    cloud0 = jnp.asarray(j_make_batch(0, BS, J_SCENE)["point_clouds"][..., :3])
    variables = _np_tree(dict(jax.jit(lambda r, c: model.init(r, c, train=True))(jax.random.PRNGKey(0), cloud0)))
    tx = optax.adam(optax.cosine_onecycle_schedule(STEPS, LR, pct_start=0.3))

    @jax.jit
    def step(params, batch_stats, opt_state, cloud, instance):
        def loss_fn(p):
            out, mut = model.apply({"params": p, "batch_stats": batch_stats}, cloud, train=True,
                                   mutable=["batch_stats"])
            ep = {**out, "foreground_label": (instance > 0).astype(jnp.int32), "instance_label": instance,
                  "center_offset_label": j_offsets(cloud, instance, MAX_OBJECTS)}
            loss, metrics = j_get_seg_loss(ep, MAX_OBJECTS + 1)
            return loss, (metrics, mut["batch_stats"])

        (_, (metrics, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, metrics, grads

    b = j_make_batch(1, BS, J_SCENE)
    params, stats = variables["params"], variables["batch_stats"]
    new_params, new_stats, metrics, grads = step(
        params, stats, tx.init(params), jnp.asarray(b["point_clouds"][..., :3]),
        jnp.asarray(b["instance_label"].astype(np.int32)))
    new = {"params": _np_tree(new_params), "batch_stats": _np_tree(new_stats)}
    return variables, {k: float(v) for k, v in metrics.items()}, _np_tree(grads), new


@pytest.fixture(scope="module")
def port_step(jax_step):
    """The port's seg_train_step from the same variables on the same batch:
    (metrics, grads and parameters after the step, by state_dict key)."""
    model = DSN(STAGES)
    model.load_state_dict(_port_tree(jax_step[0]))
    optimizer, scheduler = make_seg_optimizer(model, STEPS, LR)
    b = make_batch(1, BS, SceneConfig(**SCENE_KW))
    metrics = seg_train_step(model, optimizer, scheduler, b["point_clouds"], b["instance_label"], MAX_OBJECTS)
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, grads, {k: v.numpy() for k, v in model.state_dict().items()}


def test_dsn_step_loss_matches_jax(jax_step, port_step):
    want, got = jax_step[1], port_step[0]
    assert set(got) == set(want) == set(LOSS_KEYS)
    for key in LOSS_KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)


def _grad_tree(jax_step):
    """The JAX gradients by the port's parameter keys."""
    tree = _port_tree({"params": jax_step[2], "batch_stats": jax_step[0]["batch_stats"]})
    return {k: v for k, v in tree.items() if "running" not in k}


def test_dsn_step_gradients_match_jax(jax_step, port_step):
    want = _grad_tree(jax_step)
    got = port_step[1]
    assert set(got) == set(want) and ZERO_GRADIENT <= set(got)
    model_max = max(float(np.abs(w.numpy()).max()) for w in want.values())
    errs = {}
    for key, g in got.items():
        w = want[key].numpy()
        if key in ZERO_GRADIENT:  # rounding noise on both sides
            assert max(float(np.abs(g).max()), float(np.abs(w).max())) <= ZERO_NOISE * model_max, key
            continue
        errs[key] = float(np.abs(g - w).max()) / float(np.abs(w).max())
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst], sorted(errs.values())[len(errs) // 2])


def test_dsn_step_batchnorm_statistics_match_jax(jax_step, port_step):
    want = _port_tree(jax_step[3])
    got = port_step[2]
    stats = [k for k in got if "running" in k]
    assert len(stats) == 2 * (3 + len(STAGES))  # embed, down{i}, fg1, off1
    for key in stats:
        w = want[key].numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[key], w, atol=1e-5 * scale, rtol=0, err_msg=key)
    # the step moved them at the DSN's momentum
    init = _port_tree(jax_step[0])
    key = "backbone.embed.bn.running_var"
    assert not np.allclose(got[key], init[key].numpy())
    assert all(m.momentum == DSN_BN_MOMENTUM for m in DSN(STAGES).modules() if isinstance(m, BatchNorm))


def test_dsn_step_parameters_match_jax(jax_step, port_step):
    """The Adam step at the schedule's first rate: equal where the gradient's
    sign is firm, and no further apart than two steps anywhere."""
    lr = float(optax.cosine_onecycle_schedule(STEPS, LR, pct_start=0.3)(0))
    before, after = _port_tree(jax_step[0]), _port_tree(jax_step[3])
    grads = _grad_tree(jax_step)
    got = port_step[2]
    firm_elements = 0
    for key, g in grads.items():
        w, p0 = after[key].numpy(), before[key].numpy()
        gn = g.numpy()
        np.testing.assert_allclose(got[key], w, atol=2 * lr + 1e-7, rtol=0, err_msg=key)
        if key in ZERO_GRADIENT:  # noise: either sign
            continue
        firm = np.abs(gn) > FIRM * np.abs(gn).max()
        firm_elements += int(firm.sum())
        np.testing.assert_allclose(got[key][firm], w[firm], atol=1e-3 * lr, rtol=2.0**-22, err_msg=key)
        # both moved by the step's rate where the sign is firm
        np.testing.assert_allclose(np.abs(w - p0)[firm], lr, rtol=1e-2, err_msg=key)
    assert firm_elements > 1000


def test_train_seg_cli_writes_checkpoints_that_restore(tmp_path, monkeypatch):
    """Two epochs x 2 steps on synthetic 512-point scenes (the DSN at the
    stage table above): a checkpoint an epoch, with its epoch count, each
    restoring into a fresh DSN and optimizer; the last one bit-equal to the
    run's final state."""
    monkeypatch.setattr(dsn_module, "DSN", functools.partial(DSN, pt_stages=STAGES))
    log_dir = str(tmp_path / "dsn")
    state = train_seg.main(["--device", "cpu", "--num_point", str(NUM_POINTS), "--max_epoch", "2",
                            "--synthetic_steps", "2", "--batch_size", "2", "--log_dir", log_dir])
    ckpt_dir = os.path.join(log_dir, "checkpoints")
    assert sorted(os.listdir(ckpt_dir)) == ["extra_2.json", "extra_4.json", "step_2.pt", "step_4.pt"]
    with open(os.path.join(ckpt_dir, "extra_4.json")) as f:
        assert json.load(f) == {"epoch": 2}
    assert state.step == 4 and state.scheduler.last_epoch == 4
    for step in (2, 4):
        fresh = init_dsn(DSN(STAGES), 1)
        restored, extra = CheckpointManager(ckpt_dir).restore(TrainState(fresh, *make_seg_optimizer(fresh, 4)), step)
        assert extra == {"epoch": step // 2} and restored.step == step
        assert restored.scheduler.last_epoch == step
        same = all(torch.equal(a, b) for a, b in zip(restored.model.state_dict().values(),
                                                     state.model.state_dict().values()))
        assert same is (step == 4)
    moments = restored.optimizer.state_dict()["state"]
    final = state.optimizer.state_dict()["state"]
    assert all(torch.equal(moments[i]["exp_avg"], final[i]["exp_avg"]) for i in final)


def test_seg_train_step_runs_the_scenes_of_the_default_cli():
    """seg_train_step on a train_seg-style synthetic batch (default scene,
    labels up to max_objects = 16): finite loss parts, every parameter
    with a gradient."""
    model = init_dsn(DSN(STAGES), 0)
    optimizer, scheduler = make_seg_optimizer(model, 10)
    b = make_batch(0, 2, dataclasses.replace(SceneConfig(num_points=NUM_POINTS), num_views=4))
    metrics = seg_train_step(model, optimizer, scheduler, b["point_clouds"], b["instance_label"], 16)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in model.parameters())

