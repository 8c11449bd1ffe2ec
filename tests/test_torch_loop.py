"""The port's training loop (train/loop.py, with its checkpoints and
metric streams) against the JAX package's train(). The config tree, the
schedule and the CLI: tests/test_torch_config_cli.py; the eval step:
tests/test_torch_eval_step.py; the twins of tests/test_train.py's loop
tests, on the port alone: tests/test_torch_loop_resume.py.

Both run 2 epochs x 2 steps at log_every=1 and a peak learning rate of 1e-4
(LOOP_LR, see there), on tests/test_torch_train.py's stage table and scene,
with the reference's BatchNorm summing its rows in pairs (pairwise_bn_mean;
without it the reference's own f32 error put step 3 2.6e-4 apart). The port
starts from the JAX run's initialisation, bridged in with weights.py, and
starts its epoch 1 from the JAX run's state at the end of epoch 0
(parameters, BatchNorm statistics, Adam moments; the step counts are
checked equal, the schedule stays the port's own), so that no comparison
spans more than one epoch's steps. The reason: the reference's gradient is
not defined closer than its own rounding here. At the JAX state after step
1, moving every parameter by one float32 ulp moves step 2's gradient,
computed in float64, as far as the port's float32 gradient lies from the
JAX one (median 5e-3 of a tensor's largest entry, 4% for
backbone.fp2.mlp.layer0.bn.bias), so a run that steps on from there goes
where the host's rounding sends it, and Adam carries the difference into
every later step. Epoch 1 still crosses the epoch boundary: the per-epoch
BatchNorm momentum, the schedule's position and the resumed stream.

Tolerances: each step's logged loss within 1e-4 relative; the final
BatchNorm running statistics (which the per-epoch momentum sets) within
1e-4 x max(1, largest |statistic|); each parameter's change over epoch 1
(final minus the JAX state the port's epoch 1 starts from) within
DELTA_RTOL of the JAX run's change, as a norm per tensor, and for the
biases of ZERO_GRADIENT the norm of the change within
ZERO_GRADIENT_NORM_RTOL of the JAX run's; the checkpoint steps, the
sidecars and best.json's step equal, its loss within 1e-4 relative; the
config.json records equal on the shared fields.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from jax.sharding import NamedSharding, PartitionSpec

import graspbalance_tpu.nn.layers as j_layers
import graspbalance_tpu.train.loop as j_loop
from graspbalance_tpu.data.synthetic import make_batch as j_make_batch
from graspbalance_tpu.parallel.mesh import make_mesh
from graspbalance_tpu.train.config import TrainConfig as JTrainConfig
from graspbalance_tpu.train.train_step import create_train_state as j_create_train_state
from graspbalance_tpu.train.train_step import make_train_step as j_make_train_step
import graspbalance_tpu_torch.train.loop as loop
from graspbalance_tpu_torch.data.synthetic import make_batch
from graspbalance_tpu_torch.train.config import TrainConfig
from graspbalance_tpu_torch.train.train_step import create_train_state
from graspbalance_tpu_torch.weights import load_flax_variables, state_dict_from_flax
from test_torch_train import CFG, J_SCENE, JCFG, SCENE
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

TOL = 1e-4
# the loop comparison's peak learning rate: Adam moves every element by up
# to its learning rate whatever its gradient's size, so an element whose
# gradient is rounding noise may step the other way on each side and the
# runs drift apart within an epoch too: at the default 1e-3 step 4 was 5e-4
# relative apart, at 1e-4 the four losses stay within ~1.3e-6 with epoch 1
# started from the JAX state
LOOP_LR = 1e-4
# each parameter's change over epoch 1, as a norm, against the JAX run's
# change: the elements whose gradient is rounding noise and step the other
# way on each side stay a small share of a tensor
DELTA_RTOL = 1e-2
# biases whose gradient is 0 in exact arithmetic, as a train-mode BatchNorm
# downstream removes any per-channel shift they make: Adam moves every
# element by about its rate in the direction of its rounding noise, so each
# side's change has the same size but not the same direction; the norms are
# held to each other (0.95-1.03 here)
ZERO_GRADIENT = {"fuse_multi_scale.bias", *(f"width_grouping.mlp_scale{i}.layer2.bn.bias" for i in range(4))}
ZERO_GRADIENT_NORM_RTOL = 0.1
LOSS = "loss/overall_loss"


def _pairwise_mean(x, axis):
    """jnp.mean over every axis but the last, the rows added in pairs: zero
    rows pad them to a power of two, then each level adds neighbours. An
    optimization barrier keeps XLA from merging the levels back into one
    sequential reduction; the levels compile far faster than the strided
    slices of tests/test_torch_train.py's version."""
    assert tuple(axis) == tuple(range(x.ndim - 1)), axis
    rows = x.reshape(-1, x.shape[-1])
    n = rows.shape[0]
    padded = 1 << max(n - 1, 0).bit_length()
    if padded != n:
        rows = jnp.concatenate([rows, jnp.zeros((padded - n, rows.shape[1]), rows.dtype)])
    while rows.shape[0] > 1:
        rows = jax.lax.optimization_barrier(rows.reshape(-1, 2, rows.shape[1]).sum(axis=1))
    return rows[0] / n


class _PairwiseMeanNumpy:
    """jax.numpy, but with ``_pairwise_mean`` as its mean."""

    mean = staticmethod(_pairwise_mean)

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(scope="module")
def pairwise_bn_mean():
    """The reference's BatchNorm sums its rows in pairs while this module's
    JAX runs trace (the reason: tests/test_torch_train.py's docstring);
    restored afterwards."""
    saved = j_layers.jnp
    j_layers.jnp = _PairwiseMeanNumpy()
    try:
        yield
    finally:
        j_layers.jnp = saved


def _shared(port: dict, jax_: dict) -> None:
    """Every field of the port's config dict equals the JAX one's."""
    for section, fields in port.items():
        for name, value in fields.items():
            assert jax_[section][name] == value, (section, name)


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _ckpt_steps(directory):
    """Checkpoint steps of a directory of either package (orbax: a folder
    per step; the port: step_{step}.pt)."""
    names = os.listdir(directory)
    return sorted(int(n) for n in names if n.isdigit()) or sorted(
        int(n[5:-3]) for n in names if n.startswith("step_") and n.endswith(".pt"))


def _numpy_state(state) -> dict:
    return jax.tree_util.tree_map(
        np.array, {"params": state.params, "batch_stats": state.batch_stats, "opt_state": state.opt_state})


def _load_jax_state(state, jstate: dict) -> None:
    """Set the port's TrainState to the JAX run's: parameters, BatchNorm
    statistics and Adam moments (the reference runs Adam on the flattened
    parameters, opt_flatten); the step counts must already agree."""
    adam = jstate["opt_state"][0]
    assert state.step == int(adam.count), (state.step, int(adam.count))
    variables = {"params": jstate["params"], "batch_stats": jstate["batch_stats"]}
    load_flax_variables(state.model, variables)
    _, unflatten = ravel_pytree(jstate["params"])
    mu, nu = (state_dict_from_flax({"params": jax.tree_util.tree_map(np.array, unflatten(m)),
                                     "batch_stats": jstate["batch_stats"]}, state.model)
              for m in (adam.mu, adam.nu))
    for name, p in state.model.named_parameters():
        st = state.optimizer.state[p]
        assert int(st["step"]) == int(adam.count), name
        st["exp_avg"].copy_(mu[name])
        st["exp_avg_sq"].copy_(nu[name])


@pytest.fixture(scope="module")
def loop_runs(pairwise_bn_mean, tmp_path_factory):
    """2 epochs x 2 steps of the JAX package's train() and of the port's,
    the port starting from the JAX run's initial variables (taken as its
    create_train_state returns them) and its epoch 1 from the JAX run's
    state at the end of epoch 0 (set when the loop asks for epoch 1's
    batches, after epoch 0's checkpoint); returns the two log directories,
    the JAX run's state at the end of epoch 0 and its final variables under
    the port's keys, and the port's final TrainState."""
    root = tmp_path_factory.mktemp("loops")
    steps = 2
    initial, epoch0_end = {}, {}

    def capture_init(*args, **kwargs):
        jmodel, state = j_create_train_state(*args, **kwargs)
        initial.update(jax.tree_util.tree_map(np.array, {"params": state.params, "batch_stats": state.batch_stats}))
        # placed on the loop's mesh as the step's outputs are, so that the
        # step compiles once (the same values; unplaced, step 2 compiles again)
        return jmodel, jax.device_put(state, NamedSharding(make_mesh(1), PartitionSpec()))

    def capture_epoch0_end(*args, **kwargs):
        step_fn = j_make_train_step(*args, **kwargs)

        def step(state, batch, epoch):
            state, metrics = step_fn(state, batch, epoch)
            if int(state.step) == steps:
                epoch0_end.update(_numpy_state(state))
            return state, metrics

        return step

    def batches(epoch):
        for i in range(steps):
            yield j_make_batch(epoch * steps + i, 2, J_SCENE)

    train = dict(max_epoch=2, log_every=1, learning_rate=LOOP_LR, n_data_shards=1)
    j_loop.create_train_state, j_loop.make_train_step = capture_init, capture_epoch0_end
    try:
        jstate = j_loop.train(dataclasses.replace(JCFG, train=JTrainConfig(log_dir=str(root / "jax"), **train)),
                              batches, steps_per_epoch=steps)
    finally:
        j_loop.create_train_state, j_loop.make_train_step = j_create_train_state, j_make_train_step

    port_states = []

    def from_jax_init(*args, **kwargs):
        state = create_train_state(*args, **kwargs)
        load_flax_variables(state.model, initial)
        port_states.append(state)
        return state

    def port_batches(epoch):
        if epoch == 1:
            _load_jax_state(port_states[0], epoch0_end)
        return (make_batch(epoch * steps + i, 2, SCENE) for i in range(steps))

    loop.create_train_state = from_jax_init
    try:
        state = loop.train(dataclasses.replace(CFG, train=TrainConfig(log_dir=str(root / "port"), **train)),
                           port_batches, steps_per_epoch=steps, device="cpu")
    finally:
        loop.create_train_state = create_train_state
    assert port_states == [state]
    want = state_dict_from_flax(
        jax.tree_util.tree_map(np.array, {"params": jstate.params, "batch_stats": jstate.batch_stats}), state.model)
    start = state_dict_from_flax({"params": epoch0_end["params"], "batch_stats": epoch0_end["batch_stats"]},
                                 state.model)
    return root / "jax", root / "port", start, want, state


def test_loop_losses_match_jax_train(loop_runs):
    jdir, pdir = loop_runs[:2]
    want = [(r["step"], r[LOSS]) for r in _jsonl(jdir / "train_metrics.jsonl")]
    got = [(r["step"], r[LOSS]) for r in _jsonl(pdir / "train_metrics.jsonl")]
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=TOL)


def test_loop_final_state_matches_jax_train(loop_runs):
    """The BatchNorm statistics the per-epoch momentum left, and the
    change Adam made to each parameter over epoch 1."""
    start, want, state = loop_runs[2:]
    assert state.step == 4
    got = state.model.state_dict()
    assert got.keys() == want.keys() == start.keys()
    for name, t in got.items():
        g, w = t.numpy(), want[name].numpy()
        if "running" in name:
            tol = TOL * max(1.0, float(np.abs(w).max()))
            err = float(np.abs(g - w).max())
            assert err <= tol, f"{name}: {err:.3g} > {tol:.3g}"
            continue
        size = float(np.linalg.norm(w - start[name].numpy()))
        assert size > 0, f"{name} did not move in the JAX run"
        if name in ZERO_GRADIENT:
            ratio = float(np.linalg.norm(g - start[name].numpy())) / size
            assert abs(ratio - 1) <= ZERO_GRADIENT_NORM_RTOL, f"{name}: |change| / |JAX's| = {ratio:.3g}"
            continue
        err = float(np.linalg.norm(g - w))
        assert err <= DELTA_RTOL * size, f"{name}: |change - JAX's| {err:.3g} > {DELTA_RTOL} x |JAX's| {size:.3g}"


def test_loop_checkpoints_match_jax_train(loop_runs):
    jdir, pdir = loop_runs[:2]
    jc, pc = jdir / "checkpoints", pdir / "checkpoints"
    assert _ckpt_steps(pc) == _ckpt_steps(jc) == [2, 4]
    assert _ckpt_steps(pc / "best") == _ckpt_steps(jc / "best")
    want, got = (json.loads((d / "best.json").read_text()) for d in (jc, pc))
    assert got["step"] == want["step"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
    for step in (2, 4):
        assert json.loads((pc / f"extra_{step}.json").read_text()) == json.loads((jc / f"extra_{step}.json").read_text())
    want_cfg, got_cfg = (json.loads((d / "config.json").read_text()) for d in (jc, pc))
    want_cfg["train"]["log_dir"] = got_cfg["train"]["log_dir"]
    _shared(got_cfg, want_cfg)
    # the checkpoint loads without unpickling code
    payload = torch.load(pc / "step_4.pt", weights_only=True)
    assert payload["step"] == 4 and {"model", "optimizer", "scheduler"} <= payload.keys()


def test_loop_streams(loop_runs):
    pdir = loop_runs[1]
    records = _jsonl(pdir / "loop_metrics.jsonl")
    assert [r["loop/epoch"] for r in records] == [0, 1]
    for r in records:
        assert r["loop/ms_per_step"] > 0 and 0 <= r["loop/prefetch_wait_share"] <= 1
        assert r["loop/checkpoint_bytes"] > 0 and r["loop/uploads/point_clouds"] == 2
    for r in _jsonl(pdir / "train_metrics.jsonl"):  # on the host the step's time is its dispatch
        assert r["time/step_ms"] == pytest.approx(r["time/dispatch_ms"]) and r["time/step_ms"] > 0
    assert "step 4:" in (pdir / "log_train.txt").read_text()


# --- the CLI ---------------------------------------------------------------
