"""The port's training step against the JAX package's, at tiny widths
(tests/tiny.py: TINY_STAGES' sample counts and MLP widths, 32 seeds, 24
views; the stage-2 head at its full widths), on the same synthetic batch and
the same weights (the JAX model's own initialisation, bridged with
weights.py).

Two choices make the comparison a sharp one:

  - The stage table. With TINY_STAGES as they stand, every neighbourhood of
    the two deepest stages (16 and 8 centres, radii 0.4-1.2 in a scene 0.6
    wide) holds the whole scene, so the rows a BatchNorm normalises are near
    copies (their mean dwarfs their spread) and the batch-statistics forward
    amplifies any rounding until the reference disagrees with itself: moving
    every weight by one part in 2^23 changes some of its gradients
    outright. The tests run TINY_STAGES with 128 centres in stage 1, a
    quarter of the radii (half the full DRP's) and 512 points per scene,
    where the rows differ and the same perturbation leaves the gradients
    well inside the tolerances below.
  - The reference's BatchNorm means. XLA's CPU backend adds the rows of
    jnp.mean one after the other (n rounding steps, up to 16k rows here),
    and that f32 error moves the JAX forward and its gradients far past
    these tolerances from the same formula evaluated in float64. The
    fixture ``pairwise_bn_mean`` has the reference's BatchNorm
    (graspbalance_tpu/nn/layers.py, the only user of jnp.mean there) sum its
    rows in pairs instead (log2 n rounding steps), for this module only: the
    formula, mean(x^2) - mean^2 in f32, is unchanged; only the order of the
    additions, which XLA leaves open, differs. The port's own sums (torch's
    cascade) are as accurate.

Tolerances:
  - make_batch: every key exactly (the same numpy draws);
  - train-mode BatchNorm (the reference as it stands): outputs 1e-5,
    running statistics 1e-6;
  - label matching: indices exactly, floats 1e-6 (exact gathers; the
    rescaling's log may differ by an ulp);
  - get_loss from identical end points: the loss and every metric 1e-4
    relative (atol 1e-7 for metrics that are zero);
  - the train forward: index end points exactly; float end points within
    1e-4 of the key's largest |value| (the rounding of a batch-statistics
    forward scales with the activations it normalises, not with each
    element: a small entry of fp2_features carries the error of its large
    neighbours); the labels matched on them 1e-6; every top view wins its
    argmax on the JAX side by more than 1e-4, so a flip fails as a bad
    input; the loss and every metric 1e-4 relative;
  - gradients: within GRAD_TOL of each tensor's largest |grad|, or of
    GRAD_FLOOR x the model's largest |grad| where that is larger (the fuse
    layer's bias feeds only BatchNorms, which remove a per-channel constant:
    its exact gradient is 0 and both sides hold rounding noise);
  - the BatchNorm running statistics of the same forward: 1e-4 x max(1,
    largest |statistic|);
  - 3 steps of make_train_step (steps_per_epoch=10): before each, the port
    takes the reference's state (parameters, BatchNorm statistics, Adam
    moments; the step counts are checked), then each side takes one step;
    the loss within 1e-4 relative, parameters and BatchNorm statistics
    within STEP_TOL = 3x the first learning rate. Adam moves an element by
    up to its learning rate whatever its gradient's size, so an element
    whose gradient is rounding noise may step the other way on each side:
    that costs 2x the step's learning rate, inside STEP_TOL for one step,
    but it compounds over steps run apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import graspbalance_tpu.nn.layers as j_layers
from graspbalance_tpu.data.synthetic import make_batch as j_make_batch
from graspbalance_tpu.labels.label_gen import (
    match_grasp_view_and_label as j_match_grasp_view_and_label,
    process_grasp_labels as j_process_grasp_labels,
)
from graspbalance_tpu.labels.losses import get_loss as j_get_loss
from graspbalance_tpu.nn.layers import BatchNorm as JBatchNorm
from graspbalance_tpu.nn.layers import bn_momentum_schedule as j_bn_momentum_schedule
from graspbalance_tpu.train import train_step as jts
from graspbalance_tpu.train.config import Config as JConfig
from graspbalance_tpu.train.config import ModelConfig as JModelConfig
from graspbalance_tpu.train.config import TrainConfig as JTrainConfig
from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
from graspbalance_tpu_torch.labels.label_gen import match_grasp_view_and_label, process_grasp_labels
from graspbalance_tpu_torch.labels.losses import get_loss
from graspbalance_tpu_torch.nn.layers import BatchNorm, bn_momentum_schedule
from graspbalance_tpu_torch.train.config import Config, ModelConfig
from graspbalance_tpu_torch.train.train_step import (
    build_model,
    make_optimizer,
    set_bn_momentum,
    to_device,
    train_step,
)
from graspbalance_tpu_torch.weights import load_flax_variables, state_dict_from_flax
from tiny import TINY_NUM_SEED, TINY_NUM_VIEW, TINY_SCENE, TINY_STAGES
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

TOL = 1e-4
GRAD_TOL = 1e-3
GRAD_FLOOR = 1e-4
BATCH_SEED = 0
INIT_SEED = 0
EPOCH = 0
STEPS = 3
STEPS_PER_EPOCH = 10
STEP_TOL = 3 * Config().train.learning_rate / 25  # 3x OneCycle's first rate, max_lr / div_factor
# TINY_STAGES with 128 stage-1 centres and a quarter of the radii (see above)
STAGES = tuple(
    (npoint, radius / 4, nsample, mlp, blocks, la_radius / 4, la_nsample)
    for npoint, (_, radius, nsample, mlp, blocks, la_radius, la_nsample) in zip((128, 32, 16, 8), TINY_STAGES)
)
J_SCENE = dataclasses.replace(TINY_SCENE, num_points=512)
SCENE = SceneConfig(**{f.name: getattr(J_SCENE, f.name) for f in dataclasses.fields(SceneConfig)})
JCFG = JConfig(
    model=JModelConfig(num_view=TINY_NUM_VIEW, num_seed=TINY_NUM_SEED, backbone_stages=STAGES),
    train=JTrainConfig(n_data_shards=1),
)
CFG = Config(model=ModelConfig(num_view=TINY_NUM_VIEW, num_seed=TINY_NUM_SEED, backbone_stages=STAGES))
LOSS = "loss/overall_loss"
INDEX_KEYS = ("sa1_inds", "fp2_inds", "grasp_top_view_inds")
LABEL_KEYS = (
    "batch_grasp_point", "batch_grasp_view", "batch_grasp_view_rot", "batch_grasp_view_all",
    "batch_grasp_label", "batch_grasp_label_all", "batch_grasp_width", "batch_grasp_width_all",
    "batch_grasp_tolerance", "batch_grasp_view_label",
)
FLOAT_KEYS = (
    "sa1_xyz", "sa1_features", "sa2_features", "sa3_features", "sa4_features",
    "fp2_xyz", "fp2_features", "objectness_score", "view_score",
    "grasp_top_view_score", "grasp_top_view_rot",
    "grasp_score_pred", "grasp_angle_cls_pred", "grasp_width_pred", "grasp_tolerance_pred",
)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _spread(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _new_port_model(variables):
    return load_flax_variables(build_model(CFG, device="cpu"), variables)


def _pairwise_mean(x, axis):
    """jnp.mean over every axis but the last, the rows added in pairs."""
    assert tuple(axis) == tuple(range(x.ndim - 1)), axis
    rows = x.reshape(-1, x.shape[-1])
    n = rows.shape[0]
    while rows.shape[0] > 1:
        if rows.shape[0] % 2:
            rows = jnp.concatenate([rows, jnp.zeros_like(rows[:1])])
        rows = rows[0::2] + rows[1::2]
    return rows[0] / n


class _PairwiseMeanNumpy:
    """jax.numpy, but with ``_pairwise_mean`` as its mean."""

    mean = staticmethod(_pairwise_mean)

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(scope="module")
def pairwise_bn_mean():
    """The reference's BatchNorm sums its rows in pairs while this module's
    JAX runs trace (see the module docstring); restored afterwards."""
    saved = j_layers.jnp
    j_layers.jnp = _PairwiseMeanNumpy()
    try:
        yield
    finally:
        j_layers.jnp = saved


@pytest.fixture(scope="module")
def setup(pairwise_bn_mean):
    """The batch, the JAX model and its initial variables (numpy)."""
    batch = j_make_batch(BATCH_SEED, 2, J_SCENE)
    jmodel = jts.build_model(JCFG)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda r, b: jmodel.init(r, b, train=True))(jax.random.PRNGKey(INIT_SEED), jbatch)
    return batch, jmodel, _np_tree(dict(variables))


@pytest.fixture(scope="module")
def jax_grad_run(setup):
    """The JAX train forward + get_loss + value_and_grad, as make_train_step's
    loss_fn runs it: (loss, metrics, end points, grads, new batch stats)."""
    batch, jmodel, variables = setup
    momentum = j_bn_momentum_schedule(EPOCH)

    def loss_fn(params, stats, b):
        ep, mutated = jmodel.apply(
            {"params": params, "batch_stats": stats}, b, train=True, bn_momentum=momentum,
            mutable=["batch_stats"],
        )
        ep["objectness_label"] = b["objectness_label"]
        loss, metrics = j_get_loss(ep)
        return loss, (metrics, ep, mutated["batch_stats"])

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, (metrics, ep, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], jbatch
    )
    ep = {k: np.array(v) for k, v in ep.items() if v is not None}
    return float(loss), _np_tree(metrics), ep, _np_tree(grads), _np_tree(stats)


@pytest.fixture(scope="module")
def port_grad_run(setup):
    """The same through the port: the composition of train_step.forward_loss,
    keeping the end points, then backward."""
    batch, _, variables = setup
    model = _new_port_model(variables)
    tb = to_device(make_batch(BATCH_SEED, 2, SCENE), "cpu")
    set_bn_momentum(model, bn_momentum_schedule(EPOCH))
    model.train()
    ep = model.forward_train(tb)
    ep["objectness_label"] = tb["objectness_label"]
    loss, metrics = get_loss(ep)
    loss.backward()
    ep = {k: v.detach().numpy() for k, v in ep.items() if v is not None}
    grads = {name: p.grad.numpy() for name, p in model.named_parameters()}
    stats = {k: v.numpy() for k, v in model.state_dict().items() if "running" in k}
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, ep, grads, stats, model


def test_make_batch_matches_jax():
    for seed, cfg in ((3, SCENE), (4, dataclasses.replace(SCENE, num_objects=4, grasp_points_per_object=40))):
        jcfg = dataclasses.replace(TINY_SCENE, **dataclasses.asdict(cfg))
        want, got = j_make_batch(seed, 3, jcfg), make_batch(seed, 3, cfg)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("shape", [(4, 50, 16), (2, 3, 5, 16)])
def test_batchnorm_train_mode_matches_jax(rng, shape):
    x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(16)).astype(np.float32)
    mean0 = (0.1 * rng.standard_normal(16)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    momentum = 0.37
    jbn = JBatchNorm()
    want, mutated = jbn.apply(
        {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x), train=True, momentum=momentum, mutable=["batch_stats"],
    )
    bn = BatchNorm(16, momentum=momentum)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean0), "running_var": torch.from_numpy(var0)})
    got = bn.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mutated["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mutated["batch_stats"]["var"]), atol=1e-6)
    # eval mode reads the updated running statistics
    want_eval = jbn.apply({"params": {"scale": scale, "bias": bias}, "batch_stats": mutated["batch_stats"]},
                          jnp.asarray(x), train=False)
    np.testing.assert_allclose(bn.eval()(torch.from_numpy(x)).detach().numpy(), np.asarray(want_eval),
                               atol=1e-5, rtol=1e-5)


def test_bn_momentum_schedule_matches_jax():
    for epoch in range(0, 41, 3):
        assert bn_momentum_schedule(epoch) == float(j_bn_momentum_schedule(epoch))
        kw = dict(init=0.9, decay_rate=0.7, decay_step=3, floor=0.01)
        assert bn_momentum_schedule(epoch, **kw) == float(j_bn_momentum_schedule(epoch, **kw))


def _random_poses(rng, batch):
    """The batch with every object slot turned by a random rotation, so the
    view re-indexing is not the identity."""
    q, _ = np.linalg.qr(rng.standard_normal(batch["object_poses"].shape[:2] + (3, 3)))
    q *= np.sign(np.linalg.det(q))[..., None, None]
    out = dict(batch)
    out["object_poses"] = batch["object_poses"].copy()
    out["object_poses"][..., :3] = q.astype(np.float32)
    return out


@pytest.mark.parametrize("poses", ["identity", "random"])
def test_label_matching_matches_jax(setup, jax_grad_run, poses):
    batch = setup[0]
    if poses == "random":
        batch = _random_poses(np.random.default_rng(7), batch)
    ep = jax_grad_run[2]
    seeds, top = ep["fp2_xyz"], ep["grasp_top_view_inds"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = j_match_grasp_view_and_label(jnp.asarray(top), j_process_grasp_labels(jnp.asarray(seeds), jb))
    got = match_grasp_view_and_label(
        torch.from_numpy(top), process_grasp_labels(torch.from_numpy(seeds), to_device(batch, "cpu"))
    )
    assert got.keys() == want.keys()
    for key in want:
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=key)
    # the view permutation is not trivial, and some labels survive the mask
    assert np.asarray(want["batch_grasp_view_label"]).max() > 0


def test_get_loss_matches_jax_on_identical_end_points(jax_grad_run):
    ep = jax_grad_run[2]
    j_ep = {k: jnp.asarray(v) for k, v in ep.items()}
    want_loss, want = j_get_loss(j_ep)
    got_loss, got = get_loss({k: torch.from_numpy(v) for k, v in ep.items()})
    assert got.keys() == want.keys()
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=TOL)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=TOL, atol=1e-7, err_msg=key)


def _margin(x, axis):
    top2 = -np.sort(-x, axis=axis)
    return np.take(top2, 0, axis=axis) - np.take(top2, 1, axis=axis)


def test_train_forward_matches_jax(jax_grad_run, port_grad_run):
    want, got = jax_grad_run[2], port_grad_run[2]
    assert _margin(want["view_score"], -1).min() > TOL  # no top view near a tie
    for key in INDEX_KEYS:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in FLOAT_KEYS:
        assert got[key].shape == want[key].shape, key
        scale = float(np.abs(want[key]).max())
        err = _spread(got[key], want[key])
        assert err <= TOL * scale, f"{key}: {err:.3g} > {TOL} x {scale:.3g}"
    for key in LABEL_KEYS:
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=0, err_msg=key)


def test_loss_and_metrics_match_jax(jax_grad_run, port_grad_run):
    want_loss, want = jax_grad_run[0], jax_grad_run[1]
    got_loss, got = port_grad_run[0], port_grad_run[1]
    np.testing.assert_allclose(got_loss, want_loss, rtol=TOL)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], float(want[key]), rtol=TOL, atol=1e-7, err_msg=key)


def test_gradients_match_jax(jax_grad_run, port_grad_run):
    model = port_grad_run[5]
    want = state_dict_from_flax({"params": jax_grad_run[3], "batch_stats": jax_grad_run[4]}, model)
    got = port_grad_run[3]
    assert got.keys() == {k for k in want if "running" not in k}
    model_max = max(float(np.abs(want[name].numpy()).max()) for name in got)
    for name, g in got.items():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), GRAD_FLOOR * model_max)
        err = _spread(g, w)
        assert err <= GRAD_TOL * scale, f"{name}: max |grad error| {err:.3g} > {GRAD_TOL} x {scale:.3g}"
    # the running statistics of the same forward
    for name, s in port_grad_run[4].items():
        w = want[name].numpy()
        np.testing.assert_allclose(s, w, atol=TOL * max(1.0, float(np.abs(w).max())), rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def steps_run(setup):
    """STEPS steps of the JAX make_train_step from the initial variables;
    before each, the port is set to the reference's state and takes one
    train_step. Returns per step (the port's state_dict, the reference's
    state under the port's keys, the port's loss, the reference's loss)."""
    batch, jmodel, variables = setup
    tx = jts.make_optimizer(JCFG, steps_per_epoch=STEPS_PER_EPOCH)
    step_fn = jts.make_train_step(jmodel, JCFG)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jts.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), tx=tx,
    )
    # the reference runs Adam on the flattened parameters (opt_flatten)
    _, unflatten = ravel_pytree(variables["params"])

    model = _new_port_model(variables)
    optimizer, scheduler = make_optimizer(model, CFG, STEPS_PER_EPOCH)
    tb = make_batch(BATCH_SEED, 2, SCENE)
    out = []
    for step in range(STEPS):
        if step:  # the first step starts from the same variables and zero moments
            start = _np_tree({"params": state.params, "batch_stats": state.batch_stats})
            load_flax_variables(model, start)
            adam = state.opt_state[0]
            mu, nu = (
                state_dict_from_flax({"params": _np_tree(unflatten(m)), "batch_stats": start["batch_stats"]}, model)
                for m in (adam.mu, adam.nu)
            )
            for name, p in model.named_parameters():
                st = optimizer.state[p]
                assert int(st["step"]) == int(adam.count), name
                st["exp_avg"].copy_(mu[name])
                st["exp_avg_sq"].copy_(nu[name])
        state, j_metrics = step_fn(state, jbatch, jnp.int32(EPOCH))
        metrics = train_step(model, optimizer, scheduler, tb, EPOCH, CFG)
        want = state_dict_from_flax(_np_tree({"params": state.params, "batch_stats": state.batch_stats}), model)
        got = {k: v.clone() for k, v in model.state_dict().items()}
        out.append((got, want, float(metrics[LOSS]), float(j_metrics[LOSS])))
    return out


def test_three_steps_match_jax_train_step(steps_run):
    for step, (got, want, loss, j_loss) in enumerate(steps_run, 1):
        np.testing.assert_allclose(loss, j_loss, rtol=TOL, err_msg=f"loss of step {step}")
        assert got.keys() == want.keys()
        for name, t in got.items():
            err = _spread(t.numpy(), want[name].numpy())
            assert err <= STEP_TOL, f"step {step}, {name}: {err:.3g} > {STEP_TOL:.3g}"


def test_loss_falls_on_fixed_batch(setup):
    model = _new_port_model(setup[2])
    optimizer, scheduler = make_optimizer(model, CFG, STEPS_PER_EPOCH)
    batch = make_batch(BATCH_SEED, 2, SCENE)
    losses = [float(train_step(model, optimizer, scheduler, batch, EPOCH, CFG)[LOSS]) for _ in range(8)]
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_build_model_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(CFG)
