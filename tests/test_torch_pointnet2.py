"""The PointNet++ SSG backbone on the port (models/backbone.py and
``GraspBalance(backbone='pointnet2')``) against the JAX package's, at tiny
widths: TINY_STAGES' sample counts and MLP widths as an SSG stage table, 32
seeds, 24 views, the stage-2 head at its full widths.

  - the eval forward + pred_decode from random variables in the JAX tree's
    structure (non-trivial BatchNorm statistics), bridged with weights.py,
    in the default configuration and in the fused one
    (``fused_backbone_min_nsample=0``: the SA stages' mlp-max kernel, here
    its plain version, against the JAX package's unfused modules);
  - GraspInference without and with OBS (the JAX package's mean-shift
    Gumbel draws handed to the port);
  - the training forward, get_loss and the gradients from the JAX model's
    own initialisation, with the reference's BatchNorm summing its rows in
    pairs (``pairwise_bn_mean`` of tests/test_torch_train.py, whose
    docstring says why) on its well-conditioned stage table (128 centres in
    stage 1, a quarter of the radii, 512 points);
  - cli/train with ``--backbone pointnet2``: the config the JAX CLI builds
    from the same argv, and a JAX config.json with the pointnet2 backbone
    loading in the port and building its model.

Tolerances (as tests/test_torch_model.py and tests/test_torch_train.py):
indices, masks and keep masks exactly; eval floats and decoded grasps within
1e-4 absolute + 1e-4 relative; training floats within 1e-4 of each key's
largest |value|, the loss and metrics 1e-4 relative, each gradient within
1e-3 of its tensor's largest |grad| (or 1e-4 of the model's largest).
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graspbalance_tpu.cli.train as j_cli
import graspbalance_tpu.train.loop as j_loop
from graspbalance_tpu.data.synthetic import make_batch as j_make_batch
from graspbalance_tpu.eval.pipeline import GraspInference as JGraspInference
from graspbalance_tpu.labels.losses import get_loss as j_get_loss
from graspbalance_tpu.models.decode import pred_decode as j_pred_decode
from graspbalance_tpu.models.dsn import DSN as JDSN
from graspbalance_tpu.models.graspbalance import GraspBalance as JGraspBalance
from graspbalance_tpu.nn.layers import bn_momentum_schedule as j_bn_momentum_schedule
from graspbalance_tpu.train import train_step as jts
from graspbalance_tpu.train.checkpoints import CheckpointManager as JCheckpointManager
from graspbalance_tpu.train.config import config_to_dict as j_config_to_dict
import graspbalance_tpu_torch.cli.train as cli
import graspbalance_tpu_torch.train.loop as loop
from graspbalance_tpu_torch.data.synthetic import make_batch
from graspbalance_tpu_torch.eval.meanshift import subsampled_count
from graspbalance_tpu_torch.eval.pipeline import GraspInference
from graspbalance_tpu_torch.labels.losses import get_loss
from graspbalance_tpu_torch.models import DSN, GraspBalance, pred_decode
from graspbalance_tpu_torch.models.backbone import SSG_STAGES, Pointnet2Backbone
from graspbalance_tpu_torch.nn.layers import bn_momentum_schedule
from graspbalance_tpu_torch.train.checkpoints import load_config
from graspbalance_tpu_torch.train.config import config_to_dict
from graspbalance_tpu_torch.train.train_step import build_model, set_bn_momentum, to_device
from graspbalance_tpu_torch.weights import load_flax_variables, state_dict_from_flax
from test_torch_dsn import TINY_PT_STAGES, jax_gumbel
from test_torch_model import _margin, _random_variables
from test_torch_train import CFG, JCFG, J_SCENE, SCENE, STAGES, pairwise_bn_mean  # noqa: F401  (a fixture)
from tiny import TINY_NUM_SEED, TINY_NUM_VIEW, TINY_QUALITY_SCENE, TINY_SCENE, TINY_STAGES
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

TOL = 1e-4
GRAD_TOL, GRAD_FLOOR = 1e-3, 1e-4
SSG_TINY = tuple(s[:4] for s in TINY_STAGES)
SSG_TRAIN = tuple(s[:4] for s in STAGES)  # test_torch_train's well-conditioned table
MODEL_KW = dict(backbone="pointnet2", backbone_stages=SSG_TINY, num_seed=TINY_NUM_SEED, num_view=TINY_NUM_VIEW)
SCENE_SEED, WEIGHT_SEEDS = 11, (14, 12)
INDEX_KEYS = ("sa1_inds", "fp2_inds", "grasp_top_view_inds")
FLOAT_KEYS = (
    "sa1_xyz", "sa1_features", "sa2_features", "sa3_features", "sa4_features", "fp2_xyz", "fp2_features",
    "objectness_score", "view_score", "grasp_top_view_score", "grasp_top_view_rot",
    "grasp_score_pred", "grasp_angle_cls_pred", "grasp_width_pred", "grasp_tolerance_pred",
)


@pytest.fixture(scope="module")
def variables():
    pc = jnp.zeros((1, TINY_SCENE.num_points, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JGraspBalance(**MODEL_KW).init(jax.random.PRNGKey(0), {"point_clouds": pc}))
    return _random_variables(shapes, np.random.default_rng(WEIGHT_SEEDS[0]))


@pytest.fixture(scope="module")
def eval_outputs(variables):
    pc = make_batch(1, 2, TINY_SCENE)["point_clouds"]
    j_ep = jax.jit(lambda v, x: JGraspBalance(**MODEL_KW).apply(v, {"point_clouds": x}))(variables, jnp.asarray(pc))
    j_grasps, j_valid = j_pred_decode(j_ep)
    want = {k: np.asarray(v) for k, v in j_ep.items() if v is not None}
    want.update(grasps=np.asarray(j_grasps), valid=np.asarray(j_valid))
    outs = {}
    for name, kw in (("default", {}), ("fused", dict(fused_backbone_min_nsample=0))):
        model = load_flax_variables(GraspBalance(**MODEL_KW, **kw), variables).eval()
        ep = model(torch.from_numpy(pc))
        grasps, valid = pred_decode(ep)
        got = {k: v.numpy() for k, v in ep.items() if v is not None}
        got.update(grasps=grasps.numpy(), valid=valid.numpy())
        outs[name] = got
    return want, outs


def test_backbone_builds_the_jax_tree(variables):
    model = GraspBalance(**MODEL_KW)
    assert isinstance(model.backbone, Pointnet2Backbone)
    assert not any(k.startswith("backbone.block") for k in model.state_dict())
    assert state_dict_from_flax(variables, model).keys() == model.state_dict().keys()
    full = GraspBalance(backbone="pointnet2")
    assert full.backbone.stages == SSG_STAGES
    assert full.backbone.sa2.mlp.layer0.dense.in_features == 3 + 128


@pytest.mark.parametrize("config", ["default", "fused"])
def test_eval_forward_and_decode_match_jax(eval_outputs, config):
    want, got = eval_outputs[0], eval_outputs[1][config]
    assert _margin(want["view_score"], -1).min() > TOL
    assert _margin(want["objectness_score"], -1).min() > TOL
    for key in INDEX_KEYS + ("valid",):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in FLOAT_KEYS + ("grasps",):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=TOL, err_msg=key)


@pytest.mark.parametrize("use_obs", [False, True])
def test_grasp_inference_matches_jax(variables, use_obs):
    pc = jnp.zeros((1, TINY_SCENE.num_points, 3), jnp.float32)
    jdsn = JDSN(pt_stages=TINY_PT_STAGES)
    dvars = _random_variables(jax.eval_shape(lambda: jdsn.init(jax.random.PRNGKey(1), pc, train=False)),
                              np.random.default_rng(WEIGHT_SEEDS[1]))
    cloud = make_batch(SCENE_SEED, 2, TINY_QUALITY_SCENE)["point_clouds"]
    jinfer = JGraspInference(JGraspBalance(**MODEL_KW), variables, jdsn, dvars, use_obs=use_obs)
    want_grasps, want_keep = jinfer(jnp.asarray(cloud))
    model = load_flax_variables(GraspBalance(**MODEL_KW), variables)
    infer = GraspInference(model, load_flax_variables(DSN(TINY_PT_STAGES), dvars), use_obs=use_obs, device="cpu")
    noise = jax_gumbel(jax.random.PRNGKey(0), 2, subsampled_count(TINY_QUALITY_SCENE.num_points))
    grasps, keep = infer(cloud, gumbel=torch.from_numpy(noise))
    np.testing.assert_allclose(grasps, want_grasps, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(keep, want_keep)
    assert 0 < keep.sum() < keep.size  # the filters drop some grasps of these weights, not all


def grad_pair(j_scene=J_SCENE, scene=SCENE, *, grads: bool = True, **fields):
    """test_torch_train's model with ``fields`` replaced, in both packages,
    on one batch of ``j_scene`` / ``scene`` (the same draws), from the JAX
    model's initialisation, the reference's BatchNorm summing its rows in
    pairs (the caller holds ``pairwise_bn_mean``). Returns (JAX, port):
    loss, metrics, end points, gradients (port keys; None without
    ``grads``)."""
    jcfg = dataclasses.replace(JCFG, model=dataclasses.replace(JCFG.model, **fields))
    cfg = dataclasses.replace(CFG, model=dataclasses.replace(CFG.model, **fields))
    batch = j_make_batch(0, 2, j_scene)
    jmodel = jts.build_model(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda r, b: jmodel.init(r, b, train=True))(jax.random.PRNGKey(0), jbatch)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    momentum = j_bn_momentum_schedule(0)

    def loss_fn(params, stats, b):
        ep, _ = jmodel.apply({"params": params, "batch_stats": stats}, b, train=True, bn_momentum=momentum,
                             mutable=["batch_stats"])
        ep["objectness_label"] = b["objectness_label"]
        loss, metrics = j_get_loss(ep)
        return loss, (metrics, ep)

    args = (variables["params"], variables["batch_stats"], jbatch)
    if grads:
        (jloss, (jmetrics, jep)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(*args)
    else:
        jloss, (jmetrics, jep) = jax.jit(loss_fn)(*args)
    model = load_flax_variables(build_model(cfg, device="cpu"), variables)
    tb = to_device(make_batch(0, 2, scene), "cpu")
    set_bn_momentum(model, bn_momentum_schedule(0))
    model.train()
    ep = model.forward_train(tb)
    ep["objectness_label"] = tb["objectness_label"]
    loss, metrics = get_loss(ep)
    want = (float(jloss), {k: float(v) for k, v in jmetrics.items()},
            {k: np.asarray(v) for k, v in jep.items() if v is not None}, None)
    got = (float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()},
           {k: v.detach().numpy() for k, v in ep.items() if v is not None}, None)
    if grads:
        loss.backward()
        jgrads = jax.tree_util.tree_map(np.array, jgrads)
        want_grads = state_dict_from_flax({"params": jgrads, "batch_stats": variables["batch_stats"]}, model)
        want = want[:3] + ({k: v.numpy() for k, v in want_grads.items() if "running" not in k},)
        got = got[:3] + ({name: p.grad.numpy() for name, p in model.named_parameters()},)
    return want, got


@pytest.fixture(scope="module")
def grad_runs(pairwise_bn_mean):  # noqa: F811
    return grad_pair(backbone="pointnet2", backbone_stages=SSG_TRAIN)


def check_loss_and_gradients(grad_runs):
    """The loss and metrics within 1e-4 relative, each gradient (when the
    runs have them) within GRAD_TOL of its tensor's largest |grad| (or
    GRAD_FLOOR of the model's)."""
    (want_loss, want_metrics, _, want_grads), (loss, metrics, _, grads) = grad_runs
    np.testing.assert_allclose(loss, want_loss, rtol=TOL)
    assert metrics.keys() == want_metrics.keys()
    for key, value in want_metrics.items():
        np.testing.assert_allclose(metrics[key], value, rtol=TOL, atol=1e-7, err_msg=key)
    if want_grads is None:
        return
    assert grads.keys() == want_grads.keys()
    model_max = max(float(np.abs(g).max()) for g in want_grads.values())
    for name, g in grads.items():
        w = want_grads[name]
        scale = max(float(np.abs(w).max()), GRAD_FLOOR * model_max)
        err = float(np.abs(g.astype(np.float64) - w).max())
        assert err <= GRAD_TOL * scale, f"{name}: {err:.3g} > {GRAD_TOL} x {scale:.3g}"


def test_train_forward_matches_jax(grad_runs):
    (_, _, want, _), (_, _, got, _) = grad_runs
    assert _margin(want["view_score"], -1).min() > TOL
    for key in INDEX_KEYS:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in FLOAT_KEYS:
        scale = float(np.abs(want[key]).max())
        err = float(np.abs(got[key].astype(np.float64) - want[key]).max())
        assert err <= TOL * scale, f"{key}: {err:.3g} > {TOL} x {scale:.3g}"


def test_loss_and_gradients_match_jax(grad_runs):
    check_loss_and_gradients(grad_runs)


def test_cli_maps_pointnet2_as_jax(tmp_path, monkeypatch):
    """``--backbone pointnet2``: the same config as the JAX CLI's, passed
    by the loop's check; a config.json the JAX package writes with it loads
    in the port and builds a pointnet2 model."""
    argv = ["--backbone", "pointnet2", "--num_view", "24", "--log_dir", str(tmp_path)]
    captured = {}
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    monkeypatch.setattr(j_loop, "train", lambda cfg, *a, **k: captured.update(jax=cfg))
    j_cli.main()
    monkeypatch.setattr(loop, "train", lambda cfg, *a, **k: (loop.check_supported(cfg), captured.update(port=cfg)))
    cli.main(argv + ["--device", "cpu"])
    port, jcfg = config_to_dict(captured["port"]), j_config_to_dict(captured["jax"])
    for section, fields in port.items():
        for name, value in fields.items():
            assert jcfg[section][name] == value, (section, name)
    assert captured["port"].model.backbone == "pointnet2"
    jc = dataclasses.replace(captured["jax"], model=dataclasses.replace(captured["jax"].model,
                                                                       backbone_stages=SSG_TINY))
    JCheckpointManager(str(tmp_path / "ckpt")).save_config(jc)
    cfg = load_config(str(tmp_path / "ckpt"))
    assert cfg.model.backbone == "pointnet2" and cfg.model.backbone_stages == SSG_TINY
    model = build_model(cfg, device="cpu").eval()
    assert isinstance(model.backbone, Pointnet2Backbone)
    ep = model(torch.from_numpy(make_batch(0, 1, TINY_SCENE)["point_clouds"]))
    assert ep["grasp_score_pred"].shape == (1, SSG_TINY[1][0], 12, 4)  # seeds: the fp2 level
