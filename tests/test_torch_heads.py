"""The GraspBalance models the JAX package builds besides the default, on
the port, against the JAX package's (the tiny model of
tests/test_torch_model.py: TINY_STAGES, 32 seeds, 24 views; random
variables in the JAX tree with non-trivial BatchNorm statistics, bridged
with weights.py), eval forward + pred_decode:

  - the single-scale stage 2 (``multi_scale=False``: one scale, no fuse or
    gate; the width head's query at 1 x 4 combos);
  - a ``num_depth=5`` model (hmax_list 0.01..0.05: 4 x 5 combos) with
    ``num_angle=6``, another cylinder radius and hmin;
  - ``query_order='nearest'`` (every ball query and the cylinder queries);

the training forward, label matching and loss of the ``num_depth=5`` /
``num_angle=6`` heads against the JAX package's on a batch whose labels
carry 6 angles and 5 depths (``SceneConfig(num_angles=6, num_depths=5)``,
as the JAX tests build them; on the PointNet++ backbone with
test_torch_train's stage table and pairwise BatchNorm means; the loss and
metrics 1e-4 relative, the end points as tests/test_torch_pointnet2.py's;
the gradients of the heads' layers are those of the default heads, which
test_torch_train.py and test_torch_pointnet2.py hold), then a port
``train_step`` on it (finite loss, every parameter moved); and
what the port refuses: ``width_impl='fused_pallas'`` with 'nearest'
(the JAX package's fused query ignores query_order), an hmax_list without
num_depth entries, an unknown backbone; ``train_step.check_supported``
accepting each of these models' fields and still refusing
``n_data_shards=2``.

Tolerances (as tests/test_torch_model.py): indices and the valid mask
exactly; float end points and the decoded grasps within 1e-4 absolute +
1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspbalance_tpu.data.synthetic import make_batch as j_make_batch
from graspbalance_tpu.models.decode import pred_decode as j_pred_decode
from graspbalance_tpu.models.graspbalance import GraspBalance as JGraspBalance
from graspbalance_tpu_torch.data.synthetic import make_batch
from graspbalance_tpu_torch.models import GraspBalance, pred_decode
from graspbalance_tpu_torch.train.config import Config, ModelConfig, TrainConfig
from graspbalance_tpu_torch.train.train_step import build_model, check_supported, make_optimizer, train_step
from graspbalance_tpu_torch.weights import load_flax_variables
from test_torch_model import _margin
from test_torch_pointnet2 import SSG_TRAIN, check_loss_and_gradients, grad_pair
from test_torch_train import J_SCENE, SCENE, pairwise_bn_mean  # noqa: F401  (a fixture)
from test_torch_variants import _vars
from tiny import TINY_NUM_SEED, TINY_NUM_VIEW, TINY_SCENE, TINY_STAGES
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

TOL = 1e-4
INDEX_KEYS = ("sa1_inds", "fp2_inds", "grasp_top_view_inds", "valid")
FLOAT_KEYS = ("fp2_features", "objectness_score", "view_score", "grasp_score_pred", "grasp_angle_cls_pred",
              "grasp_width_pred", "grasp_tolerance_pred", "grasps")
BASE = dict(backbone_stages=TINY_STAGES, num_seed=TINY_NUM_SEED, num_view=TINY_NUM_VIEW)
VARIANTS = {
    "single_scale": dict(multi_scale=False),
    "num_depth_5": dict(num_depth=5, hmax_list=(0.01, 0.02, 0.03, 0.04, 0.05), num_angle=6, cylinder_radius=0.06,
                        hmin=-0.01),
    "nearest": dict(query_order="nearest"),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_model_variant_matches_jax(variant):
    kw = dict(BASE, **VARIANTS[variant])
    pc = j_make_batch(1, 2, TINY_SCENE)["point_clouds"]
    jmodel = JGraspBalance(**kw)
    variables = _vars(jmodel, {"point_clouds": jnp.zeros((1, TINY_SCENE.num_points, 3))}, seed=11)
    j_ep = jax.jit(lambda v, x: jmodel.apply(v, {"point_clouds": x}))(variables, jnp.asarray(pc))
    j_grasps, j_valid = j_pred_decode(j_ep)
    want = {k: np.asarray(v) for k, v in j_ep.items() if v is not None}
    want.update(grasps=np.asarray(j_grasps), valid=np.asarray(j_valid))
    model = load_flax_variables(GraspBalance(**kw), variables).eval()
    assert hasattr(model, "fuse_multi_scale") == (variant != "single_scale")
    ep = model(torch.from_numpy(pc))
    grasps, valid = pred_decode(ep)
    got = {k: v.numpy() for k, v in ep.items() if v is not None}
    got.update(grasps=grasps.numpy(), valid=valid.numpy())
    a, d = kw.get("num_angle", 12), kw.get("num_depth", 4)
    assert got["grasp_score_pred"].shape == (2, TINY_NUM_SEED, a, d)
    assert _margin(want["view_score"], -1).min() > TOL
    for key in INDEX_KEYS:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in FLOAT_KEYS:
        np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=TOL, err_msg=key)


def test_model_refuses_what_jax_cannot_build_faithfully():
    with pytest.raises(ValueError, match="fused_pallas.*nearest"):
        GraspBalance(**BASE, query_order="nearest", width_impl="fused_pallas")
    with pytest.raises(ValueError, match="num_depth"):
        GraspBalance(**BASE, num_depth=5)
    with pytest.raises(ValueError, match="backbone"):
        GraspBalance(**BASE, backbone="resnet")


def test_check_supported_accepts_the_jax_models_and_refuses_the_rest():
    m = ModelConfig(num_view=TINY_NUM_VIEW, num_seed=TINY_NUM_SEED)
    for fields in (dict(backbone="pointnet2"), dict(query_order="nearest"), dict(num_angle=6),
                   dict(num_depth=5, hmax_list=(0.01, 0.02, 0.03, 0.04, 0.05)), dict(cylinder_radius=0.05),
                   dict(hmin=-0.01)):
        check_supported(Config(model=dataclasses.replace(m, **fields)))
    for fields, match in ((dict(query_order="nearest_approx"), "nearest_approx.*Leave behind"),
                          (dict(num_depth=5), "num_depth=5"), (dict(backbone="resnet"), "backbone")):
        with pytest.raises(ValueError, match=match):
            check_supported(Config(model=dataclasses.replace(m, **fields)))
    with pytest.raises(ValueError, match="n_data_shards=2 needs a process group of 2 ranks; this one has 1"):
        check_supported(Config(model=m, train=TrainConfig(n_data_shards=2)))
    with pytest.raises(ValueError, match="batch_size=2 does not split over n_data_shards=4 ranks"):
        check_supported(Config(model=m, train=TrainConfig(n_data_shards=4)), world=4)


def test_non_default_heads_train_as_jax(pairwise_bn_mean):  # noqa: F811
    fields = dict(VARIANTS["num_depth_5"], backbone="pointnet2", backbone_stages=SSG_TRAIN)
    j_scene, scene = (dataclasses.replace(s, num_angles=6, num_depths=5) for s in (J_SCENE, SCENE))
    runs = grad_pair(j_scene, scene, grads=False, **fields)
    (_, _, want, _), (_, _, got, _) = runs
    assert got["grasp_score_pred"].shape[2:] == (6, 5) == want["batch_grasp_label"].shape[-2:]
    for key in ("grasp_top_view_inds", "batch_grasp_view"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("batch_grasp_label", "batch_grasp_width", "batch_grasp_tolerance"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=0, err_msg=key)
    check_loss_and_gradients(runs)
    cfg = Config(model=dataclasses.replace(ModelConfig(num_view=TINY_NUM_VIEW, num_seed=TINY_NUM_SEED), **fields))
    model = build_model(cfg, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer, scheduler = make_optimizer(model, cfg, 10)
    metrics = train_step(model, optimizer, scheduler, make_batch(0, 2, scene), 0, cfg)
    assert np.isfinite(float(metrics["loss/overall_loss"]))
    assert all(not torch.equal(p, before[k]) for k, p in model.named_parameters())
