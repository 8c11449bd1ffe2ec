"""The port's eval slice against the JAX package: a tiny GraspBalance
(TINY_STAGES, 32 seeds, 24 views; the stage-2 head at its full widths) is
given random variables in the JAX tree's structure (non-trivial BatchNorm
statistics, so the BN fold is exercised), bridged into the port with weights.py, and both
run the eval forward and pred_decode on the same synthetic scenes.

Tolerances: index keys and the valid mask exactly; every float end point
and the decoded grasps within 1e-4 absolute + 1e-4 relative (f32; the JAX
side runs the XLA query + einsum rotation + unfused SharedMLPs, the port the
rotation-folded fused MLP, so products are summed in other orders). Every
argmax that picks a path must win by more than that tolerance on the JAX
side, so a near tie fails as a bad input, not as a parity error. The one
exception is an exact tie on both sides: nested cylinders often share their
max-pooled neighbours, which makes a seed's depth scores bit-equal, and then
both sides take the lowest index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspbalance_tpu.data.synthetic import make_batch
from graspbalance_tpu.labels.geometry import (
    batch_viewpoint_params_to_matrix as j_viewpoint_to_matrix,
    generate_grasp_views as j_generate_grasp_views,
)
from graspbalance_tpu.models.decode import pred_decode as j_pred_decode
from graspbalance_tpu.models.graspbalance import GraspBalance as JGraspBalance
from graspbalance_tpu_torch.labels.geometry import (
    batch_viewpoint_params_to_matrix,
    generate_grasp_views,
)
from graspbalance_tpu_torch.models import GraspBalance, pred_decode
from graspbalance_tpu_torch.weights import load_flax_variables, state_dict_from_flax
from tiny import TINY_NUM_SEED, TINY_NUM_VIEW, TINY_SCENE, TINY_STAGES
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

TOL = 1e-4
SLICE_SEEDS = (1, 11)  # (scene, weights)
INDEX_KEYS = ("sa1_inds", "fp2_inds", "grasp_top_view_inds")
FLOAT_KEYS = (
    "input_xyz",
    "sa1_xyz", "sa1_features", "sa2_xyz", "sa2_features",
    "sa3_xyz", "sa3_features", "sa4_xyz", "sa4_features",
    "fp2_xyz", "fp2_features",
    "objectness_score", "view_score",
    "grasp_top_view_score", "grasp_top_view_xyz", "grasp_top_view_rot",
    "grasp_score_pred", "grasp_angle_cls_pred", "grasp_width_pred", "grasp_tolerance_pred",
)


def _new_models():
    kw = dict(backbone_stages=TINY_STAGES, num_seed=TINY_NUM_SEED, num_view=TINY_NUM_VIEW)
    return JGraspBalance(**kw), GraspBalance(**kw)


@pytest.fixture(scope="module")
def variable_shapes():
    """The JAX model's variable tree, as shapes (from tracing ``init``)."""
    pc = jnp.zeros((1, TINY_SCENE.num_points, 3), jnp.float32)
    return jax.eval_shape(
        lambda: _new_models()[0].init(jax.random.PRNGKey(0), {"point_clouds": pc}, train=False)
    )


def _random_variables(tree, rng, path=()):
    """``tree`` of shapes filled with numpy draws: dense kernels
    N(0, 1/fan_in), biases and BN means N(0, 0.01), BN scales around 1 and
    running variances in [0.5, 1.5], so the BN fold is non-trivial."""
    if hasattr(tree, "items"):
        return {k: _random_variables(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tree.shape, path[-1]
    if name == "kernel":
        x = rng.standard_normal(shape) / np.sqrt(shape[0])
    elif name == "var":
        x = rng.uniform(0.5, 1.5, shape)
    elif name == "scale":
        x = 1.0 + rng.standard_normal(shape) * 0.1
    else:  # bias, mean
        x = rng.standard_normal(shape) * 0.1
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def slice_outputs(variable_shapes):
    # seeds picked so that no path argmax is a near tie (see the docstring)
    pc = make_batch(SLICE_SEEDS[0], 2, TINY_SCENE)["point_clouds"]
    jmodel, model = _new_models()
    variables = _random_variables(variable_shapes, np.random.default_rng(SLICE_SEEDS[1]))
    j_ep = jax.jit(lambda v, x: jmodel.apply(v, {"point_clouds": x}, train=False))(variables, jnp.asarray(pc))
    j_grasps, j_valid = j_pred_decode(j_ep)
    load_flax_variables(model, variables)
    ep = model.eval()(torch.from_numpy(pc))
    grasps, valid = pred_decode(ep)
    j_out = {k: np.asarray(v) for k, v in j_ep.items() if v is not None}
    j_out.update(grasps=np.asarray(j_grasps), valid=np.asarray(j_valid))
    out = {k: v.numpy() for k, v in ep.items() if v is not None}
    out.update(grasps=grasps.numpy(), valid=valid.numpy())
    return j_out, out


@pytest.mark.parametrize("key", INDEX_KEYS + ("valid",))
def test_index_end_points_exact(slice_outputs, key):
    want, got = slice_outputs[0][key], slice_outputs[1][key]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", FLOAT_KEYS + ("grasps",))
def test_float_end_points_close(slice_outputs, key):
    want, got = slice_outputs[0][key], slice_outputs[1][key]
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def _margin(x, axis):
    top2 = -np.sort(-x, axis=axis)
    return np.take(top2, 0, axis=axis) - np.take(top2, 1, axis=axis)


def test_path_argmaxes_are_not_near_ties(slice_outputs):
    """Every argmax that picks a path (top view, decode's angle and depth,
    objectness) wins by more than the tolerance on the JAX side, or is an
    exact tie on both sides."""
    j, port = slice_outputs
    assert _margin(j["view_score"], -1).min() > TOL
    assert _margin(j["objectness_score"], -1).min() > TOL
    assert _margin(j["grasp_angle_cls_pred"], 2).min() > TOL
    margins = []
    for d in (j, port):
        ang = np.argmax(d["grasp_angle_cls_pred"], axis=2)[:, :, None, :]
        margins.append(_margin(np.take_along_axis(d["grasp_score_pred"], ang, axis=2)[:, :, 0], 2))
    tied = margins[0] == 0
    assert np.all(margins[1][tied] == 0)
    assert margins[0][~tied].min() > TOL


def test_bridge_maps_every_key_once(variable_shapes, rng):
    model = _new_models()[1]
    variables = _random_variables(variable_shapes, rng)
    sd = state_dict_from_flax(variables, model)
    assert sd.keys() == model.state_dict().keys()
    np.testing.assert_array_equal(
        sd["backbone.sa1.mlp.layer0.dense.weight"].numpy(),
        np.asarray(variables["params"]["backbone"]["sa1"]["mlp"]["layer0"]["dense"]["kernel"]).T,
    )
    np.testing.assert_array_equal(
        sd["width_grouping.mlp_scale3.layer2.bn.running_var"].numpy(),
        np.asarray(variables["batch_stats"]["width_grouping"]["mlp_scale3"]["layer2"]["bn"]["var"]),
    )


@pytest.mark.parametrize("fault", ["missing", "left_over", "bad_leaf", "bad_shape"])
def test_bridge_rejects_mismatches(fault, variable_shapes, rng):
    model = _new_models()[1]
    variables = _random_variables(variable_shapes, rng)
    params = variables["params"]
    if fault == "missing":
        del params["gate_fusion"]["bias"]
    elif fault == "left_over":
        params["extra_head"] = {"kernel": np.zeros((2, 2), np.float32)}
    elif fault == "bad_leaf":
        params["gate_fusion"]["gain"] = np.zeros((256,), np.float32)
    else:
        params["gate_fusion"]["bias"] = np.zeros((255,), np.float32)
    with pytest.raises(ValueError):
        state_dict_from_flax(variables, model)


def test_geometry_matches_jax(rng):
    np.testing.assert_array_equal(generate_grasp_views(300).numpy(), np.asarray(j_generate_grasp_views(300)))
    towards = rng.standard_normal((5, 7, 3)).astype(np.float32)
    towards[0, 0] = (0.0, 0.0, 1.0)  # vertical: the +y fallback
    angle = rng.uniform(0, np.pi, (5, 7)).astype(np.float32)
    want = np.asarray(j_viewpoint_to_matrix(jnp.asarray(towards), jnp.asarray(angle)))
    got = batch_viewpoint_params_to_matrix(torch.from_numpy(towards), torch.from_numpy(angle)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
