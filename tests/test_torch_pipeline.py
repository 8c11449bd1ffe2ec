"""The port's serving pipeline, GraspInference, against the JAX package's on
the same scenes and weights: the tiny GraspBalance of tests/test_torch_model.py
and the tiny DSN of tests/test_pipeline.py, with random variables in the JAX
trees bridged into the port, and the JAX package's own mean-shift Gumbel
draws handed to the port.

Tolerances: decoded grasps within 1e-4 absolute + 1e-4 relative (f32 sums in
other orders, as in tests/test_torch_model.py); keep masks, OBS seed indices
and segment labels exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspbalance_tpu.data.synthetic import make_batch
from graspbalance_tpu.eval.pipeline import GraspInference as JGraspInference
from graspbalance_tpu.models.dsn import DSN as JDSN
from graspbalance_tpu.models.graspbalance import GraspBalance as JGraspBalance
from graspbalance_tpu_torch.eval.meanshift import subsampled_count
from graspbalance_tpu_torch.eval.pipeline import GraspInference, to_grasp_group_array
from graspbalance_tpu_torch.models import DSN, GraspBalance
from graspbalance_tpu_torch.weights import load_flax_variables
from test_torch_dsn import TINY_PT_STAGES, jax_gumbel
from test_torch_model import _random_variables
from tiny import TINY_NUM_SEED, TINY_NUM_VIEW, TINY_QUALITY_SCENE, TINY_SCENE, TINY_STAGES
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

TOL = 1e-4
# compact clutter (the quality gate's scene), where the collision filter
# drops a grasp of these weights: the keep mask holds both outcomes
SCENE, SCENE_SEED, WEIGHT_SEEDS = TINY_QUALITY_SCENE, 11, (13, 12)
MODEL_KW = dict(backbone_stages=TINY_STAGES, num_seed=TINY_NUM_SEED, num_view=TINY_NUM_VIEW)


@pytest.fixture(scope="module")
def models():
    """Both packages' GraspBalance and DSN with the same random variables."""
    pc = jnp.zeros((1, TINY_SCENE.num_points, 3), jnp.float32)
    jmodel, jdsn = JGraspBalance(**MODEL_KW), JDSN(pt_stages=TINY_PT_STAGES)
    mshapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), {"point_clouds": pc}, train=False))
    dshapes = jax.eval_shape(lambda: jdsn.init(jax.random.PRNGKey(1), pc, train=False))
    mvars = _random_variables(mshapes, np.random.default_rng(WEIGHT_SEEDS[0]))
    dvars = _random_variables(dshapes, np.random.default_rng(WEIGHT_SEEDS[1]))
    model = load_flax_variables(GraspBalance(**MODEL_KW), mvars)
    dsn = load_flax_variables(DSN(TINY_PT_STAGES), dvars)
    return (jmodel, mvars, jdsn, dvars), (model, dsn)


@pytest.mark.parametrize("use_obs", [False, True])
def test_grasp_inference_matches_jax(models, use_obs):
    (jmodel, mvars, jdsn, dvars), (model, dsn) = models
    cloud = make_batch(SCENE_SEED, 2, SCENE)["point_clouds"]
    jinfer = JGraspInference(jmodel, mvars, jdsn, dvars, use_obs=use_obs)
    want_grasps, want_keep = jinfer(jnp.asarray(cloud))  # rng: PRNGKey(0)
    infer = GraspInference(model, dsn, use_obs=use_obs, device="cpu")
    noise = jax_gumbel(jax.random.PRNGKey(0), 2, subsampled_count(SCENE.num_points))
    grasps, keep = infer(cloud, gumbel=torch.from_numpy(noise))
    assert isinstance(grasps, np.ndarray) and grasps.shape == (2, TINY_NUM_SEED, 17)
    np.testing.assert_allclose(grasps, want_grasps, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(keep, want_keep)
    assert keep.sum() > 0
    if not use_obs:
        assert keep.sum() < keep.size
    if use_obs:
        # the segmentation and the re-seeded indices themselves
        labels, sa_inds = jinfer._segment(dvars, jnp.asarray(cloud), jax.random.PRNGKey(0))
        got_labels, got_sa = infer.segment(torch.from_numpy(cloud), gumbel=torch.from_numpy(noise))
        np.testing.assert_array_equal(got_labels.numpy(), np.asarray(labels))
        np.testing.assert_array_equal(got_sa.numpy(), np.asarray(sa_inds))
        assert np.asarray(labels).max() >= 2  # OBS balances over several objects
        # the decoded grasps sit at the re-seeded points
        ep = infer.forward(torch.from_numpy(cloud), gumbel=torch.from_numpy(noise))
        seeds = np.take_along_axis(cloud, ep["fp2_inds"].numpy()[..., None].astype(np.int64), axis=1)
        np.testing.assert_array_equal(grasps[..., 13:16], seeds)
        assert not np.array_equal(ep["fp2_inds"].numpy(), ep["fp2_inds_fps"].numpy())
    arr = to_grasp_group_array(grasps[0], keep[0])
    assert arr.dtype == np.float32 and arr.shape == (keep[0].sum(), 17)


def test_grasp_inference_defaults_to_the_card(models, monkeypatch):
    """No device argument means CUDA: without a card it raises rather than
    falling back to the CPU."""
    model = models[1][0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraspInference(model)
