"""The port's post-decode stack against the JAX package on the same numpy
inputs: the collision counts (against both the fused-XLA path and the Pallas
kernel in interpret mode), collision_detect, the voxel downsample, grasp NMS
and the batched postprocess.

Tolerances: counts, collision and empty masks, keep masks and the voxel
valid mask exactly (integer results of the same float comparisons; the
scenes are offset from round voxel and box coordinates so that no point
lies within rounding of a face); centroids within 1e-7 (both sides add each
voxel's points one at a time in index order); ious within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspbalance_tpu.eval.collision import (
    FINGER_LENGTH,
    FINGER_WIDTH,
    _collision_counts_xla,
    collision_detect as j_collision_detect,
    voxel_downsample_fixed as j_voxel_downsample_fixed,
)
from graspbalance_tpu.eval.nms import grasp_nms as j_grasp_nms
from graspbalance_tpu.eval.pipeline import make_postprocess as j_make_postprocess
from graspbalance_tpu.ops.pallas.collision_kernel import (
    collision_counts_pallas,
    pack_grasp_params as j_pack_grasp_params,
)
from graspbalance_tpu_torch import trace
from graspbalance_tpu_torch.eval.collision import collision_detect, voxel_downsample_fixed
from graspbalance_tpu_torch.eval.nms import grasp_nms
from graspbalance_tpu_torch.eval.pipeline import make_postprocess
from graspbalance_tpu_torch.ops.collision import collision_counts, pack_grasp_params
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _random_grasps(rng, g):
    """(G, 17) decoded-layout grasps with orthonormal rotations."""
    q, _ = np.linalg.qr(rng.normal(size=(g, 3, 3)))
    rows = np.zeros((g, 17), np.float32)
    rows[:, 0] = rng.random(g)
    rows[:, 1] = rng.uniform(0.01, 0.1, g)
    rows[:, 2] = 0.02
    rows[:, 3] = rng.uniform(0.01, 0.04, g)
    rows[:, 4:13] = q.reshape(g, 9)
    rows[:, 13:16] = rng.uniform(-0.2, 0.2, (g, 3))
    rows[:, 16] = -1
    return rows


def _scene(rng, n):
    return (rng.uniform(-0.3, 0.3, (n, 3)) + 0.0137).astype(np.float32)


def _dense_scene(rng, n):
    """A scene whose points crowd the grasps' boxes, so that counts are
    large and many grasps collide: points clustered around a few centers."""
    centers = rng.uniform(-0.2, 0.2, (8, 3))
    return (centers[rng.integers(0, 8, n)] + rng.normal(0, 0.01, (n, 3)) + 0.0137).astype(np.float32)


@pytest.mark.parametrize("n,g,dense", [(300, 40, False), (1000, 100, True), (257, 33, True)])
def test_collision_counts_match_jax(n, g, dense):
    rng = np.random.default_rng(n)
    scene = (_dense_scene if dense else _scene)(rng, n)
    grasps = _random_grasps(rng, g)
    if dense:  # grasps at the scene's points
        grasps[:, 13:16] = scene[:g] + 0.005
    valid = rng.random(n) > 0.1
    want_xla = np.stack(
        _collision_counts_xla(jnp.asarray(scene), jnp.asarray(grasps), jnp.asarray(valid), approach_dist=0.03),
        axis=-1,
    )
    j_params = j_pack_grasp_params(jnp.asarray(grasps), 0.03, FINGER_WIDTH, FINGER_LENGTH)
    want_kernel = collision_counts_pallas(
        jnp.asarray(scene), jnp.asarray(valid), j_params, tg=16, tn=128, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(want_kernel), np.asarray(want_xla))
    params = pack_grasp_params(_t(grasps), 0.03, FINGER_WIDTH, FINGER_LENGTH)
    np.testing.assert_array_equal(params.numpy(), np.asarray(j_params))
    got = collision_counts(_t(scene)[None], _t(valid)[None], params[None])[0]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want_xla)
    if dense:
        assert want_xla[:, 4].max() > 3  # the boxes do hold points


@pytest.mark.parametrize("with_valid", [False, True])
def test_collision_detect_matches_jax(with_valid):
    rng = np.random.default_rng(7)
    b, n, g = 2, 2000, 64
    scenes = np.stack([_dense_scene(rng, n) for _ in range(b)])
    grasps = np.stack([_random_grasps(rng, g) for _ in range(b)])
    grasps[..., 13:16] = scenes[:, :g] + 0.005
    valid = rng.random((b, n)) > 0.2 if with_valid else None

    def one(s, gr, v):
        return j_collision_detect(s, gr, scene_valid=v, return_empty_grasp=True, return_ious=True, impl="xla")

    if with_valid:
        want = jax.vmap(one)(jnp.asarray(scenes), jnp.asarray(grasps), jnp.asarray(valid))
    else:
        want = jax.vmap(lambda s, gr: one(s, gr, None))(jnp.asarray(scenes), jnp.asarray(grasps))
    got = collision_detect(
        _t(scenes), _t(grasps), scene_valid=None if valid is None else _t(valid),
        return_empty_grasp=True, return_ious=True,
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for a, c in zip(got[2], want[2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-6, atol=0)
    assert 0 < int(got[0].sum()) < got[0].numel()  # both outcomes occur
    # one scene without a batch axis, as the JAX function takes it
    single = collision_detect(_t(scenes[0]), _t(grasps[0]))
    np.testing.assert_array_equal(
        single.numpy(), np.asarray(j_collision_detect(jnp.asarray(scenes[0]), jnp.asarray(grasps[0]), impl="xla"))
    )


@pytest.mark.parametrize("case", ["all_valid", "masked", "none_valid"])
def test_voxel_downsample_matches_jax(case):
    rng = np.random.default_rng(3)
    pts = (rng.random((2, 800, 3)) * 0.06 - 0.03 + 0.0013).astype(np.float32)
    pts[:, 100:200] = pts[:, :100]  # duplicates: several points per voxel
    valid = None
    if case == "masked":
        valid = rng.random((2, 800)) > 0.3
    elif case == "none_valid":
        valid = np.zeros((2, 800), bool)
    for i in range(2):
        want_c, want_v = j_voxel_downsample_fixed(
            jnp.asarray(pts[i]), None if valid is None else jnp.asarray(valid[i])
        )
        got_c, got_v = voxel_downsample_fixed(_t(pts[i]), None if valid is None else _t(valid[i]))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-7, rtol=0)
    # batched: the same per-scene results
    got_c, got_v = voxel_downsample_fixed(_t(pts), None if valid is None else _t(valid))
    for i in range(2):
        c_i, v_i = voxel_downsample_fixed(_t(pts[i]), None if valid is None else _t(valid[i]))
        np.testing.assert_array_equal(got_c[i].numpy(), c_i.numpy())
        np.testing.assert_array_equal(got_v[i].numpy(), v_i.numpy())
    if case != "none_valid":
        assert 50 < int(got_v.sum()) < 1600


def _nms_grasps(rng, g):
    """Grasps in tight clumps (conflicting centers and rotations), with
    exact score ties and invalid rows."""
    rows = _random_grasps(rng, g)
    clump = rng.integers(0, g // 6, g)
    rows[:, 13:16] = rng.uniform(-0.1, 0.1, (g // 6, 3))[clump] + rng.normal(0, 0.01, (g, 3))
    base_rot = rows[: g // 6, 4:13][clump]
    rows[:, 4:13] = np.where(rng.random((g, 1)) < 0.7, base_rot, rows[:, 4:13])
    rows[:, 0] = np.round(rng.random(g) * 8) / 8  # many equal scores
    valid = rng.random(g) > 0.15
    return rows.astype(np.float32), valid


@pytest.mark.parametrize("g", [1, 48, 300])
def test_grasp_nms_matches_jax(g):
    rng = np.random.default_rng(g)
    rows, valid = _nms_grasps(rng, max(g, 6))
    rows, valid = rows[:g], valid[:g]
    want = np.asarray(j_grasp_nms(jnp.asarray(rows), jnp.asarray(valid)))
    trace.enable()
    try:
        got = grasp_nms(_t(rows), _t(valid))
    finally:
        trace.disable()
    counters = trace.take()["counters"]
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        grasp_nms(_t(rows)).numpy(), np.asarray(j_grasp_nms(jnp.asarray(rows)))
    )
    if g == 300:
        assert counters["nms.sweeps"] > 2  # suppression chains are deeper than one step
        assert 0 < int(got.sum()) < int(valid.sum())


def test_postprocess_matches_jax():
    rng = np.random.default_rng(11)
    b, n, g = 2, 700, 96
    scene = np.stack([_dense_scene(rng, n) for _ in range(b)])
    grasps, valid = zip(*[_nms_grasps(rng, g) for _ in range(b)])
    grasps, valid = np.stack(grasps), np.stack(valid)
    grasps[..., 13:16] = scene[:, :g] + 0.005  # grasps at the scene's points
    want = np.asarray(j_make_postprocess()(jnp.asarray(grasps), jnp.asarray(valid), jnp.asarray(scene)))
    got = make_postprocess()(_t(grasps), _t(valid), _t(scene))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int(got.sum()) < int(valid.sum())
