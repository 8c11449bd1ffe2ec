"""The port's point-cloud ops (graspbalance_tpu_torch.ops) against the JAX
package on the same numpy inputs: FPS, gathers, ball and cylinder queries,
the multi-cylinder group, three-NN and interpolation.

Tolerances: indices exactly; gathered values exactly; distances and
interpolated features to 1e-6 / 1e-5 (f32, sums in another order); the
multi-cylinder group's rotated coordinates to 2e-6 m, the JAX kernel's own
bf16 hi/lo reconstruction error.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspbalance_tpu import ops as jops
from graspbalance_tpu.ops.interpolate import (
    interpolate_features as j_interpolate_features,
    inverse_distance_weights as j_inverse_distance_weights,
    three_interpolate as j_three_interpolate,
)
from graspbalance_tpu.ops.pallas.fps_kernel import fps_pallas_2d_batched
from graspbalance_tpu.ops.pallas.multicyl_kernel import multi_cylinder_group as j_multi_cylinder_group
from graspbalance_tpu_torch import ops
from graspbalance_tpu_torch.ops.fps import furthest_point_sample
from graspbalance_tpu_torch.ops.interpolate import (
    interpolate_features,
    inverse_distance_weights,
    three_interpolate,
)
from graspbalance_tpu_torch.ops.multicyl import multi_cylinder_group, multi_cylinder_group_plain
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

RADII = (0.02, 0.04, 0.06, 0.08)
HMIN = -0.02
HMAXS = (0.01, 0.02, 0.03, 0.04)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rotations(rng, shape):
    q, _ = np.linalg.qr(rng.normal(size=shape + (3, 3)))
    q[..., :, 0] *= np.sign(np.linalg.det(q))[..., None]
    return q.astype(np.float32)


def _fps_cloud(kind, rng):
    if kind == "random":
        return (rng.random((2, 300, 3)) - 0.5).astype(np.float32)
    if kind == "near_origin":
        # point 0 and a block of others within |p|^2 <= 1e-3: never selected
        # (idx[0] = 0 regardless)
        c = (rng.random((2, 257, 3)) - 0.5).astype(np.float32)
        c[:, :40] *= 0.02
        return c
    if kind == "ties":
        # integer grid + exact duplicates: equal distances everywhere, so the
        # lowest-index rule decides most steps
        g = rng.integers(-3, 4, size=(2, 150, 3)).astype(np.float32)
        return np.concatenate([g, g[:, ::-1]], axis=1)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random", "near_origin", "ties"])
def test_fps_matches_jax(kind, rng):
    xyz = _fps_cloud(kind, rng)
    m = 96
    want_xla = np.asarray(jops.furthest_point_sample(jnp.asarray(xyz), m, use_pallas=False))
    want_kernel = np.asarray(fps_pallas_2d_batched(jnp.asarray(xyz), m, interpret=True))
    np.testing.assert_array_equal(want_kernel, want_xla)
    got = furthest_point_sample(_t(xyz), m)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_xla)
    if kind == "near_origin":
        near = (xyz**2).sum(-1) <= 1e-3
        picked = np.take_along_axis(near, got.numpy()[:, 1:].astype(np.int64), axis=1)
        assert not picked.any()


def test_fps_kernel_path_never_falls_back(rng):
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel's checks (here: a meta tensor is refused, not computed)."""
    xyz = torch.empty((1, 100, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        furthest_point_sample(xyz, 8)


def test_gather_and_group_match_jax(rng):
    pts = rng.standard_normal((2, 50, 7)).astype(np.float32)
    idx2 = rng.integers(0, 50, size=(2, 11)).astype(np.int32)
    idx3 = rng.integers(0, 50, size=(2, 11, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        ops.gather_points(_t(pts), _t(idx2)).numpy(),
        np.asarray(jops.gather_points(jnp.asarray(pts), jnp.asarray(idx2))),
    )
    np.testing.assert_array_equal(
        ops.group_points(_t(pts), _t(idx3)).numpy(),
        np.asarray(jops.group_points(jnp.asarray(pts), jnp.asarray(idx3))),
    )


@pytest.mark.parametrize("radius,nsample", [(0.1, 8), (0.25, 16), (0.6, 32)])
def test_ball_query_matches_jax(rng, radius, nsample):
    xyz = (rng.random((2, 400, 3)) - 0.5).astype(np.float32)
    centers = np.concatenate(
        [xyz[:, :30], np.full((2, 2, 3), 9.0, np.float32)], axis=1
    )  # the last two centers have no neighbour
    want = np.asarray(jops.ball_query(jnp.asarray(xyz), jnp.asarray(centers), radius, nsample))
    got = ops.ball_query(_t(xyz), _t(centers), radius, nsample, chunk=7)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(got.numpy()[:, -2:] == 0)


def _cyl_case(rng, b=2, n=700, m=40):
    cloud = (rng.random((b, n, 3)) - 0.5).astype(np.float32) * 0.4
    centers = np.take_along_axis(cloud, rng.integers(0, n, size=(b, m))[..., None], axis=1)
    centers[:, -3:] = 50.0  # seeds with no hit in any combo
    return cloud, centers, _rotations(rng, (b, m))


@pytest.mark.parametrize("nsample", [16, 64])
def test_multi_cylinder_query_matches_jax(rng, nsample):
    cloud, centers, rot = _cyl_case(rng)
    want = np.asarray(
        jops.multi_cylinder_query(
            jnp.asarray(cloud), jnp.asarray(centers), jnp.asarray(rot), RADII, HMIN, HMAXS, nsample
        )
    )
    got = ops.multi_cylinder_query(_t(cloud), _t(centers), _t(rot), RADII, HMIN, HMAXS, nsample, chunk=16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(want[:, :, :, -3:] == 0)


def test_multi_cylinder_group_matches_jax_kernel(rng):
    """Indices exactly and rotated coordinates within 2e-6 m against the
    Pallas kernel in interpret mode, zero-hit seeds included."""
    cloud, centers, rot = _cyl_case(rng, b=1, n=600, m=24)
    want_rel, want_idx = j_multi_cylinder_group(
        jnp.asarray(cloud), jnp.asarray(centers), jnp.asarray(rot), RADII, HMIN, HMAXS, 32,
        interpret=True,
    )
    idx, rel = multi_cylinder_group(_t(cloud), _t(centers), _t(rot), RADII, HMIN, HMAXS, 32, emit_rel=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(rel.numpy(), np.asarray(want_rel), atol=2e-6, rtol=0)
    # no hit: index 0 and point 0's rotated coordinates, R^T (p0 - c)
    p0 = np.einsum("mji,mj->mi", rot[0, -3:].astype(np.float64), cloud[0, 0] - centers[0, -3:])
    assert np.all(idx.numpy()[0, :, :, -3:] == 0)
    np.testing.assert_allclose(rel.numpy()[0, :, :, -3:], np.broadcast_to(p0[:, None], (4, 4, 3, 32, 3)), atol=2e-6)
    idx_plain, none = multi_cylinder_group_plain(_t(cloud), _t(centers), _t(rot), RADII, HMIN, HMAXS, 32)
    assert none is None
    np.testing.assert_array_equal(idx_plain.numpy(), idx.numpy())


def test_three_nn_and_interpolate_match_jax(rng):
    unknown = rng.random((2, 60, 3)).astype(np.float32)
    known = rng.random((2, 20, 3)).astype(np.float32)
    known[:, 5] = known[:, 4]  # a duplicate known point: ties go to the lower index
    feats = rng.standard_normal((2, 20, 6)).astype(np.float32)

    j_dist, j_idx = jops.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    dist, idx = ops.three_nn(_t(unknown), _t(known))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(j_dist), atol=1e-6, rtol=0)

    j_w = j_inverse_distance_weights(j_dist)
    w = inverse_distance_weights(dist)
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        three_interpolate(_t(feats), idx, w).numpy(),
        np.asarray(j_three_interpolate(jnp.asarray(feats), j_idx, j_w)),
        atol=1e-5, rtol=0,
    )
    np.testing.assert_allclose(
        interpolate_features(_t(unknown), _t(known), _t(feats)).numpy(),
        np.asarray(j_interpolate_features(jnp.asarray(unknown), jnp.asarray(known), jnp.asarray(feats))),
        atol=1e-5, rtol=0,
    )

