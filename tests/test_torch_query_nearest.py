"""The port's queries in nearest order, and with a validity mask, against
the JAX package's (ops/query.py): ``ball_query(order='nearest')``,
``ball_query(valid=...)`` in both orders, ``cylinder_query`` in both orders
with and without ``valid``, and ``multi_cylinder_query(order='nearest')``,
on clouds of float-valued coordinates, on clouds whose every point appears
three times (exact distance ties: the lower index must come first, as
``lax.top_k`` keeps it), with centers far from every point (no hit: index 0
everywhere) and nsample above the hit count (the nearest hit repeats).

Tolerance: indices exactly equal. The ties come from duplicated points,
whose distances are equal however they are rounded: two distinct points
whose distances lie within an ulp rank by the rounding, and XLA's CPU
backend contracts the distance's products into FMAs where the port rounds
each one, so such near-ties are not a parity input.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspbalance_tpu.ops import query as jq
from graspbalance_tpu_torch.ops import query
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

RADII = (0.02, 0.04, 0.06, 0.08)
HMIN = -0.02
HMAXS = (0.01, 0.02, 0.03, 0.04)


def _rotations(rng, shape):
    q, _ = np.linalg.qr(rng.normal(size=shape + (3, 3)))
    return q.astype(np.float32)


def _cloud(rng, kind, b=2, n=600):
    """(b, n, 3) points: 'float' uniform in a 0.3 m box, 'dup' each of n/3
    such points three times (shuffled: exact distance ties)."""
    if kind == "float":
        return ((rng.random((b, n, 3)) - 0.5) * 0.3).astype(np.float32)
    base = ((rng.random((b, n // 3, 3)) - 0.5) * 0.3).astype(np.float32)
    rep = np.repeat(base, 3, axis=1)
    return np.ascontiguousarray(rep[:, rng.permutation(rep.shape[1])])


def _centers(rng, cloud, m=40):
    c = np.take_along_axis(cloud, rng.integers(0, cloud.shape[1], (cloud.shape[0], m))[..., None], axis=1).copy()
    c[:, :3] += rng.normal(scale=0.01, size=(cloud.shape[0], 3, 3)).astype(np.float32)  # off the points
    c[:, -2:] = 5.0  # no point within reach
    return c


@pytest.mark.parametrize("kind", ["float", "dup"])
@pytest.mark.parametrize("nsample", [1, 16, 64])
def test_ball_query_nearest_matches_jax(rng, kind, nsample):
    cloud = _cloud(rng, kind)
    centers = _centers(rng, cloud)
    want = np.asarray(jq.ball_query(jnp.asarray(cloud), jnp.asarray(centers), 0.05, nsample, order="nearest"))
    got = query.ball_query(torch.from_numpy(cloud), torch.from_numpy(centers), 0.05, nsample, order="nearest",
                           chunk=16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, -2:] == 0).all()


@pytest.mark.parametrize("order", ["index", "nearest"])
def test_ball_query_valid_matches_jax(rng, order):
    cloud = _cloud(rng, "dup")
    centers = _centers(rng, cloud)
    valid = rng.random(cloud.shape[:2]) < 0.6
    valid[1] = False  # no valid point: every center gets index 0
    want = np.asarray(jq.ball_query(jnp.asarray(cloud), jnp.asarray(centers), 0.06, 24, valid=jnp.asarray(valid),
                                    order=order))
    got = query.ball_query(torch.from_numpy(cloud), torch.from_numpy(centers), 0.06, 24,
                           valid=torch.from_numpy(valid), order=order)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[1] == 0).all()
    picked = np.take_along_axis(valid[0], want[0].reshape(-1), axis=0)
    assert picked[want[0].reshape(-1) != 0].all()


@pytest.mark.parametrize("order", ["index", "nearest"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["float", "dup"])
def test_cylinder_query_matches_jax(rng, order, masked, kind):
    cloud = _cloud(rng, kind)
    centers = _centers(rng, cloud, m=30)
    rot = _rotations(rng, centers.shape[:2])
    valid = rng.random(cloud.shape[:2]) < 0.7 if masked else None
    args = (0.04, HMIN, 0.03, 20)
    want = np.asarray(jq.cylinder_query(
        jnp.asarray(cloud), jnp.asarray(centers), jnp.asarray(rot), *args,
        valid=None if valid is None else jnp.asarray(valid), order=order,
    ))
    got = query.cylinder_query(
        torch.from_numpy(cloud), torch.from_numpy(centers), torch.from_numpy(rot), *args,
        valid=None if valid is None else torch.from_numpy(valid), order=order, chunk=8,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, -2:] == 0).all()


@pytest.mark.parametrize("radii,hmaxs", [
    (RADII, HMAXS),
    ((1.0 * 0.08,), HMAXS),  # the single-scale model's
    (RADII, (0.01, 0.02, 0.03, 0.04, 0.05)),  # a num_depth=5 model's
    ((0.06, 0.02, 0.08), (0.03, 0.01)),  # descending: nearest order takes any order
])
@pytest.mark.parametrize("kind", ["float", "dup"])
def test_multi_cylinder_query_nearest_matches_jax(rng, radii, hmaxs, kind):
    cloud = _cloud(rng, kind)
    centers = _centers(rng, cloud, m=24)
    rot = _rotations(rng, centers.shape[:2])
    want = np.asarray(jq.multi_cylinder_query(
        jnp.asarray(cloud), jnp.asarray(centers), jnp.asarray(rot), radii, HMIN, hmaxs, 32, order="nearest"))
    got = query.multi_cylinder_query(torch.from_numpy(cloud), torch.from_numpy(centers), torch.from_numpy(rot),
                                     radii, HMIN, hmaxs, 32, order="nearest", chunk=8)
    assert got.shape == (2, len(radii), len(hmaxs), 24, 32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_queries_refuse_what_jax_refuses(rng):
    cloud = torch.from_numpy(_cloud(rng, "float"))
    centers = cloud[:, :4].contiguous()
    rot = torch.from_numpy(_rotations(rng, (2, 4)))
    with pytest.raises(ValueError, match="ascending"):
        query.multi_cylinder_query(cloud, centers, rot, (0.06, 0.02), HMIN, HMAXS, 8)
    with pytest.raises(ValueError, match="ascending"):
        jq.multi_cylinder_query(*map(jnp.asarray, (cloud.numpy(), centers.numpy(), rot.numpy())),
                                (0.06, 0.02), HMIN, HMAXS, 8)
    with pytest.raises(ValueError, match="order"):
        query.ball_query(cloud, centers, 0.05, 8, order="nearest_approx")
