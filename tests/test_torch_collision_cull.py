"""The collision kernel's tile cull, through its plain twin, on the CPU.

``ops/collision.py:tile_may_hit`` is the test that ``csrc/collision.cu``
runs per grasp and 32-point tile, operation for operation: a tile is
skipped only when no point in its bounding box can be counted. These tests
hold it to ``collision_counts_plain`` on random grasps at the decoder's
ranges (widths 0-0.1, depths 0.01-0.04, height 0.02) and on ones far from
them: every (grasp, point) pair that a count takes must lie in a tile that
``tile_may_hit`` keeps, on tiles of 32 points in voxel order and in random
order, on one-point tiles (every point its own box), on points on and
within rounding of the box faces, on rotation rows that are not orthonormal
(the world bounds then step aside), and far from the origin. They also
check that the kernel's ranking by center x (``grasp_order``) is a
permutation that returns the counts to grasp order, and what ``cull_share``
counts.
"""

import numpy as np
import pytest
import torch

from graspbalance_tpu_torch.eval.collision import voxel_downsample_fixed
from graspbalance_tpu_torch.ops.collision import (
    TILE,
    _pair_masks,
    collision_counts_plain,
    cull_share,
    grasp_order,
    pack_grasp_params,
    tile_bounds,
    tile_may_hit,
    world_bounds,
)
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)


def _grasps(rng, b, g, centers, *, rot=None):
    """(B, G, 17) decoded rows at the decoder's ranges around ``centers``."""
    if rot is None:
        rot, _ = np.linalg.qr(rng.normal(size=(b, g, 3, 3)))
    rows = np.zeros((b, g, 17), np.float32)
    rows[..., 0] = rng.random((b, g))
    rows[..., 1] = rng.uniform(0.0, 0.1, (b, g))
    rows[..., 2] = 0.02
    rows[..., 3] = rng.integers(1, 5, (b, g)) * 0.01
    rows[..., 4:13] = rot.reshape(b, g, 9)
    rows[..., 13:16] = centers
    rows[..., 16] = -1
    return torch.from_numpy(rows)


def _scene(rng, b, n, extent=0.3):
    pts = rng.uniform(-extent, extent, (b, n, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(0.4, 0.5, (b, n))
    return torch.from_numpy(pts)


def _counted(points, valid, params):
    """(B, G, N) bool: the pairs that some count takes."""
    m = _pair_masks(points, valid, params)
    return m[4] | m[5]  # overall (left | right | bottom | shifting) and inner


def _assert_sound(points, valid, params):
    """Every counted pair lies in a tile that tile_may_hit keeps; returns
    the share of (grasp, tile) pairs kept."""
    lo, hi, _ = tile_bounds(points, valid)
    keep = tile_may_hit(params, lo, hi)  # (B, G, T)
    counted = _counted(points, valid, params)
    tile_of = torch.arange(points.shape[1]) // TILE
    missed = counted & ~keep[:, :, tile_of]
    assert int(counted.sum()) > 0, "the case counts nothing: it tests nothing"
    assert not bool(missed.any()), f"{int(missed.sum())} counted pairs lie in culled tiles"
    return float(keep.float().mean())


@pytest.mark.parametrize("order", ["voxel", "random"])
def test_cull_keeps_every_counted_pair(order):
    rng = np.random.default_rng(1)
    points = _scene(rng, 2, 6000)
    if order == "voxel":
        points, valid = voxel_downsample_fixed(points)
    else:
        valid = torch.from_numpy(rng.random((2, 6000)) > 0.3)
    centers = points.numpy()[np.arange(2)[:, None], rng.integers(0, 3000, (2, 200))]
    params = pack_grasp_params(_grasps(rng, 2, 200, centers), 0.03, 0.01, 0.06)
    kept = _assert_sound(points, valid, params)
    if order == "voxel":  # slabs in x: the cull must do its work there
        assert kept < 0.5


@pytest.mark.parametrize("case", ["decoded", "non_orthonormal", "far_from_origin"])
def test_cull_on_one_point_tiles(case):
    """Each point its own tile (lo = hi): the interval bounds are the
    kernel's own coordinates, so a pair on a box face or within rounding of
    one must still be kept."""
    rng = np.random.default_rng(2)
    b, g = 1, 64
    rot = None
    if case == "non_orthonormal":  # sheared and scaled rows
        rot = rng.normal(size=(b, g, 3, 3)) * rng.uniform(0.2, 3.0, (b, g, 3, 1))
    shift = 100.0 if case == "far_from_origin" else 0.0
    centers = rng.uniform(-0.05, 0.05, (b, g, 3)) + shift
    grasps = _grasps(rng, b, g, centers, rot=rot)
    params = pack_grasp_params(grasps, 0.03, 0.01, 0.06)
    # points on and next to every box face of every grasp, in its frame
    m = params[..., :9].reshape(b, g, 3, 3).double()  # rows: the gripper axes
    faces = [params[..., c] for c in (12, 13, 14, 15, 16, 17, 18, 19)]
    gx = torch.stack([faces[2], faces[3], faces[4], faces[5], (faces[2] + faces[5]) / 2], dim=-1)
    gy = torch.stack([-faces[7], -faces[6], faces[6], faces[7], torch.zeros_like(faces[6])], dim=-1)
    gz = torch.stack([faces[0], faces[1], torch.zeros_like(faces[0])], dim=-1)
    grid = torch.meshgrid(torch.arange(5), torch.arange(5), torch.arange(3), indexing="ij")
    local = torch.stack(grid, -1).reshape(-1, 3)
    frame = torch.stack([gx[..., local[:, 0]], gy[..., local[:, 1]], gz[..., local[:, 2]]], dim=-1).double()
    # p = t + M^-1 g, then nudged by an ulp or two
    world = params[..., None, 9:12].double() + torch.linalg.solve(m.unsqueeze(2), frame.unsqueeze(-1))[..., 0]
    pts = world.float().reshape(b, -1, 3)
    nudge = torch.from_numpy(rng.integers(-2, 3, pts.shape)).float()
    pts = torch.nextafter(pts, pts + nudge)
    pts = torch.nextafter(pts, pts + nudge)
    valid = torch.ones(pts.shape[:2], dtype=torch.bool)
    keep = tile_may_hit(params, pts, pts)  # (B, G, N): each point its own tile
    counted = _counted(pts, valid, params)
    assert int(counted.sum()) > 0
    assert not bool((counted & ~keep).any()), f"{int((counted & ~keep).sum())} counted pairs culled"
    assert float(keep.float().mean()) < 0.5  # and the rest are culled
    wlo, _ = world_bounds(params)
    if case != "non_orthonormal":
        assert bool(torch.isfinite(wlo).all()), "orthonormal rotations keep their world bounds"


def test_world_bounds_step_aside_for_non_orthonormal_rows():
    rng = np.random.default_rng(3)
    rot = np.tile(np.eye(3), (1, 4, 1, 1))
    rot[0, 1] *= 2.0  # scaled
    rot[0, 2, 0, 1] = 0.9  # sheared
    rot[0, 3, 2] = 0.0  # singular
    params = pack_grasp_params(_grasps(rng, 1, 4, np.zeros((1, 4, 3)), rot=rot), 0.03, 0.01, 0.06)
    lo, hi = world_bounds(params)
    assert bool(torch.isfinite(lo[0, 0]).all()) and bool(torch.isfinite(hi[0, 0]).all())
    assert bool(torch.isinf(lo[0, 1:]).all()) and bool(torch.isinf(hi[0, 1:]).all())
    # the identity grasp at the origin: x in (d - 0.1, d), |y| < w/2 + 0.01, |z| < 0.01
    d, w = float(params[0, 0, 14]), 2 * float(params[0, 0, 18])
    assert float(lo[0, 0, 0]) <= d - 0.1 and float(hi[0, 0, 0]) >= d
    assert float(hi[0, 0, 0]) < d + 1e-5 and float(hi[0, 0, 1]) < w / 2 + 0.01 + 1e-5


def test_cull_with_non_finite_parameters_keeps_every_tile():
    rng = np.random.default_rng(4)
    points = _scene(rng, 1, 256)
    valid = torch.ones((1, 256), dtype=torch.bool)
    params = pack_grasp_params(_grasps(rng, 1, 3, points[:, :3].numpy()), 0.03, 0.01, 0.06)
    params[0, 0, 14] = float("inf")
    params[0, 1, 0] = float("nan")
    lo, hi, _ = tile_bounds(points, valid)
    keep = tile_may_hit(params, lo, hi)
    assert bool(keep[0, :2].all())
    empty_lo = torch.full((1, 1, 3), float("inf"))
    assert not bool(tile_may_hit(params[:, 2:], empty_lo, -empty_lo).any())


def test_grasp_order_returns_counts_to_grasp_order():
    """The kernel counts its grasps in rank order and adds each count at the
    grasp's own index: ranking, counting and scattering back gives the plain
    counts in grasp order, with duplicated grasps and equal centers."""
    rng = np.random.default_rng(5)
    points = _scene(rng, 2, 3000)
    valid = torch.from_numpy(rng.random((2, 3000)) > 0.2)
    centers = points.numpy()[np.arange(2)[:, None], rng.integers(0, 3000, (2, 70))]
    params = pack_grasp_params(_grasps(rng, 2, 70, centers), 0.03, 0.01, 0.06)
    params[:, 10:20] = params[:, 0:10]  # duplicated grasps: equal keys, ties to the lower index
    params[1, 30, 9] = -0.0
    params[1, 31, 9] = 0.0
    order = grasp_order(params)
    assert torch.equal(order.sort(dim=1).values, torch.arange(70).expand(2, 70))
    x = params[..., 9].gather(1, order)
    assert bool((x[:, 1:] >= x[:, :-1]).all())
    ties = (x[:, 1:] == x[:, :-1]) & (order[:, 1:] < order[:, :-1]) & (x[:, 1:] != 0)
    assert not bool(ties.any()), "equal centers go to the lower index first"
    ranked = params.gather(1, order.unsqueeze(-1).expand(-1, -1, params.shape[-1]))
    back = torch.empty((2, 70, 6)).scatter_(1, order.unsqueeze(-1).expand(-1, -1, 6),
                                             collision_counts_plain(points, valid, ranked))
    torch.testing.assert_close(back, collision_counts_plain(points, valid, params), atol=0, rtol=0)


@pytest.mark.parametrize("g", [1, 31, 33])
def test_cull_share_counts_groups_and_tiles(g):
    rng = np.random.default_rng(6)
    points, valid = voxel_downsample_fixed(_scene(rng, 2, 2000))
    centers = points.numpy()[np.arange(2)[:, None], rng.integers(0, 500, (2, g))]
    params = pack_grasp_params(_grasps(rng, 2, g, centers), 0.03, 0.01, 0.06)
    kept, total = cull_share(points, valid, params)
    _, _, any_valid = tile_bounds(points, valid)
    assert total == int(any_valid.sum()) * -(-g // TILE)
    assert 0 < kept <= total
