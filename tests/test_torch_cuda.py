"""The CUDA kernels against their plain PyTorch versions on the card, at
edge cases the main path's shapes do not reach: clouds whose size is not a
multiple of the block, exact distance ties, near-origin points, seeds with
no cylinder hit, fewer than K hits, the cylinder query walked by several
warps per seed (a dense cloud where every combo fills in the first chunks,
hits only at the end of the cloud, N of 1, 31, 33 and off the warps' round,
unsorted radii and depths, nsample 1 and 100), duplicate kNN references
(every point 8 times on an integer grid at k = 1, 8, 16, 17, 31, 32),
reference counts below a tile, off multiples of 32 and over several tiles,
a single query, kNN beyond the kernel's k = 32 (a stable sort, no launch),
masked-FPS rows with no valid point, row lengths at every edge of its
routes (4-32 points a thread of 256, then 1,024 threads through L1), OBS's
prefix rows, one valid point with needed > 1, duplicated points whose ties
decide, and max_needed of 1, 128 and every slot at OBS's (64, 4096) -> 512;
for the collision counts ragged grasp
and point counts, points on and within ulps of box faces, grasps whose
boxes meet a tile's bounding box from either side on each axis, scenes in
voxel order and in random order, an all-invalid scene and valid sets that
are not a prefix, G = 1, 31, 33 and 1000, clouds below one tile,
duplicated grasps, rotation columns that are not orthonormal, and the
kernel's count of culled tiles against its plain twin; and for the
scatter-add (the gather backward) duplicate and dropped rows, destination
counts and channel counts off the block's tile, fewer rows than one sort
tile, the training step's gather shapes, more destinations
than one histogram block holds, hot destinations at and across the sum
chunk's length, and unaligned rows; for the fused group MLP + reduction every K
it takes, point counts off the tile and every reduction, and on its tensor
cores B = 1, N off the 128-row tile's points, one part and two (on the CUDA
cores and the tensor cores), the widest layer, four layers, channels off
the 16-byte copies and an unaligned part, within 1e-4 abs + rel; for the width MLP
on gripper-frame coordinates an odd seed count; for the class-plane
selection rows with no hit and with fewer hits than k, row lengths off the
warp's 32 and around its 16-byte loads and 512-point steps, planes that
start 1-15 bytes into their allocation, 1 x 1 to 7 x 2 combos, k of 1, 32,
33 and 100, values above 63, and rows that fill every combo in the first
step; for the table gather non-square tables on both axes, tables past
the old design's shared-memory limit at dim 0, dim-1 rows from a warp's to
nearly one block's shared memory, N off the float4 and unaligned pointers,
and the refusal of longer dim-1 rows; for FPS on a cluster of blocks N
around every cluster size and block slice at B = 1, 3 and 5, and exact ties
across the blocks of a cluster; for both width-MLP layouts seed counts off
the persistent blocks' stride, 10x the usual coordinates and pre-activations
centred on the ReLU's edge; OBS at seed counts where the sparsest scene's
quota is not the largest; the train-mode BatchNorm + ReLU at the main
path's shapes, one row, rows off its 4-row rounds and slabs, one channel,
channels past one block and past its finalize block, the data-parallel
route on a group of one, the module's route (launches, counters, copies
of unaligned rows, bfloat16 and eval mode), and its forward bit-equal to
the plain version's; and two launches of each bit-equal. For the
training loop's pieces: the analytic labels expanded on the card against
the host's numpy tensors and the transfer cache's identity hit. For the
tracer (``trace.py``): no synchronising call outside ``trace.host_read`` in
a served call without and with OBS or in a training step, by torch's sync
debug mode, and the device times of its spans and of ``step_timer``. Marked
``cuda``: they skip
where torch has no CUDA device, and run on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` because tests/conftest.py imports jax, which the card's
machine does not have; this file needs none of it.)

Tolerances: FPS, masked FPS, query and kNN indices, rotated coordinates,
kNN distances and collision counts exactly (both sides round the same
operations in the same order); the width MLP within 1e-5 (3xTF32 on the tensor
cores against the plain f32 matmuls), as the width MLP on gripper-frame
coordinates and the fused group MLP + reduction (1e-5 absolute and
relative); the class-plane selection and the table gather exactly; the
scatter-add exactly on
integer-valued cotangents, bit-equal between two launches, and on float
cotangents within 1e-5 of the float64 sums (the plain index_add_ adds in
atomic order) and within the worst-case bound of recursive f32 summation;
the label expansion exactly except where a width lies within an ulp of
GRASP_MAX_WIDTH; the BatchNorm kernels against float64 (see BN_Y_TOL and
BN_GRAD_TOL), the plain float32 version held to the same limits.
"""

import numpy as np
import pytest
import torch

from graspbalance_tpu_torch import _build
from graspbalance_tpu_torch.eval.collision import collision_detect, voxel_downsample_fixed
from graspbalance_tpu_torch.eval.obs import object_balance_indices
from graspbalance_tpu_torch.models.heads import MultiScaleWidthGrouping
from graspbalance_tpu_torch.nn.layers import BatchNorm, MLPBlock
from graspbalance_tpu_torch.ops.batchnorm import bn_act_backward_plain, bn_act_train, bn_act_train_plain
from graspbalance_tpu_torch.ops.collision import (
    collision_counts,
    collision_counts_plain,
    collision_cull_stats,
    cull_share,
    pack_grasp_params,
)
from graspbalance_tpu_torch.ops.gather import _flat_take, gather_points, group_points
from graspbalance_tpu_torch.ops.fps import (
    furthest_point_sample,
    furthest_point_sample_masked,
    furthest_point_sample_masked_plain,
    furthest_point_sample_plain,
)
from graspbalance_tpu_torch.ops.knn import knn, knn_plain
from graspbalance_tpu_torch.ops.mlpmax import mlp_max_fused, mlp_max_fused_plain
from graspbalance_tpu_torch.ops.multicyl import multi_cylinder_group, multi_cylinder_group_plain
from graspbalance_tpu_torch.ops.query import class_plane
from graspbalance_tpu_torch.ops.scatter import scatter_add, scatter_add_plain
from graspbalance_tpu_torch.ops.select import multicyl_select, multicyl_select_plain
from graspbalance_tpu_torch.ops.table_gather import table_gather, table_gather_plain
from graspbalance_tpu_torch.ops.widthmlp import (
    width_mlp_fused,
    width_mlp_fused_plain,
    width_mlp_fused_rot,
    width_mlp_fused_rot_plain,
)
from graspbalance_tpu_torch.weights import init_random_
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

pytestmark = pytest.mark.cuda

RADII = (0.02, 0.04, 0.06, 0.08)
HMIN = -0.02
HMAXS = (0.01, 0.02, 0.03, 0.04)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rotations(rng, shape):
    q, _ = np.linalg.qr(rng.normal(size=shape + (3, 3)))
    return q.astype(np.float32)


@pytest.mark.parametrize("n", [1, 100, 1023, 1025, 20000, 32768])
def test_fps_kernel_sizes(dev, rng, n):
    xyz = torch.from_numpy((rng.random((3, n, 3)) - 0.5).astype(np.float32)).to(dev)
    m = min(n, 300)
    before = _build.launches["fps"]
    got = furthest_point_sample(xyz, m)
    assert _build.launches["fps"] == before + 1
    torch.testing.assert_close(got, furthest_point_sample_plain(xyz, m), atol=0, rtol=0)


@pytest.mark.parametrize("m", [1, 512, 3000])
def test_fps_kernel_ties_and_origin(dev, rng, m):
    g = rng.integers(-3, 4, size=(2, 1500, 3)).astype(np.float32)
    g = np.concatenate([g, g[:, ::-1]], axis=1)  # duplicates: exact ties
    g[:, :50] *= 0.01  # near-origin points
    xyz = torch.from_numpy(g).to(dev)
    got = furthest_point_sample(xyz, m)
    want = furthest_point_sample_plain(xyz, m)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_fps_kernel_refuses_what_it_cannot_take(dev):
    """Only a wrong dtype or an empty cloud is refused: past the register
    routes' 65,536 and 32,768 points the streaming mode takes any N."""
    with pytest.raises(ValueError, match="float32"):
        furthest_point_sample(torch.zeros((1, 10, 3), dtype=torch.float64, device=dev), 4)
    with pytest.raises(ValueError, match="points"):
        furthest_point_sample(torch.zeros((1, 0, 3), device=dev), 4)
    assert furthest_point_sample(torch.zeros((1, 65537, 3), device=dev), 4).shape == (1, 4)
    got = furthest_point_sample_masked(
        torch.zeros((1, 32769, 3), device=dev), torch.ones((1, 32769), dtype=torch.bool, device=dev), 4
    )
    assert got.shape == (1, 4)


# past 65,536 points (main mode) and 32,768 (masked mode) FPS streams its
# running distances through global memory, a cooperative grid per launch;
# every cloud's blocks reduce their winners through a grid barrier
@pytest.mark.parametrize("b,n,m", [(1, 65537, 64), (3, 100_000, 300), (2, 262_144, 32), (1, 1_048_576, 16)])
def test_fps_kernel_streaming_mode(dev, rng, b, n, m):
    xyz = torch.from_numpy((rng.random((b, n, 3)) - 0.5).astype(np.float32)).to(dev)
    xyz[:, 5::9973] = 0.001  # near-origin points: never selected
    before = _build.launches["fps"]
    got = furthest_point_sample(xyz, m)
    assert _build.launches["fps"] == before + 1
    torch.testing.assert_close(got, furthest_point_sample_plain(xyz, m), atol=0, rtol=0)
    assert torch.equal(got, furthest_point_sample(xyz, m))


def test_fps_kernel_streaming_ties(dev, rng):
    """Integer-grid points repeated over 100,000 points: every value ties
    across blocks of the grid, the lower index must win; m reaches the
    distances' zeros."""
    tile = rng.integers(-3, 4, size=(2, 2000, 3)).astype(np.float32)
    xyz = torch.from_numpy(np.tile(tile, (1, 50, 1))).to(dev)
    got = furthest_point_sample(xyz, 400)
    torch.testing.assert_close(got, furthest_point_sample_plain(xyz, 400), atol=0, rtol=0)


@pytest.mark.parametrize("n", [32769, 100_000, 1_048_576])
def test_fps_masked_kernel_streaming_mode(dev, rng, n):
    """Masked rows past 32,768 points: mixed, suffix-only, all-valid and
    all-invalid rows, at max_needed below m."""
    s = 4
    xyz = torch.from_numpy((rng.random((s, n, 3)) - 0.5).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random((s, n)) < 0.5).to(dev)
    valid[0] = False
    valid[1, : n // 2] = False
    valid[2] = True
    _check_masked(xyz, valid, 48, 40)


# csrc/fps.cu spreads a cloud over a cluster of 1, 2, 4, 8 or 16 blocks of
# 128 threads: the smallest whose threads hold at most 20 points each (up to
# 2,560, 5,120, 10,240 and 20,480 points), else 16 blocks with up to 32
# points a thread; a block's slice is 128 x its points per thread
@pytest.mark.parametrize("b", [1, 3, 5])
@pytest.mark.parametrize(
    "n", [127, 128, 129, 2559, 2560, 2561, 5120, 5121, 10240, 10241, 20479, 20480, 20481, 40961, 65536]
)
def test_fps_kernel_cluster_boundaries(dev, rng, b, n):
    xyz = torch.from_numpy((rng.random((b, n, 3)) - 0.5).astype(np.float32)).to(dev)
    m = min(n, 200)
    got = furthest_point_sample(xyz, m)
    torch.testing.assert_close(got, furthest_point_sample_plain(xyz, m), atol=0, rtol=0)
    assert torch.equal(got, furthest_point_sample(xyz, m))


@pytest.mark.parametrize("n,m", [(20000, 2048), (40000, 1000), (3000, 3000)])
def test_fps_kernel_ties_across_the_cluster(dev, rng, n, m):
    """One block's slice at N = 20000 (128 x 20 points) of integer-grid
    points repeated over the cloud:
    every value has exact ties in other blocks of the cluster, so the lower
    index must win across distributed shared memory; near-origin points in
    every block; m up to N (the distances reach 0 everywhere)."""
    tile = rng.integers(-4, 5, size=(2, 2560, 3)).astype(np.float32)
    g = np.tile(tile, (1, -(-n // 2560), 1))[:, :n].copy()
    g[:, 7::997] = 0.001  # |p|^2 = 3e-6: never selected
    xyz = torch.from_numpy(g).to(dev)
    got = furthest_point_sample(xyz, m)
    torch.testing.assert_close(got, furthest_point_sample_plain(xyz, m), atol=0, rtol=0)
    near = (xyz * xyz).sum(dim=-1) <= 1e-3
    assert not bool(near.gather(1, got[:, 1:].long()).any())


@pytest.mark.parametrize("nsample", [1, 16, 64, 100])
def test_multicyl_kernel_edge_cases(dev, rng, nsample):
    b, n, m = 2, 3001, 77
    cloud = (rng.random((b, n, 3)) - 0.5).astype(np.float32) * 0.4
    centers = np.take_along_axis(cloud, rng.integers(0, n, size=(b, m))[..., None], axis=1)
    centers[:, -5:] = 50.0  # no hit in any combo
    args = [torch.from_numpy(a).to(dev) for a in (cloud, centers, _rotations(rng, (b, m)))]
    args += [RADII, HMIN, HMAXS, nsample]
    idx, rel = multi_cylinder_group(*args, emit_rel=True)
    idx_p, rel_p = multi_cylinder_group_plain(*args, emit_rel=True)
    torch.testing.assert_close(idx, idx_p, atol=0, rtol=0)
    torch.testing.assert_close(rel, rel_p, atol=0, rtol=0)
    assert bool((idx[:, :, :, -5:] == 0).all())
    idx_only, none = multi_cylinder_group(*args)
    assert none is None
    torch.testing.assert_close(idx_only, idx, atol=0, rtol=0)


def _ball(rng, n, radius):
    """n points uniformly inside a ball of ``radius`` about the origin."""
    v = rng.standard_normal((n, 3))
    v *= (rng.random((n, 1)) ** (1 / 3)) * radius / np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32)


@pytest.mark.parametrize("nsample", [1, 100])
@pytest.mark.parametrize(
    "case", ["dense_first_segment", "last_segment_only", "n1", "n31", "n33", "n4001", "unsorted_combos"]
)
def test_multicyl_kernel_segments(dev, rng, case, nsample):
    """The cylinder query split over several warps per seed: a dense cloud
    where every combo fills within the first segment (a ball inside the
    smallest cylinder for any rotation), hits only in the last segment, N of
    1, 31, 33 and off the segments' size, unsorted radii and depths; the
    last seed of each batch row sees no hit. idx and rel bit-equal to the
    plain version in both modes."""
    b, m, radii, hmaxs = 2, 9, RADII, HMAXS
    if case == "dense_first_segment":
        cloud = np.stack([_ball(rng, 3001, 0.005) for _ in range(b)])
        centers = np.zeros((b, m, 3), np.float32)
    elif case == "last_segment_only":
        cloud = (rng.random((b, 4000, 3)) + 10.0).astype(np.float32)
        cloud[:, -50:] = np.stack([_ball(rng, 50, 0.01) for _ in range(b)])
        centers = np.zeros((b, m, 3), np.float32)
    else:
        n = {"n1": 1, "n31": 31, "n33": 33, "n4001": 4001, "unsorted_combos": 3001}[case]
        cloud = ((rng.random((b, n, 3)) - 0.5) * 0.1).astype(np.float32)
        centers = np.take_along_axis(cloud, rng.integers(0, n, size=(b, m))[..., None], axis=1)
        if case == "unsorted_combos":
            radii, hmaxs = (0.06, 0.02, 0.08, 0.04), (0.03, 0.01, 0.04, 0.02)
    centers = centers.copy()
    centers[:, -1] = 50.0  # no hit in any combo
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (cloud, centers, _rotations(rng, (b, m)))]
    args += [radii, HMIN, hmaxs, nsample]
    if case == "unsorted_combos":  # refused, as the JAX package's index-order query refuses them
        for fn in (multi_cylinder_group, multi_cylinder_group_plain):
            with pytest.raises(ValueError, match="ascending"):
                fn(*args)
        return
    before = _build.launches["multicyl"]
    idx, rel = multi_cylinder_group(*args, emit_rel=True)
    assert _build.launches["multicyl"] == before + 1
    idx_p, rel_p = multi_cylinder_group_plain(*args, emit_rel=True)
    assert torch.equal(idx, idx_p) and torch.equal(rel, rel_p)
    assert bool((idx[:, :, :, -1] == 0).all())
    idx_only, none = multi_cylinder_group(*args)
    assert none is None and torch.equal(idx_only, idx)
    if case == "dense_first_segment":  # every point hits every combo: the first nsample points
        assert bool((idx[:, :, :, :-1] == torch.arange(nsample, device=dev, dtype=torch.int32)).all())


def test_multicyl_kernel_fewer_combos(dev, rng):
    cloud = torch.from_numpy((rng.random((1, 500, 3)) - 0.5).astype(np.float32) * 0.3).to(dev)
    centers = cloud[:, :20].contiguous()
    rot = torch.from_numpy(_rotations(rng, (1, 20))).to(dev)
    args = (cloud, centers, rot, (0.05, 0.1), -0.02, (0.03,), 8)
    torch.testing.assert_close(
        multi_cylinder_group(*args)[0], multi_cylinder_group_plain(*args)[0], atol=0, rtol=0
    )


# the kernel keeps a lane per combo: up to 28 (4 radii x 7 depths, 7 x 4),
# at most 7 radii and 7 depths; 4 x 5 is the num_depth=5 model's, 1 x 4 the
# single-scale model's
@pytest.mark.parametrize("radii,hmaxs", [
    ((0.08,), HMAXS),
    (RADII, (0.01, 0.02, 0.03, 0.04, 0.05)),
    (RADII, (0.005, 0.01, 0.02, 0.03, 0.04, 0.05, 0.06)),
    ((0.01, 0.02, 0.03, 0.04, 0.05, 0.06, 0.08), HMAXS),
    ((0.02, 0.04, 0.06, 0.08, 0.1), (0.01, 0.02, 0.03, 0.04, 0.05)),
])
@pytest.mark.parametrize("nsample", [16, 64])
def test_multicyl_kernel_more_combos(dev, rng, radii, hmaxs, nsample):
    b, n, m = 2, 6001, 97
    cloud = ((rng.random((b, n, 3)) - 0.5) * 0.3).astype(np.float32)
    centers = np.take_along_axis(cloud, rng.integers(0, n, size=(b, m))[..., None], axis=1).copy()
    centers[:, -3:] = 50.0  # no hit in any combo
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (cloud, centers, _rotations(rng, (b, m)))]
    args += [radii, HMIN, hmaxs, nsample]
    before = _build.launches["multicyl"]
    idx, rel = multi_cylinder_group(*args, emit_rel=True)
    assert _build.launches["multicyl"] == before + 1
    assert idx.shape == (b, len(radii), len(hmaxs), m, nsample)
    idx_p, rel_p = multi_cylinder_group_plain(*args, emit_rel=True)
    assert torch.equal(idx, idx_p) and torch.equal(rel, rel_p)


def test_multicyl_kernel_refuses_more_than_7_a_side(dev, rng):
    cloud = torch.zeros((1, 10, 3), device=dev)
    rot = torch.eye(3, device=dev).expand(1, 1, 3, 3).contiguous()
    with pytest.raises(ValueError, match="at most 7"):
        multi_cylinder_group(cloud, cloud[:, :1].contiguous(), rot, (0.01,) * 1, -0.02,
                             tuple(0.01 * (i + 1) for i in range(8)), 4)


def test_widthmlp_kernel_matches_plain(dev, rng):
    head = init_random_(MultiScaleWidthGrouping(), seed=5).to(dev)
    b, s = 2, 37
    centers = (rng.random((b, s, 3)) - 0.5).astype(np.float32)
    grouped = centers[:, :, None, None, None, :] + (rng.standard_normal((b, s, 4, 4, 64, 3)) * 0.05)
    args = [
        torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
        for a in (grouped, centers, _rotations(rng, (b, s)))
    ]
    weights = head.folded_weights()
    got = width_mlp_fused_rot(*args, weights)
    want = width_mlp_fused_rot_plain(*args, weights)
    assert got.shape == (b, s, 4, 1024)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_widthmlp_kernel_refuses_other_widths(dev, rng):
    head = init_random_(MultiScaleWidthGrouping(nsample=16, mlp=(8, 12, 16)), seed=5).to(dev)
    grouped = torch.zeros((1, 2, 4, 4, 16, 3), device=dev)
    centers, rot = torch.zeros((1, 2, 3), device=dev), torch.eye(3, device=dev).expand(1, 2, 3, 3)
    with pytest.raises(ValueError, match="widths"):
        width_mlp_fused_rot(grouped, centers, rot, head.folded_weights())


@pytest.mark.parametrize("q,r,k", [(1, 1, 1), (100, 1000, 16), (513, 2500, 16), (77, 40, 32), (300, 300, 3)])
def test_knn_kernel_sizes(dev, rng, q, r, k):
    query = torch.from_numpy(rng.standard_normal((2, q, 3)).astype(np.float32)).to(dev)
    ref = torch.from_numpy(rng.standard_normal((2, r, 3)).astype(np.float32)).to(dev)
    before = _build.launches["knn"]
    dist, idx = knn(ref, query, k)
    assert _build.launches["knn"] == before + 1
    dist_p, idx_p = knn_plain(ref, query, k)
    torch.testing.assert_close(idx, idx_p, atol=0, rtol=0)
    torch.testing.assert_close(dist, dist_p, atol=0, rtol=0)


def test_knn_kernel_ties(dev, rng):
    """Each reference point three times, on an integer grid: equal
    distances everywhere, so the lower index must win every tie."""
    base = rng.integers(-2, 3, size=(2, 200, 3)).astype(np.float32)
    pts = torch.from_numpy(np.repeat(base, 3, axis=1)).to(dev)
    dist, idx = knn(pts, pts, 16)
    dist_p, idx_p = knn_plain(pts, pts, 16)
    torch.testing.assert_close(idx, idx_p, atol=0, rtol=0)
    torch.testing.assert_close(dist, dist_p, atol=0, rtol=0)


@pytest.mark.parametrize("k", [1, 8, 16, 17, 31, 32])
def test_knn_kernel_repeated_grid(dev, rng, k):
    """Every point 8 times on an integer grid: ties everywhere, and most
    rounds insert several candidates."""
    base = rng.integers(-3, 4, size=(2, 150, 3)).astype(np.float32)
    pts = torch.from_numpy(np.repeat(base, 8, axis=1)).to(dev)
    query = pts[:, ::7].contiguous()
    _check_knn(pts, query, k)


@pytest.mark.parametrize("r", [20, 100, 1000, 2047, 2049, 5000])
def test_knn_kernel_reference_counts(dev, rng, r):
    """R below a tile of 2048 references, off multiples of 32, and over
    several tiles."""
    ref = torch.from_numpy(rng.standard_normal((2, r, 3)).astype(np.float32)).to(dev)
    query = torch.from_numpy(rng.standard_normal((2, 77, 3)).astype(np.float32)).to(dev)
    _check_knn(ref, query, min(16, r))


def test_knn_kernel_single_query(dev, rng):
    ref = torch.from_numpy(rng.standard_normal((3, 500, 3)).astype(np.float32)).to(dev)
    _check_knn(ref, ref[:, 7:8].contiguous(), 16)


def _check_knn(ref, query, k):
    """One counted launch, idx and dist exactly the plain version's, and a
    second launch bit-equal."""
    before = _build.launches["knn"]
    dist, idx = knn(ref, query, k)
    assert _build.launches["knn"] == before + 1
    dist_p, idx_p = knn_plain(ref, query, k)
    torch.testing.assert_close(idx, idx_p, atol=0, rtol=0)
    torch.testing.assert_close(dist, dist_p, atol=0, rtol=0)
    dist2, idx2 = knn(ref, query, k)
    assert torch.equal(dist, dist2) and torch.equal(idx, idx2)


def test_knn_beyond_the_kernel(dev, rng):
    """k = 40 > 32 sorts on the card (no kernel launch), as the JAX knn
    takes lax.top_k there; the same answer as the argmin passes."""
    query = torch.from_numpy(rng.standard_normal((2, 300, 3)).astype(np.float32)).to(dev)
    ref = torch.from_numpy(rng.standard_normal((2, 1000, 3)).astype(np.float32)).to(dev)
    before = _build.launches["knn"]
    dist, idx = knn(ref, query, 40)
    assert _build.launches["knn"] == before
    dist_p, idx_p = knn_plain(ref, query, 40)
    torch.testing.assert_close(idx, idx_p, atol=0, rtol=0)
    torch.testing.assert_close(dist, dist_p, atol=0, rtol=0)


def test_knn_kernel_refuses_what_it_cannot_take(dev):
    pts = torch.zeros((1, 40, 3), device=dev)
    with pytest.raises(ValueError, match="k"):
        knn(pts, pts, 41)
    with pytest.raises(ValueError, match="k"):
        knn(pts[:, :8], pts, 16)
    with pytest.raises(ValueError, match="float32"):
        knn(pts.double(), pts.double(), 4)


@pytest.mark.parametrize("b,q,r,k", [(2, 20000, 20000, 8), (2, 5000, 20000, 16), (2, 20000, 5000, 3),
                                     (8, 78, 312, 16)])
def test_knn_kernel_at_the_point_transformer_shapes(dev, b, q, r, k):
    """The Point Transformer backbone's searches at 20,000-point clouds: the
    first stage's own, a transition-down's, a transition-up's 3-NN and the
    coarsest stage's, on scene-like points (a table plane and boxes)."""
    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_point_clouds

    pts = torch.from_numpy(make_point_clouds(3, b, SceneConfig(num_points=20000))).to(dev)
    ref, query = pts[:, :r].contiguous(), pts[:, :q].contiguous()
    dist, idx = knn(ref, query, k)
    dist_p, idx_p = knn_plain(ref, query, k)
    torch.testing.assert_close(idx, idx_p, atol=0, rtol=0)
    torch.testing.assert_close(dist, dist_p, atol=0, rtol=0)


@pytest.mark.parametrize("n,m,needed", [(1, 4, 4), (1000, 300, 300), (4096, 512, 128), (4096, 512, 1), (20000, 64, 64)])
def test_fps_masked_kernel(dev, rng, n, m, needed):
    s = 6
    xyz = torch.from_numpy((rng.random((s, n, 3)) - 0.5).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random((s, n)) < 0.3).to(dev)
    valid[0] = False  # no valid point: index 0 everywhere
    valid[1, : n // 2] = False  # the seed is the first valid index
    valid[2] = True
    needed_t = torch.tensor(needed, dtype=torch.int32, device=dev)
    before = _build.launches["fps_masked"]
    got = furthest_point_sample_masked(xyz, valid, m, max_needed=needed_t)
    assert _build.launches["fps_masked"] == before + 1
    want = furthest_point_sample_masked_plain(xyz, valid, m)
    torch.testing.assert_close(got[:, :needed], want[:, :needed], atol=0, rtol=0)
    assert bool((got[:, needed:] == 0).all())
    assert bool((got[0] == 0).all())
    picked = valid.gather(1, got[:, :needed].long())
    has = valid.any(dim=1)
    assert bool(picked[has].all())


def _masked_rows(rng, case, s, n):
    """(s, n, 3) points and (s, n) valid masks of one kind of row."""
    xyz = (rng.random((s, n, 3)) - 0.5).astype(np.float32)
    valid = np.zeros((s, n), bool)
    if case == "prefix":  # OBS's compacted rows: the valid points lead
        for r, kc in enumerate(np.linspace(0, n, s).astype(int)):
            valid[r, :kc] = True
    elif case == "single_valid":
        valid[np.arange(s), rng.integers(0, n, s)] = True
    elif case == "duplicates":  # every point 4 times on a coarse grid: ties decide
        g = rng.integers(-3, 4, (s, n // 4 + 1, 3)).astype(np.float32)
        xyz = np.ascontiguousarray(np.repeat(g, 4, axis=1)[:, :n][:, rng.permutation(n)])
        valid = rng.random((s, n)) < 0.7
    elif case == "all_invalid":
        pass
    return torch.from_numpy(xyz), torch.from_numpy(valid)


def _check_masked(xyz, valid, m, needed):
    needed_t = torch.tensor(needed, dtype=torch.int32, device=xyz.device)
    before = _build.launches["fps_masked"]
    got = furthest_point_sample_masked(xyz, valid, m, max_needed=needed_t)
    assert _build.launches["fps_masked"] == before + 1
    steps = min(max(needed, 1), m)
    want = furthest_point_sample_masked_plain(xyz, valid, steps)
    torch.testing.assert_close(got[:, :steps], want, atol=0, rtol=0)
    assert bool((got[:, steps:] == 0).all())
    assert torch.equal(got, furthest_point_sample_masked(xyz, valid, m, max_needed=needed_t))


@pytest.mark.parametrize("n", [1, 31, 512, 513, 1024, 1025, 2048, 2049, 4096, 4097, 8192, 8193, 16384, 16385,
                               20000, 32768])
def test_fps_masked_kernel_dispatch_edges(dev, rng, n):
    """Every row length at an edge of the kernel's routes (4, 8, 16 and 32
    points a thread of 256, then 1,024 threads reading through L1), with
    mixed, prefix and all-valid rows."""
    xyz = torch.from_numpy((rng.random((4, n, 3)) - 0.5).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random((4, n)) < 0.5).to(dev)
    valid[1, n // 3 :] = False
    valid[2] = True
    _check_masked(xyz, valid, min(n, 200), min(n, 200))


@pytest.mark.parametrize("case", ["prefix", "single_valid", "duplicates", "all_invalid"])
def test_fps_masked_kernel_rows(dev, rng, case):
    """OBS-style prefix rows, one valid point and needed > 1 (it is picked
    again, at distance 0), duplicated points whose ties go to the lowest
    index, and rows with no valid point (0 everywhere)."""
    xyz, valid = (a.to(dev) for a in _masked_rows(rng, case, 9, 4096))
    _check_masked(xyz, valid, 512, 128)
    if case == "all_invalid":
        assert bool((furthest_point_sample_masked(xyz, valid, 64) == 0).all())


@pytest.mark.parametrize("needed", [1, 128, 512])
def test_fps_masked_kernel_needed(dev, rng, needed):
    """OBS's shape, 64 rows of 4,096 points -> 512 slots, at max_needed of
    1, the path's 128 and every slot."""
    xyz, valid = (a.to(dev) for a in _masked_rows(rng, "prefix", 64, 4096))
    _check_masked(xyz, valid, 512, needed)


def _grasps(rng, b, g):
    q, _ = np.linalg.qr(rng.normal(size=(b, g, 3, 3)))
    rows = np.zeros((b, g, 17), np.float32)
    rows[..., 0] = rng.random((b, g))
    rows[..., 1] = rng.uniform(0.01, 0.1, (b, g))
    rows[..., 2] = 0.02
    rows[..., 3] = rng.uniform(0.01, 0.04, (b, g))
    rows[..., 4:13] = q.reshape(b, g, 9)
    rows[..., 13:16] = rng.uniform(-0.2, 0.2, (b, g, 3))
    rows[..., 16] = -1
    return rows


@pytest.mark.parametrize("n,g", [(1, 1), (513, 130), (5000, 1000), (20000, 257)])
def test_collision_kernel_ragged(dev, rng, n, g):
    b = 2
    points = torch.from_numpy(rng.uniform(-0.25, 0.25, (b, n, 3)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random((b, n)) > 0.2).to(dev)
    valid[1, n // 2 :] = False  # an invalid tail, as a downsampled scene has
    grasps = torch.from_numpy(_grasps(rng, b, g)).to(dev)
    params = pack_grasp_params(grasps, 0.03, 0.01, 0.06)
    before = _build.launches["collision"]
    got = collision_counts(points, valid, params)
    assert _build.launches["collision"] == before + 1
    want = collision_counts_plain(points, valid, params)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    coll, empty = collision_detect(points, grasps, scene_valid=valid, return_empty_grasp=True)
    coll_p, empty_p = collision_detect(points, grasps, scene_valid=valid, return_empty_grasp=True, plain=True)
    assert torch.equal(coll, coll_p) and torch.equal(empty, empty_p)


def _check_collision(points, valid, params):
    """One counted launch, equal to the plain counts; returns them."""
    before = _build.launches["collision"]
    got = collision_counts(points, valid, params)
    assert _build.launches["collision"] == before + 1
    torch.testing.assert_close(got, collision_counts_plain(points, valid, params), atol=0, rtol=0)
    return got


def _scene_rows(rng, b, g, points):
    """Decoded-range grasps centred on points of the scene."""
    rows = _grasps(rng, b, g)
    pts = points.cpu().numpy()
    rows[..., 13:16] = pts[np.arange(b)[:, None], rng.integers(0, pts.shape[1], (b, g))]
    return rows


def test_collision_kernel_on_box_faces(dev, rng):
    """Points on every face of every grasp's boxes, and an ulp or two off."""
    g = 48
    rows = _grasps(rng, 1, g)
    params = pack_grasp_params(torch.from_numpy(rows), 0.03, 0.01, 0.06)
    m = params[0, :, :9].reshape(g, 3, 3).double()  # rows: the gripper axes
    f = [params[0, :, c] for c in range(12, 20)]  # zlo zhi dep dfl dflw dflwa w2 w2fw
    gx = torch.stack([f[2], f[3], f[4], f[5], (f[2] + f[5]) / 2], -1)
    gy = torch.stack([-f[7], -f[6], f[6], f[7], torch.zeros_like(f[6])], -1)
    gz = torch.stack([f[0], f[1], torch.zeros_like(f[0])], -1)
    ix, iy, iz = torch.meshgrid(torch.arange(5), torch.arange(5), torch.arange(3), indexing="ij")
    frame = torch.stack([gx[:, ix.flatten()], gy[:, iy.flatten()], gz[:, iz.flatten()]], -1).double()
    world = params[0, :, None, 9:12].double() + torch.linalg.solve(m.unsqueeze(1), frame.unsqueeze(-1))[..., 0]
    pts = world.float().reshape(1, -1, 3)
    nudge = torch.from_numpy(rng.integers(-2, 3, pts.shape)).float()
    pts = torch.nextafter(torch.nextafter(pts, pts + nudge), pts + nudge)
    valid = torch.ones(pts.shape[:2], dtype=torch.bool)
    counts = _check_collision(pts.to(dev), valid.to(dev), params.to(dev))
    assert float(counts[..., 4].sum()) > 0


def test_collision_kernel_grasps_touching_tiles(dev, rng):
    """Grasps placed so that a box face meets a tile's bounding box from each
    side, on each axis, then moved by up to 3 ulps either way."""
    n = 256
    points = torch.from_numpy(rng.uniform(-0.05, 0.05, (1, n, 3)).astype(np.float32))
    valid = torch.ones((1, n), dtype=torch.bool)
    tiles = points[0].reshape(-1, 32, 3)
    lo, hi = tiles.amin(dim=1), tiles.amax(dim=1)
    rows = []
    for t in range(tiles.shape[0]):
        for axis in range(3):
            for side in range(2):
                for ulps in range(-3, 4):
                    row = np.zeros(17, np.float32)
                    row[1], row[2], row[3] = 0.04, 0.02, 0.02
                    row[4:13] = np.eye(3, dtype=np.float32).reshape(9)  # gripper frame = world
                    center = ((lo[t] + hi[t]) / 2).numpy().copy()
                    # faces in the gripper frame: x in (d - 0.1, d), |y| < w/2 + 0.01, |z| < h/2
                    face = [(row[3] - 0.1, row[3]), (-(row[1] / 2 + 0.01), row[1] / 2 + 0.01),
                            (-row[2] / 2, row[2] / 2)][axis]
                    edge = float(hi[t, axis]) if side else float(lo[t, axis])
                    c = np.float32(edge - face[0] if side else edge - face[1])
                    for _ in range(abs(ulps)):
                        c = np.nextafter(c, np.float32(np.inf if ulps > 0 else -np.inf))
                    center[axis] = c
                    row[13:16] = center
                    rows.append(row)
    grasps = torch.from_numpy(np.stack(rows))[None]
    params = pack_grasp_params(grasps, 0.03, 0.01, 0.06)
    _check_collision(points.to(dev), valid.to(dev), params.to(dev))


@pytest.mark.parametrize("order", ["voxel", "random"])
def test_collision_kernel_point_orders(dev, rng, order):
    """The downsampled scene's lexicographic voxel order (tiles are thin
    slabs in x) and a random order (tiles span the scene)."""
    cloud = torch.from_numpy(rng.uniform(-0.3, 0.3, (2, 20000, 3)).astype(np.float32))
    cloud[..., 2] = cloud[..., 2] * 0.1 + 0.45
    points, valid = voxel_downsample_fixed(cloud.to(dev))
    if order == "random":
        perm = torch.from_numpy(rng.permutation(points.shape[1])).to(dev)
        points, valid = points[:, perm].contiguous(), valid[:, perm].contiguous()
    params = pack_grasp_params(torch.from_numpy(_scene_rows(rng, 2, 1024, points[:, :4000])).to(dev),
                               0.03, 0.01, 0.06)
    _check_collision(points, valid, params)


@pytest.mark.parametrize("case", ["all_invalid", "not_a_prefix"])
def test_collision_kernel_valid_sets(dev, rng, case):
    points = torch.from_numpy(rng.uniform(-0.1, 0.1, (3, 3000, 3)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random((3, 3000)) > 0.5).to(dev)
    valid[0] = False  # one scene with no valid point
    if case == "all_invalid":
        valid[:] = False
    else:
        valid[1, :1000] = False  # valid points only after an invalid head
        valid[2, 1000:2000] = False  # and a hole in the middle
    params = pack_grasp_params(torch.from_numpy(_scene_rows(rng, 3, 100, points)).to(dev), 0.03, 0.01, 0.06)
    counts = _check_collision(points, valid, params)
    assert not bool(counts[0].any())


@pytest.mark.parametrize("g", [1, 31, 33, 1000])
def test_collision_kernel_grasp_counts(dev, rng, g):
    points = torch.from_numpy(rng.uniform(-0.1, 0.1, (2, 2000, 3)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random((2, 2000)) > 0.1).to(dev)
    params = pack_grasp_params(torch.from_numpy(_scene_rows(rng, 2, g, points)).to(dev), 0.03, 0.01, 0.06)
    _check_collision(points, valid, params)


@pytest.mark.parametrize("n", [1, 5, 31])
def test_collision_kernel_cloud_below_a_tile(dev, rng, n):
    points = torch.from_numpy(rng.uniform(-0.02, 0.02, (2, n, 3)).astype(np.float32)).to(dev)
    valid = torch.ones((2, n), dtype=torch.bool, device=dev)
    params = pack_grasp_params(torch.from_numpy(_scene_rows(rng, 2, 40, points)).to(dev), 0.03, 0.01, 0.06)
    _check_collision(points, valid, params)


def test_collision_kernel_duplicated_grasps(dev, rng):
    """Equal grasps (equal centers, ties in the ranking) each get the full
    count, at their own index."""
    points = torch.from_numpy(rng.uniform(-0.1, 0.1, (1, 4000, 3)).astype(np.float32)).to(dev)
    valid = torch.ones((1, 4000), dtype=torch.bool, device=dev)
    rows = _scene_rows(rng, 1, 64, points)
    rows[0, 5:9] = rows[0, 4]
    rows[0, 32:] = rows[0, :32]
    params = pack_grasp_params(torch.from_numpy(rows).to(dev), 0.03, 0.01, 0.06)
    counts = _check_collision(points, valid, params)
    assert torch.equal(counts[0, 32:], counts[0, :32])


def test_collision_kernel_non_orthonormal_rotations(dev, rng):
    """Scaled, sheared and singular rotation columns: the world bounds step
    aside and the gripper-frame test still holds."""
    points = torch.from_numpy(rng.uniform(-0.1, 0.1, (1, 3000, 3)).astype(np.float32)).to(dev)
    valid = torch.ones((1, 3000), dtype=torch.bool, device=dev)
    rows = _scene_rows(rng, 1, 96, points)
    rot = rows[0, :, 4:13].reshape(96, 3, 3)
    rot[:32] *= rng.uniform(0.3, 3.0, (32, 1, 3)).astype(np.float32)  # scaled columns
    rot[32:64, 0] += rng.normal(0.0, 0.5, (32, 3)).astype(np.float32)  # sheared
    rot[64:, :, 2] = rot[64:, :, 1]  # singular
    rows[0, :, 4:13] = rot.reshape(96, 9)
    params = pack_grasp_params(torch.from_numpy(rows).to(dev), 0.03, 0.01, 0.06)
    _check_collision(points, valid, params)


def test_collision_kernel_culls_as_its_twin(dev, rng):
    """The kernel's count of kept (group, tile) pairs is the twin's
    (ops/collision.py:cull_share), and culling leaves the counts exact."""
    cloud = torch.from_numpy(rng.uniform(-0.3, 0.3, (2, 20000, 3)).astype(np.float32))
    points, valid = voxel_downsample_fixed(cloud.to(dev))
    params = pack_grasp_params(torch.from_numpy(_scene_rows(rng, 2, 512, points[:, :5000])).to(dev),
                               0.03, 0.01, 0.06)
    counts, stats = collision_cull_stats(points, valid, params)
    torch.testing.assert_close(counts, collision_counts_plain(points, valid, params), atol=0, rtol=0)
    assert stats == cull_share(points, valid, params)
    assert stats[0] < stats[1]


def _check_scatter(idx, ct_int, ct, n):
    """Integer cotangents exactly, two launches bit-equal, float cotangents
    within 1e-5 of the largest float64 sum and within the worst-case bound
    of recursive f32 summation, (rows - 1) * 2^-24 * sum |ct| per output."""
    before = _build.launches["scatter"]
    got = scatter_add(ct_int, idx, n)
    assert _build.launches["scatter"] == before + 1
    torch.testing.assert_close(got, scatter_add_plain(ct_int, idx, n), atol=0, rtol=0)
    first, second = scatter_add(ct, idx, n), scatter_add(ct, idx, n)
    assert torch.equal(first, second)  # deterministic, bit for bit
    exact = scatter_add_plain(ct.double(), idx, n)
    torch.testing.assert_close(first.double(), exact, atol=1e-5 * max(1.0, float(exact.abs().max())), rtol=0)
    rows = scatter_add_plain(torch.ones_like(ct[..., :1], dtype=torch.float64), idx, n)
    limit = (rows - 1).clamp(min=0) * 2.0**-24 * scatter_add_plain(ct.abs().double(), idx, n)
    assert bool(((first.double() - exact).abs() <= limit).all())


@pytest.mark.parametrize(
    "b,r,n,c",
    [(2, 131072, 2048, 128), (1, 5, 3, 1), (2, 0, 7, 4), (3, 3000, 33, 33), (1, 20000, 5000, 200), (2, 1025, 2049, 257),
     (2, 32768, 1024, 256), (1, 8192, 20000, 128), (2, 6161, 40000, 7), (1, 3000, 70, 130)],
)
def test_scatter_kernel_edge_cases(dev, rng, b, r, n, c):
    idx = rng.integers(0, n, size=(b, r))
    idx[:, ::9] = -1  # dropped rows
    idx[:, 1::4] = idx[:, :1]  # one destination takes a quarter of the rows
    idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
    ct_int = torch.from_numpy(rng.integers(-8, 9, size=(b, r, c)).astype(np.float32)).to(dev)
    ct = torch.from_numpy(rng.standard_normal((b, r, c)).astype(np.float32)).to(dev)
    _check_scatter(idx, ct_int, ct, n)


@pytest.mark.parametrize("hot", [63, 64, 65, 4096])
def test_scatter_kernel_hot_destination(dev, rng, hot):
    """One destination takes `hot` rows spread over the batch row (segments
    of one sum chunk, just over it, and of 64 chunks), the others few."""
    b, r, n, c = 2, 8192, 1024, 128
    idx = rng.integers(0, n, size=(b, r))
    idx[:, rng.choice(r, hot, replace=False)] = 5
    idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
    ct_int = torch.from_numpy(rng.integers(-8, 9, size=(b, r, c)).astype(np.float32)).to(dev)
    ct = torch.from_numpy(rng.standard_normal((b, r, c)).astype(np.float32)).to(dev)
    _check_scatter(idx, ct_int, ct, n)


def test_scatter_kernel_unaligned_rows(dev, rng):
    """ct and out rows off 16 bytes (C % 4 != 0) and ct at an odd offset:
    the kernel's scalar path."""
    b, r, n, c = 2, 5000, 300, 6
    idx = torch.from_numpy(rng.integers(-1, n, size=(b, r)).astype(np.int32)).to(dev)
    flat = torch.from_numpy(rng.integers(-8, 9, size=b * r * c + 1).astype(np.float32)).to(dev)
    ct_int = flat[1:].view(b, r, c)
    ct = torch.from_numpy(rng.standard_normal((b, r, c)).astype(np.float32)).to(dev)
    _check_scatter(idx, ct_int, ct, n)


def test_scatter_kernel_refuses_what_it_cannot_take(dev):
    idx = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="float32"):
        scatter_add(torch.zeros((1, 8, 4), dtype=torch.float64, device=dev), idx, 4)
    with pytest.raises(ValueError, match="int32"):
        scatter_add(torch.zeros((1, 8, 4), device=dev), idx.long(), 4)


@pytest.mark.parametrize("op", ["gather", "group"])
def test_gather_backward_is_the_kernel(dev, rng, op):
    """The gradient of a gather through the kernel against the plain
    gather's own autograd (index_select, whose backward is index_add_), on
    the LocalAggregation shape of the training step's stage 2 (B=2, 1024
    centers x 32 neighbours of 1024 rows, C=256)."""
    pts = torch.from_numpy(rng.standard_normal((2, 1024, 256)).astype(np.float32)).to(dev)
    shape = (2, 1024) if op == "gather" else (2, 1024, 32)
    idx = torch.from_numpy(rng.integers(0, 1024, size=shape).astype(np.int32)).to(dev)
    w = torch.from_numpy(rng.standard_normal(shape + (256,)).astype(np.float32)).to(dev)
    grads = []
    for fn, launched in ((gather_points if op == "gather" else group_points, 1), (_flat_take, 0)):
        p = pts.clone().requires_grad_(True)
        before = _build.launches["scatter"]
        (fn(p, idx) * w).sum().backward()
        assert _build.launches["scatter"] == before + launched
        grads.append(p.grad)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("reduction", ["max", "mean", "sum"])
@pytest.mark.parametrize(
    "k,n,c_parts,widths",
    [
        (64, 2048, (3,), (64, 64, 128)),  # sa1
        (64, 77, (3, 128), (128,)),  # block1_*, points off the tile
        (32, 1023, (3, 128), (128, 128, 256)),  # sa2
        (16, 513, (3, 256), (256,)),  # block3_*
        (8, 5, (7, 32), (32, 96)),
    ],
)
def test_mlpmax_kernel_shapes(dev, rng, reduction, k, n, c_parts, widths):
    parts = [torch.from_numpy(rng.standard_normal((2, n, k, c)).astype(np.float32)).to(dev) for c in c_parts]
    cin = (sum(c_parts),) + widths[:-1]
    ws = [torch.from_numpy((rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)).to(dev)
          for i, o in zip(cin, widths)]
    bs = [torch.from_numpy((rng.standard_normal(o) * 0.1).astype(np.float32)).to(dev) for o in widths]
    w0_parts = tuple(ws[0].split(list(c_parts), dim=0))
    weights = ((w0_parts, bs[0]), *zip(ws[1:], bs[1:]))
    before = _build.launches["mlpmax"]
    got = mlp_max_fused(parts, weights, reduction=reduction)
    assert _build.launches["mlpmax"] == before + 1
    want = mlp_max_fused_plain(parts, weights, reduction=reduction)
    assert got.shape == (2, n, widths[-1])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(got, mlp_max_fused(parts, weights, reduction=reduction))


@pytest.mark.parametrize("reduction", ["max", "mean", "sum"])
@pytest.mark.parametrize(
    "b,k,n,c_parts,widths,unaligned",
    [
        (1, 64, 3, (3,), (64, 64, 128), False),  # sa1's widths, N off the tile's 2 points
        (1, 32, 1027, (3, 256), (256,), False),  # the widest layer, 259 -> 256
        (2, 16, 515, (3, 256), (128, 128, 256), False),  # sa3 / sa4
        (1, 8, 17, (3, 128), (128,), False),  # 16 points a tile
        (2, 16, 40, (3, 32), (64, 64, 128, 256), False),  # four layers
        (1, 32, 9, (64,), (128,), False),  # one part, all on the tensor cores
        (2, 16, 11, (16, 40), (96,), False),  # two parts on the tensor cores
        (1, 64, 5, (3, 37), (64,), False),  # channels off the 16-byte copies
        (1, 16, 33, (3, 128), (128,), True),  # part b at an odd offset
    ],
)
def test_mlpmax_kernel_tiles(dev, rng, reduction, b, k, n, c_parts, widths, unaligned):
    """The tensor-core mlp-max kernel at its tile's edges (128 grouped rows):
    B = 1, N off the tile's points, one and two parts, the widest layer and
    four layers, within 1e-4 abs + rel of the plain version (3xTF32 against
    the plain f32 matmuls) and two launches bit-equal."""
    parts = []
    for c in c_parts:
        x = rng.standard_normal(b * n * k * c + 1).astype(np.float32)
        t = torch.from_numpy(x).to(dev)
        parts.append(t[1:].view(b, n, k, c) if unaligned and c > 3 else t[:-1].view(b, n, k, c))
    cin = (sum(c_parts),) + widths[:-1]
    ws = [torch.from_numpy((rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)).to(dev)
          for i, o in zip(cin, widths)]
    bs = [torch.from_numpy((rng.standard_normal(o) * 0.1).astype(np.float32)).to(dev) for o in widths]
    weights = ((tuple(ws[0].split(list(c_parts), dim=0)), bs[0]), *zip(ws[1:], bs[1:]))
    before = _build.launches["mlpmax"]
    got = mlp_max_fused(parts, weights, reduction=reduction)
    assert _build.launches["mlpmax"] == before + 1
    want = mlp_max_fused_plain(parts, weights, reduction=reduction)
    assert got.shape == (b, n, widths[-1])
    assert bool(((got - want).abs() <= 1e-4 * (1.0 + want.abs())).all()), float((got - want).abs().max())
    assert torch.equal(got, mlp_max_fused(parts, weights, reduction=reduction))


def test_mlpmax_kernel_refuses_what_it_cannot_take(dev):
    parts = (torch.zeros((1, 4, 24, 3), device=dev),)
    weights = (((torch.zeros((3, 32), device=dev),), torch.zeros(32, device=dev)),)
    with pytest.raises(ValueError, match="K in"):
        mlp_max_fused(parts, weights)
    parts = (torch.zeros((1, 4, 16, 3), device=dev),)
    with pytest.raises(ValueError, match="multiples of 32"):
        mlp_max_fused(parts, (((torch.zeros((3, 40), device=dev),), torch.zeros(40, device=dev)),))


@pytest.mark.parametrize("s", [1, 37])
def test_widthmlp_rel_kernel_matches_plain(dev, rng, s):
    head = init_random_(MultiScaleWidthGrouping(), seed=5).to(dev)
    rel = torch.from_numpy((rng.standard_normal((2, 4, 4, s, 64, 3)) * 0.05).astype(np.float32)).to(dev)
    weights = head.folded_weights()
    before = (_build.launches["widthmlp_rel"], _build.launches["widthmlp"])
    got = width_mlp_fused(rel, weights)
    assert (_build.launches["widthmlp_rel"], _build.launches["widthmlp"]) == (before[0] + 1, before[1])
    assert got.shape == (2, 4, s, 1024)
    torch.testing.assert_close(got, width_mlp_fused_plain(rel, weights), atol=1e-5, rtol=1e-5)
    assert torch.equal(got, width_mlp_fused(rel, weights))


def _width_inputs(rng, b, s, spread):
    """The same neighbourhoods in both width-MLP layouts: rel (B, R, H, S,
    K, 3) gripper-frame offsets of std ``spread``, and grouped (B, S, R, H,
    K, 3) = centers + rel @ rot^T with centers (B, S, 3), rot (B, S, 3, 3)."""
    rel = (rng.standard_normal((b, 4, 4, s, 64, 3)) * spread).astype(np.float32)
    centers = (rng.random((b, s, 3)) - 0.5).astype(np.float32)
    rot = _rotations(rng, (b, s))
    grouped = centers[:, :, None, None, None] + np.einsum("brhskj,bsij->bsrhki", rel, rot)
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)) for a in (rel, grouped, centers, rot)]


def _centred_biases(rel, weights):
    """The weights with b1 moved by each column's median pre-activation over
    ``rel``, and b2 by its 63/64 quantile: about half of layer 1's outputs,
    and about half of the maxima over 64 rows of layer 2's, then sit near 0,
    on both sides of the ReLU."""
    out = []
    for ri, ((w0, b0), (w1, b1), (w2, b2)) in enumerate(weights):
        x = rel[:, ri].reshape(-1, 3)
        h1 = torch.relu(x @ w0 + b0)
        b1 = b1 - (h1 @ w1 + b1).median(dim=0).values
        h2 = torch.relu(h1 @ w1 + b1)
        b2 = b2 - torch.quantile(h2 @ w2 + b2, 63 / 64, dim=0)
        out.append(((w0, b0), (w1, b1), (w2, b2)))
    return tuple(out)


@pytest.mark.parametrize("layout", ["rot", "rel"])
@pytest.mark.parametrize("case", ["seeds_off_the_stride", "ten_times_the_spread", "relu_edges"])
def test_widthmlp_kernels_edge_cases(dev, rng, layout, case):
    """Both layouts: a seed count whose groups are no multiple of the
    persistent blocks' stride over a scale (the SM count / 4), coordinates
    of 10x the usual spread, and pre-activations centred on 0. Within 1e-5
    (3xTF32 on the tensor cores against the plain f32 matmuls) and two
    launches bit-equal."""
    b, s, spread = {"seeds_off_the_stride": (2, 1000, 0.05), "ten_times_the_spread": (2, 37, 0.5),
                    "relu_edges": (2, 37, 0.05)}[case]
    rel, grouped, centers, rot = (a.to(dev) for a in _width_inputs(rng, b, s, spread))
    weights = init_random_(MultiScaleWidthGrouping(), seed=5).to(dev).folded_weights()
    if case == "relu_edges":
        weights = _centred_biases(rel, weights)
    if layout == "rot":
        run = lambda: width_mlp_fused_rot(grouped, centers, rot, weights)  # noqa: E731
        want = width_mlp_fused_rot_plain(grouped, centers, rot, weights)
    else:
        run = lambda: width_mlp_fused(rel, weights)  # noqa: E731
        want = width_mlp_fused_plain(rel, weights)
    got = run()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(got, run())
    if case == "relu_edges":
        assert 0.05 < float((want == 0).float().mean()) < 0.95


def _obs_scenes(rng, counts, n=3000):
    """Points (B, n, 3) and instance labels with counts[b] objects in scene
    b (plus background), every object non-empty."""
    pts = (rng.random((len(counts), n, 3)) - 0.5).astype(np.float32)
    labels = np.stack([rng.permutation(np.arange(n) % (k + 1)) for k in counts]).astype(np.int32)
    return torch.from_numpy(pts), torch.from_numpy(labels)


@pytest.mark.parametrize("counts,num_seed", [((6, 7), 32), ((7, 6), 32), ((3, 5, 11), 64), ((16, 1), 1024)])
def test_obs_through_the_masked_kernel_matches_plain(dev, rng, counts, num_seed):
    """OBS's masked FPS stops at max_needed_steps and writes 0 past it; the
    seeds must equal the plain version's, which selects every slot. At
    num_seed=32 the 7-object scene's last object reads 8 slots, more than
    the 6-object scene's 7."""
    pts, labels = (a.to(dev) for a in _obs_scenes(rng, counts))
    before = _build.launches["fps_masked"]
    got = object_balance_indices(pts, labels, num_seed=num_seed)
    assert _build.launches["fps_masked"] == before + 1
    want = object_balance_indices(pts, labels, num_seed=num_seed, plain=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("n,k", [(1, 4), (31, 16), (3001, 64), (20000, 64), (500, 100)])
def test_select_kernel_edge_cases(dev, rng, n, k):
    rows = 21
    cls = rng.integers(0, 5, (rows, n)) * 8 + rng.integers(0, 5, (rows, n))
    cls[rng.random((rows, n)) < 0.5] = 63
    cls[0] = 63  # no hit in any combo
    cls[1, : max(n - 3, 0)] = 63  # fewer hits than k
    cls = torch.from_numpy(cls.astype(np.uint8)).to(dev)
    before = _build.launches["select"]
    got = multicyl_select(cls, 4, 4, k)
    assert _build.launches["select"] == before + 1
    torch.testing.assert_close(got, multicyl_select_plain(cls, 4, 4, k), atol=0, rtol=0)
    assert bool((got[0] == 0).all())
    assert torch.equal(got, multicyl_select(cls, 4, 4, k))


def _check_select(cls, n_r, n_h, k):
    before = _build.launches["select"]
    got = multicyl_select(cls, n_r, n_h, k)
    assert _build.launches["select"] == before + 1
    torch.testing.assert_close(got, multicyl_select_plain(cls, n_r, n_h, k), atol=0, rtol=0)
    assert torch.equal(got, multicyl_select(cls, n_r, n_h, k))
    return got


def _class_rows(rng, rows, n):
    """Class planes of mixed rows: sparse and dense hits, values above 63,
    a row with no hit and one whose hits come last."""
    cls = rng.integers(0, 8, (rows, n)) * 8 + rng.integers(0, 8, (rows, n))
    cls[: rows // 2][rng.random((rows // 2, n)) < 0.9] = 63
    cls[-1] = rng.integers(0, 256, n)
    cls[-2] = 63
    cls[-3] = 63
    cls[-3, -3:] = 0
    return cls.astype(np.uint8)


@pytest.mark.parametrize("n_r,n_h", [(1, 1), (2, 7), (7, 2), (3, 5), (4, 4)])
def test_select_kernel_combo_shapes(dev, rng, n_r, n_h):
    cls = torch.from_numpy(_class_rows(rng, 21, 3001)).to(dev)
    _check_select(cls, n_r, n_h, 64)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 511, 513, 3001, 20000])
def test_select_kernel_row_lengths(dev, rng, n):
    """Row lengths around the 16-byte loads and the 512-point step; with
    rows of n bytes every row starts at another offset in its chunk."""
    cls = torch.from_numpy(_class_rows(rng, 21, n)).to(dev)
    _check_select(cls, 4, 4, 64)


@pytest.mark.parametrize("offset", list(range(1, 16)))
def test_select_kernel_unaligned(dev, rng, offset):
    """A plane that starts `offset` bytes into its allocation (a slice of a
    larger buffer)."""
    rows, n = 21, 2048
    flat = torch.from_numpy(_class_rows(rng, rows + 1, n).reshape(-1)).to(dev)
    cls = flat[offset : offset + rows * n].view(rows, n)
    assert cls.data_ptr() % 16 == offset % 16
    _check_select(cls, 4, 4, 64)


@pytest.mark.parametrize("k", [1, 32, 33, 100])
def test_select_kernel_k(dev, rng, k):
    cls = torch.from_numpy(_class_rows(rng, 21, 3001)).to(dev)
    _check_select(cls, 4, 4, k)


def test_select_kernel_fills_in_the_first_step(dev, rng):
    """Rows whose every combo holds k hits within the first 512 points
    (every 32-lane scan field at its largest), beside rows that never
    fill."""
    cls = np.full((16, 3001), 63, np.uint8)
    cls[:8] = 0
    cls[4:8, 100:] = rng.integers(0, 64, (4, 2901))
    cls[8:, ::97] = 0
    cls = torch.from_numpy(cls).to(dev)
    got = _check_select(cls, 4, 4, 100)
    assert bool((got[:4] == torch.arange(100, dtype=torch.int32, device=dev)).all())


def test_select_kernel_matches_the_cylinder_query(dev, rng):
    b, n, m = 2, 3001, 77
    cloud = (rng.random((b, n, 3)) - 0.5).astype(np.float32) * 0.4
    centers = np.take_along_axis(cloud, rng.integers(0, n, size=(b, m))[..., None], axis=1)
    centers[:, -5:] = 50.0
    args = [torch.from_numpy(a).to(dev) for a in (cloud, centers, _rotations(rng, (b, m)))]
    idx, _ = multi_cylinder_group(*args, RADII, HMIN, HMAXS, 64)
    cls = class_plane(*args, RADII, HMIN, HMAXS).reshape(b * m, n)
    got = multicyl_select(cls, 4, 4, 64).reshape(b, m, 4, 4, 64).permute(0, 2, 3, 1, 4)
    torch.testing.assert_close(got, idx, atol=0, rtol=0)


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize(
    "m,n",
    [(1, 1), (19968, 128), (300, 77), (33, 4000), (65536, 128), (1000, 131), (50000, 96), (20000, 1030),
     (3, 50000)],
)
def test_table_gather_kernel_shapes(dev, rng, dim, m, n):
    x = torch.from_numpy(rng.random((m, n)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, (m, n)[dim], (m, n)).astype(np.int32)).to(dev)
    before = _build.launches["table_gather"]
    got = table_gather(x, idx, dim)
    assert _build.launches["table_gather"] == before + 1
    torch.testing.assert_close(got, table_gather_plain(x, idx, dim), atol=0, rtol=0)
    torch.testing.assert_close(got, torch.gather(x, dim, idx.long()), atol=0, rtol=0)
    assert torch.equal(got, table_gather(x, idx, dim))


@pytest.mark.parametrize("dim", [0, 1])
def test_table_gather_kernel_unaligned(dev, rng, dim):
    """Tables and indices at an odd offset with N % 4 == 0: the scalar path."""
    m, n = 777, 128
    x = torch.from_numpy(rng.random(m * n + 1).astype(np.float32)).to(dev)[1:].view(m, n)
    idx = torch.from_numpy(rng.integers(0, (m, n)[dim], m * n + 1).astype(np.int32)).to(dev)[1:].view(m, n)
    got = table_gather(x, idx, dim)
    torch.testing.assert_close(got, torch.gather(x, dim, idx.long()), atol=0, rtol=0)


def test_table_gather_kernel_refuses_rows_past_shared_memory(dev):
    """dim 1 stages a whole row in one block's shared memory (227 KB)."""
    x = torch.zeros((2, 58113), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        table_gather(x, torch.zeros_like(x, dtype=torch.int32), 1)


# --- the training loop's pieces on the card ------------------------------


def _analytic_batch(num_views):
    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch

    return make_batch(0, 2, SceneConfig(num_points=2000, num_views=num_views, max_grasp_points=1024,
                                        analytic_labels=True))


@pytest.mark.parametrize("num_views", [24, 300])
def test_expand_batch_labels_on_the_card(dev, num_views):
    """The device expansion equals the host's numpy tensors, except where a
    width lies within an ulp of GRASP_MAX_WIDTH."""
    from graspbalance_tpu_torch.labels.analytic import expand_batch_labels
    from graspbalance_tpu_torch.labels.geometry import GRASP_MAX_WIDTH

    host = _analytic_batch(num_views)
    geo = {k: torch.from_numpy(host[k]).to(dev) for k in ("obj_sizes", "grasp_pt_obj", "grasp_pt_mask")}
    got = expand_batch_labels(geo, num_views, 12, 4)
    edge = np.float32(GRASP_MAX_WIDTH)
    boundary = np.abs(host["grasp_widths"] - edge) <= np.spacing(edge)
    for key in ("grasp_labels", "grasp_widths", "grasp_tolerance"):
        differ = got[key].cpu().numpy() != host[key]
        assert not (differ & ~boundary).any(), (key, int(differ.sum()))


def test_transfer_cache_identity_hit_on_the_card(dev):
    """The same host array object uploads once (through pinned memory),
    a new one again; a broadcast array uploads one row, expanded."""
    from graspbalance_tpu_torch.train.loop import TransferCache

    cache = TransferCache(dev)
    static = np.broadcast_to(np.arange(12, dtype=np.float32).reshape(1, 3, 4), (5, 3, 4))
    varied = np.ones((5, 2), np.int32)
    first = cache.put({"static": static, "varied": varied})
    second = cache.put({"static": static, "varied": varied.copy()})
    assert second["static"] is first["static"] and second["varied"] is not first["varied"]
    assert first["static"].device.type == "cuda" and first["static"].shape == (5, 3, 4)
    assert dict(cache.uploads) == {"static": 1, "varied": 2}
    assert cache.uploaded_bytes == 12 * 4 + 2 * 5 * 2 * 4
    torch.cuda.synchronize()
    assert torch.equal(first["static"].cpu(), torch.from_numpy(np.array(static)))


# --- the tracer's rule on the card: every host wait through host_read ----

TRACE_STAGES = (  # tests/tiny.py's stage table
    (64, 0.08, 8, (16, 16, 32), 1, 0.16, 8),
    (32, 0.20, 8, (16, 16, 32), 1, 0.40, 8),
    (16, 0.40, 4, (16, 16, 32), 1, 0.80, 4),
    (8, 0.60, 4, (16, 16, 32), 1, 1.20, 4),
)


def _trace_scene():
    from graspbalance_tpu_torch.data.synthetic import SceneConfig

    return SceneConfig(num_points=256, num_views=24, max_objects=4, max_grasp_points=128,
                       grasp_points_per_object=24, num_objects=3, analytic_labels=True, emit_label_tensors=False,
                       table_extent=0.12, object_scatter=0.08)


@pytest.mark.parametrize("use_obs", [False, True])
def test_served_call_waits_only_in_host_read_on_the_card(dev, use_obs):
    """torch's sync debug mode flags no synchronising call outside
    ``trace.host_read`` in a served call, and the spans' device events read
    a positive time for the whole call."""
    from graspbalance_tpu_torch import trace
    from graspbalance_tpu_torch.data.synthetic import make_batch
    from graspbalance_tpu_torch.eval.pipeline import GraspInference
    from graspbalance_tpu_torch.models import DSN, GraspBalance

    model = init_random_(GraspBalance(backbone_stages=TRACE_STAGES, num_seed=32, num_view=24), 3)
    dsn = init_random_(DSN(((64, 0.2, 8, 16, 1), (32, 0.4, 8, 32, 1))), 4)
    infer = GraspInference(model, dsn, use_obs=use_obs, device=dev)
    cloud = make_batch(11, 2, _trace_scene())["point_clouds"]
    infer(cloud)  # the first call loads the kernels
    torch.cuda.synchronize()
    assert trace.syncs_outside_host_read(lambda: infer(cloud)) == []
    trace.enable(device_events=True)
    try:
        infer(cloud)
    finally:
        trace.disable()
    got = trace.take()
    call = next(s for s in got["spans"] if s["name"] == "gb.call")
    assert call["device_ms"] > 0 and got["counters"]["sync.copy_out"] == 2


def test_training_step_waits_only_in_host_read_on_the_card(dev):
    """The same for a training step on a batch uploaded through the loop's
    transfer cache, and ``step_timer``'s device time reads positive once
    flushed."""
    from graspbalance_tpu_torch import trace
    from graspbalance_tpu_torch.data.synthetic import make_batch
    from graspbalance_tpu_torch.train.config import Config, DataConfig, ModelConfig
    from graspbalance_tpu_torch.train.loop import TransferCache
    from graspbalance_tpu_torch.train.metrics import MetricAggregator, step_timer
    from graspbalance_tpu_torch.train.train_step import build_model, make_optimizer, train_step

    scene = _trace_scene()
    cfg = Config(model=ModelConfig(num_view=24, backbone_stages=TRACE_STAGES, num_seed=32),
                 data=DataConfig(num_points=scene.num_points, max_objects=scene.max_objects,
                                 max_grasp_points=scene.max_grasp_points, batch_size=2, analytic_labels=True))
    model = build_model(cfg, device=dev)
    optimizer, scheduler = make_optimizer(model, cfg, 8)
    cache = TransferCache(dev)

    def step(seed):
        return train_step(model, optimizer, scheduler, cache.put(make_batch(seed, 2, scene)), 0, cfg)

    step(0)
    torch.cuda.synchronize()
    assert trace.syncs_outside_host_read(lambda: step(1)) == []
    agg = MetricAggregator()
    for seed in (2, 3):
        with step_timer(out := {}, dev):
            out.update(step(seed))
        agg.update(out)
    window = agg.flush()
    assert window["time/step_ms"] > 0 and window["time/dispatch_ms"] > 0


# --- train-mode BatchNorm + ReLU (csrc/batchnorm.cu) ----------------------

BN_EPS = 1e-5
BN_MOMENTUM = 0.37
# the main path's shapes: the width head's last layer, a stage-2 block's
# expansion, the graspable head's conv2 (C % 4 != 0: the scalar route)
BN_SHAPES = [(2_097_152, 256), (262_144, 512), (32_768, 302)]
# against float64 on the kernel's own ReLU mask: the forward within 1e-5
# abs + rel (the statistics are float32 sums of up to 2M rows in another
# order), dx, dweight and dbias within 1e-4 of their largest |value| (the
# same sums, then the closed-form backward's two per-channel sums), the
# running statistics within 1e-5
BN_Y_TOL = 1e-5
BN_GRAD_TOL = 1e-4
BN_STAT_TOL = 1e-5


def _bn_inputs(dev, rows, c, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, c, device=dev, generator=g) * 2 + 1
    dy = torch.randn(rows, c, device=dev, generator=g)
    w = 1 + 0.1 * torch.randn(c, device=dev, generator=g)
    b = 0.1 * torch.randn(c, device=dev, generator=g)
    rm = 0.1 * torch.randn(c, device=dev, generator=g)
    rv = 0.5 + torch.rand(c, device=dev, generator=g)
    return x, dy, w, b, rm, rv


def _bn_run(fn, x, dy, w, b, rm, rv, act, **kw):
    """(y, running mean, running var, dx, dweight, dbias) of ``fn``."""
    xg, wg, bg = (t.clone().requires_grad_(True) for t in (x, w, b))
    rm, rv = rm.clone(), rv.clone()
    y = fn(xg, wg, bg, rm, rv, BN_MOMENTUM, BN_EPS, act, **kw)
    y.backward(dy)
    return y.detach(), rm, rv, xg.grad, wg.grad, bg.grad


def _bn_float64(x, dy, w, b, rm, rv, act, mask):
    """The same outputs in float64, the ReLU's gradient taken on ``mask``
    (the kernel's y > 0), so that an element within rounding of the ReLU's
    edge counts on the same side."""
    x, dy, w, b, rm, rv = (t.double() for t in (x, dy, w, b, rm, rv))
    n = x.shape[0]
    mean = x.mean(dim=0)
    var = (x * x).mean(dim=0) - mean * mean
    y = (x - mean) * (w / torch.sqrt(var + BN_EPS)) + b
    m = float(np.float32(BN_MOMENTUM))
    return (y.clamp(min=0) if act else y, (1 - m) * rm + m * mean, (1 - m) * rv + m * var * n / max(n - 1, 1),
            *bn_act_backward_plain(dy, x, w, b, BN_EPS, act, mask=mask))


def _bn_check(got, want):
    names = ("y", "running_mean", "running_var", "dx", "dweight", "dbias")
    for name, a, b in zip(names, got, want):
        err = float((a.double() - b).abs().max())
        if name == "y":
            limit = BN_Y_TOL * (1 + float(b.abs().max()))
        elif name.startswith("running"):
            limit = BN_STAT_TOL * (1 + float(b.abs().max()))
        else:
            limit = BN_GRAD_TOL * float(b.abs().max())
        assert err <= limit, f"{name}: {err:.3g} > {limit:.3g}"


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("rows,c", BN_SHAPES)
def test_batchnorm_kernel_at_the_path_shapes(dev, rows, c, act):
    """The kernels against float64 at the main path's shapes, and the plain
    float32 version held to the same limits."""
    inputs = _bn_inputs(dev, rows, c)
    got = _bn_run(bn_act_train, *inputs, act)
    want = _bn_float64(*inputs, act, got[0] > 0)
    _bn_check(got, want)
    plain = _bn_run(bn_act_train_plain, *inputs, act)
    _bn_check(plain, _bn_float64(*inputs, act, plain[0] > 0))


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("rows,c", [(1, 64), (5, 3), (1000, 1), (4097, 4), (999, 302), (3001, 1030), (333, 4096),
                                    (70_001, 128)])
def test_batchnorm_kernel_edge_shapes(dev, rows, c, act):
    """One row, rows off the 4-row rounds and the slabs, one channel,
    channels past one block (scalar at 1030, vector at 4096) and past the
    finalize block's 1024."""
    inputs = _bn_inputs(dev, rows, c, seed=1)
    got = _bn_run(bn_act_train, *inputs, act)
    _bn_check(got, _bn_float64(*inputs, act, got[0] > 0))


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("rows,c", [(1_280_000, 3), (1_280_000, 4), (1_280_000, 32), (640_000, 8), (640_000, 64),
                                    (40_000, 256), (624, 512)])
def test_batchnorm_kernel_at_the_point_transformer_shapes(dev, rows, c, act):
    """The Point Transformer training step's (B * N * k, C) and (B * N, C)
    rows at bs=8: the position code's 3 channels, the attention weights'
    C / 8, the stages' widths."""
    inputs = _bn_inputs(dev, rows, c, seed=3)
    got = _bn_run(bn_act_train, *inputs, act)
    _bn_check(got, _bn_float64(*inputs, act, got[0] > 0))


def test_pt_backbone_on_the_card_is_its_plain_version(dev):
    """The Point Transformer backbone through FPS's and kNN's kernels
    against their plain versions, the rest on the same code: the eval end
    points and a train-mode step's gradients bit-equal."""
    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_point_clouds
    from graspbalance_tpu_torch.models.pt_backbone import PTBackbone

    stages = ((4096, 8, 32, 1), (1024, 16, 64, 1), (256, 16, 128, 1), (64, 16, 256, 1), (16, 16, 512, 1))
    model = init_random_(PTBackbone(stages, num_seed=256), seed=7).to(dev)
    xyz = torch.from_numpy(make_point_clouds(4, 2, SceneConfig(num_points=4096))).to(dev)
    w = torch.randn((256, 256), device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    outs = []
    for plain in (False, True):
        model.load_state_dict(state)
        model.eval()
        with torch.no_grad():
            ep = model(xyz, plain=plain)
        model.train()
        model.zero_grad()
        before = _build.launches["knn"]
        (model(xyz, plain=plain)["fp2_features"] * w).sum().backward()
        assert (_build.launches["knn"] > before) != plain
        outs.append((ep, {k: p.grad.clone() for k, p in model.named_parameters()}))
    (ep, grads), (ep_p, grads_p) = outs
    for key in ("fps_inds", "fp2_inds", "fp2_xyz", "fp2_features"):
        assert torch.equal(ep[key], ep_p[key]), key
    for key, g in grads.items():
        assert torch.equal(g, grads_p[key]), key


def test_batchnorm_kernel_is_deterministic(dev):
    inputs = _bn_inputs(dev, 262_144, 512, seed=2)
    first = _bn_run(bn_act_train, *inputs, True)
    second = _bn_run(bn_act_train, *inputs, True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("shape", [(8, 1024, 32, 128), (8, 4096, 302), (5, 7, 64)])
def test_batchnorm_kernel_forward_is_the_plain_version_bit_for_bit(dev, shape):
    """The module's kernel route against the plain version on the same
    tensor: the statistics from the same PyTorch reductions and the apply
    pass rounding op by op as the plain code, so y and the running
    statistics are bit-equal, with and without the ReLU."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(shape, device=dev, generator=g) * 2 + 1
    for act in (True, False):
        bn = BatchNorm(shape[-1]).to(dev).train()
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=g)
            bn.bias.uniform_(-0.1, 0.1, generator=g)
        rm, rv = bn.running_mean.clone(), bn.running_var.clone()
        y = bn(x, act=act)
        want = bn_act_train_plain(x, bn.weight, bn.bias, rm, rv, bn.momentum, bn.eps, act)
        assert torch.equal(y, want) and torch.equal(bn.running_mean, rm) and torch.equal(bn.running_var, rv)


def test_batchnorm_kernel_on_a_group_of_one(dev, tmp_path):
    """The data-parallel route (local sums, added over the group in float64
    by the wrapper) on a gloo group of one rank, against the local route."""
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a process group is already set up in this process")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        inputs = _bn_inputs(dev, 70_001, 64, seed=4)
        for act in (True, False):
            local = _bn_run(bn_act_train, *inputs, act)
            grouped = _bn_run(bn_act_train, *inputs, act, group=dist.group.WORLD)
            _bn_check(grouped, [t.double() for t in local])
    finally:
        dist.destroy_process_group()


def test_batchnorm_kernel_refuses_what_it_cannot_take(dev):
    w, b, rm, rv = (torch.ones(64, device=dev) for _ in range(4))
    args = (w, b, rm, rv, 0.1, BN_EPS, True)
    with pytest.raises(ValueError, match="float32"):
        bn_act_train(torch.zeros(8, 64, device=dev, dtype=torch.bfloat16), *args)
    with pytest.raises(ValueError, match="contiguous"):
        bn_act_train(torch.zeros(64, 16, device=dev).t(), *args)
    flat = torch.zeros(8 * 64 + 1, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        bn_act_train(flat[1:].view(8, 64), *args)
    with pytest.raises(ValueError, match="rows, C"):
        bn_act_train(torch.zeros(2, 4, 64, device=dev), *args)
    with pytest.raises(ValueError, match="channels"):
        bn_act_train(torch.zeros(8, 32, device=dev), *args)


def test_batchnorm_module_takes_the_kernels_in_train_mode(dev):
    """A train-mode float32 BatchNorm on the card launches each kernel once
    a forward and once a backward and counts ``bn.fused``; a non-contiguous
    or unaligned input is copied to aligned rows first; a bfloat16 module
    runs the plain version and counts ``bn.plain``; eval mode counts
    neither and launches nothing."""
    from graspbalance_tpu_torch import trace

    names = ("bn_apply", "bn_grad_reduce", "bn_grad_apply")
    base = torch.randn(2, 3, 50, 65, device=dev)
    flat = torch.randn(2 * 3 * 50 * 64 + 1, device=dev)
    trace.enable()
    try:
        for x in (base[..., :64], flat[1:].view(2, 3, 50, 64)):
            x = x.detach().requires_grad_(True)
            before = {k: _build.launches[k] for k in names}
            bn = BatchNorm(64).to(dev).train()
            y = bn(x, act=True)
            want = bn_act_train_plain(x.detach(), bn.weight, bn.bias, torch.zeros(64, device=dev),
                                      torch.ones(64, device=dev), bn.momentum, bn.eps, True)
            torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)
            y.sum().backward()
            assert all(_build.launches[k] == before[k] + 1 for k in names)
        BatchNorm(64, dtype=torch.bfloat16).to(dev).train()(base[..., :64])
        BatchNorm(64).to(dev).eval()(base[..., :64])
    finally:
        trace.disable()
    counters = trace.take()["counters"]
    assert counters.get("bn.fused") == 2 and counters.get("bn.plain") == 1


def test_mlp_block_fuses_its_relu_on_the_card(dev):
    torch.manual_seed(0)
    block = MLPBlock(32, 128).to(dev).train()
    x = torch.randn(4, 1024, 16, 32, device=dev)
    y = block(x)
    plain = torch.relu(bn_act_train_plain(block.dense(x), block.bn.weight, block.bn.bias,
                                          torch.zeros(128, device=dev), torch.ones(128, device=dev),
                                          block.bn.momentum, block.bn.eps, False))
    torch.testing.assert_close(y, plain, atol=1e-5, rtol=1e-5)
