"""The three CUDA kernels against their plain PyTorch versions on the card,
at edge cases the main path's shapes do not reach: clouds whose size is
not a multiple of the block, exact distance ties, near-origin points,
seeds with no cylinder hit, fewer than K hits. Marked ``cuda``: they skip
where torch has no CUDA device, and run on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` because tests/conftest.py imports jax, which the card's
machine does not have; this file needs none of it.)

Tolerances: FPS and query indices and rotated coordinates exactly (both
sides round the same operations in the same order); the width MLP within
1e-5 (f32 FMA against the plain matmuls' summation order).
"""

import numpy as np
import pytest
import torch

from graspbalance_tpu_torch import _build
from graspbalance_tpu_torch.models.heads import MultiScaleWidthGrouping
from graspbalance_tpu_torch.ops.fps import furthest_point_sample, furthest_point_sample_plain
from graspbalance_tpu_torch.ops.multicyl import multi_cylinder_group, multi_cylinder_group_plain
from graspbalance_tpu_torch.ops.widthmlp import width_mlp_fused_rot, width_mlp_fused_rot_plain
from graspbalance_tpu_torch.weights import init_random_

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
    with pytest.raises(ValueError, match="float32"):
        furthest_point_sample(torch.zeros((1, 10, 3), dtype=torch.float64, device=dev), 4)
    with pytest.raises(ValueError, match="points"):
        furthest_point_sample(torch.zeros((1, 40000, 3), device=dev), 4)


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


def test_multicyl_kernel_fewer_combos(dev, rng):
    cloud = torch.from_numpy((rng.random((1, 500, 3)) - 0.5).astype(np.float32) * 0.3).to(dev)
    centers = cloud[:, :20].contiguous()
    rot = torch.from_numpy(_rotations(rng, (1, 20))).to(dev)
    args = (cloud, centers, rot, (0.05, 0.1), -0.02, (0.03,), 8)
    torch.testing.assert_close(
        multi_cylinder_group(*args)[0], multi_cylinder_group_plain(*args)[0], atol=0, rtol=0
    )


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
