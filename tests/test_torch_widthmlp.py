"""The port's fused width MLP (graspbalance_tpu_torch.ops.widthmlp) against
the JAX package's Pallas kernel width_mlp_fused_rot in interpret mode, with
the same BN-folded weights (random, non-trivial BN statistics); and the
error model of the CUDA kernel's arithmetic, 3xTF32 on the tensor cores,
emulated here on the CPU against a float64 MLP, at the width MLP's shapes
and at the fused group MLP + reduction's.

Tolerance: 1e-5 absolute and relative (f32; the products are summed in
another order, and layer 0's rotation fold is formed by broadcast sums on
one side and an einsum on the other). The 3xTF32 emulation within 1e-5 of
float64, the kernel's own bound on the card; one TF32 pass exceeds it. At
the fused group MLP + reduction's shapes the same within its 1e-4 abs +
rel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspbalance_tpu.ops.pallas.widthmlp_kernel import width_mlp_fused_rot as j_width_mlp_fused_rot
from graspbalance_tpu_torch.models.heads import MultiScaleWidthGrouping
from graspbalance_tpu_torch.ops.widthmlp import (
    width_mlp_fused_rot,
    width_mlp_fused_rot_plain,
)
from graspbalance_tpu_torch.weights import init_random_
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

TOL = 1e-5


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits) to nearest, ties away from zero,
    on the bit pattern: what cvt.rna.tf32.f32 does to a finite value."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel forms it: lo_a hi_b + hi_a lo_b + hi_a hi_b, the
    TF32 products exact, summed in f32 (lo_a lo_b dropped)."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _tf32(a) @ _tf32(b)


def _mlp_max(x, weights, matmul, dtype):
    """x (G, K, 3) -> (G, C_last): the scale MLP, ReLU after each layer,
    then the max over K; layer 0 in plain ``dtype`` (the kernel runs it on
    the CUDA cores in f32), layers 1 and 2 through ``matmul``."""
    (w0, b0), *tail = [(w.to(dtype), b.to(dtype)) for w, b in weights]
    h = torch.relu(x.to(dtype) @ w0 + b0)
    for w, b in tail:
        h = torch.relu(matmul(h, w) + b)
    return h.amax(dim=1)


@pytest.mark.parametrize("arith,within", [("3xtf32", True), ("tf32", False)])
def test_width_mlp_3xtf32_error_model(rng, arith, within):
    """At the kernel's widths (K=64, 3-64-128-256) on 64 groups of each
    scale: 3xTF32 stays within 1e-5 of float64, one TF32 pass does not;
    that is why the kernel pays for three products."""
    head = init_random_(MultiScaleWidthGrouping(), seed=5)
    x = torch.from_numpy((rng.standard_normal((64, 64, 3)) * 0.05).astype(np.float32))
    matmul = _matmul_3xtf32 if arith == "3xtf32" else _matmul_tf32
    err = 0.0
    for layers in head.folded_weights():
        got = _mlp_max(x, layers, matmul, torch.float32)
        want = _mlp_max(x, layers, lambda a, b: a @ b, torch.float64)
        assert float(want.abs().max()) > 0.1  # the comparison is not between near-zeros
        err = max(err, float((got.double() - want).abs().max()))
    assert (err <= TOL) == within, err


MLPMAX_TOL = 1e-4  # abs + rel: the fused group MLP + reduction's bound on the card


@pytest.mark.parametrize("arith,within", [("3xtf32", True), ("tf32", False)])
@pytest.mark.parametrize("k", [16, 32])
@pytest.mark.parametrize(
    "c_feat,widths",
    [(128, (128,)), (256, (256,)), (256, (128, 128, 256))],  # block1, block2-4, sa3/sa4
)
def test_mlpmax_3xtf32_error_model(rng, arith, within, k, c_feat, widths):
    """The fused group MLP + max kernel's arithmetic at the backbone's
    shapes, on 32 points of K grouped rows: layer 0's 3-channel offset part
    in plain f32 (the CUDA cores), its feature part and every later layer
    through ``matmul``, ReLU after each layer, the max over K. 3xTF32 stays
    within 1e-4 abs + rel of float64, one TF32 pass does not."""
    dp = torch.from_numpy(rng.standard_normal((32, k, 3)).astype(np.float32))
    feat = torch.from_numpy(np.abs(rng.standard_normal((32, k, c_feat))).astype(np.float32))
    cin = (3 + c_feat,) + widths[:-1]
    ws = [torch.from_numpy((rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)) for i, o in zip(cin, widths)]
    bs = [torch.from_numpy((rng.standard_normal(o) * 0.1).astype(np.float32)) for o in widths]
    matmul = _matmul_3xtf32 if arith == "3xtf32" else _matmul_tf32

    def run(mm, dtype):
        w = [x.to(dtype) for x in ws]
        h = torch.relu(dp.to(dtype) @ w[0][:3] + mm(feat.to(dtype), w[0][3:]) + bs[0].to(dtype))
        for wl, bl in zip(w[1:], bs[1:]):
            h = torch.relu(mm(h, wl) + bl.to(dtype))
        return h.amax(dim=1)

    got = run(matmul, torch.float32).double()
    want = run(lambda a, b: a @ b, torch.float64)
    assert float(want.abs().max()) > 0.5  # the comparison is not between near-zeros
    err = float(((got - want).abs() / (1.0 + want.abs())).max())
    assert (err <= MLPMAX_TOL) == within, err


def _inputs(rng, b, s, r, h, k):
    centers = (rng.random((b, s, 3)) - 0.5).astype(np.float32)
    grouped = centers[:, :, None, None, None, :] + (
        rng.standard_normal((b, s, r, h, k, 3)) * 0.05
    ).astype(np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((b, s, 3, 3)))
    return grouped.astype(np.float32), centers, q.astype(np.float32)


@pytest.mark.parametrize(
    "mlp,k",
    [((8, 12, 16), 16), ((64, 128, 256), 64)],  # narrow, and the kernel's own widths
)
def test_width_mlp_matches_jax_kernel(rng, mlp, k):
    head = init_random_(MultiScaleWidthGrouping(nsample=k, mlp=mlp), seed=3)
    weights = head.folded_weights()
    grouped, centers, rot = _inputs(rng, b=2, s=4, r=4, h=4, k=k)
    j_weights = tuple(
        tuple((jnp.asarray(w.numpy()), jnp.asarray(bias.numpy())) for w, bias in layers)
        for layers in weights
    )
    want = np.asarray(
        j_width_mlp_fused_rot(
            jnp.asarray(grouped), jnp.asarray(centers), jnp.asarray(rot), j_weights, interpret=True
        )
    )
    got = width_mlp_fused_rot(torch.from_numpy(grouped), torch.from_numpy(centers), torch.from_numpy(rot), weights)
    assert got.shape == (2, 4, 4, 4 * mlp[-1])
    assert np.abs(want).max() > 0.1  # the comparison is not between near-zeros
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_plain_seed_chunks_agree(rng):
    """The plain version's seed chunking changes nothing."""
    head = init_random_(MultiScaleWidthGrouping(nsample=8, mlp=(4, 6, 8)), seed=1)
    grouped, centers, rot = (torch.from_numpy(a) for a in _inputs(rng, b=1, s=10, r=4, h=4, k=8))
    whole = width_mlp_fused_rot_plain(grouped, centers, rot, head.folded_weights())
    chunked = width_mlp_fused_rot_plain(grouped, centers, rot, head.folded_weights(), seed_chunk=3)
    torch.testing.assert_close(chunked, whole, atol=0, rtol=0)


def test_kernel_checks_shapes(rng):
    head = init_random_(MultiScaleWidthGrouping(nsample=8, mlp=(4, 6, 8)), seed=1)
    grouped, centers, rot = (torch.from_numpy(a) for a in _inputs(rng, b=1, s=2, r=4, h=4, k=8))
    with pytest.raises(ValueError, match="centers"):
        width_mlp_fused_rot(grouped, centers[:, :1], rot, head.folded_weights())
    with pytest.raises(ValueError, match="one weight list per scale"):
        width_mlp_fused_rot(grouped, centers, rot, head.folded_weights()[:3])
