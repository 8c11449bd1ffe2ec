"""The gather backward (graspbalance_tpu_torch.ops.scatter and the autograd
of ops.gather) against the JAX package: the scatter-add's plain version
against the Pallas kernel scatter_add_matmul in interpret mode, and the
gradients of gather_points / group_points against jax.grad under both of the
JAX package's backward modes that the port stands in for ('pallas', the
kernel, and 'xla', autodiff's scatter-add).

Tolerances: integer-valued cotangents exactly (every partial sum is an
integer below 2^24, exact in f32 in any order); float cotangents within
2e-5 absolute (f32 sums of up to ~20 terms of |x| < 4 in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspbalance_tpu import ops as jops
from graspbalance_tpu.ops import gather as j_gather
from graspbalance_tpu.ops.pallas.scatter_kernel import scatter_add_matmul
from graspbalance_tpu_torch.ops import gather_points, group_points
from graspbalance_tpu_torch.ops.gather import _flat_take
from graspbalance_tpu_torch.ops.scatter import scatter_add, scatter_add_plain
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

FLOAT_TOL = 2e-5


def _case(rng, b, r, n, c, integer, hot):
    ct = rng.integers(-8, 9, size=(b, r, c)) if integer else rng.standard_normal((b, r, c))
    idx = rng.integers(0, n, size=(b, r))
    idx[:, ::7] = -1  # dropped rows
    idx[:, 1::5] = idx[:, :1]  # many duplicates of one destination
    if hot:
        idx[:] = n // 2  # every row on one destination
    return ct.astype(np.float32), idx.astype(np.int32)


# the kernel's cases: a hot segment longer than one sum chunk (64 rows);
# six whole sort tiles (1,024 rows each) and 17 rows, with more
# destinations than one histogram block holds (32,768); no rows; C off the float4 and past
# one pass of 128 channels
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize(
    "b,r,n,c,hot",
    [(2, 300, 50, 7, False), (1, 1000, 257, 33, False), (3, 17, 5, 1, False), (2, 150, 20, 5, True),
     (1, 3 * 2048 + 17, 33000, 3, False), (2, 0, 9, 4, False), (1, 400, 70, 130, False)],
    ids=["2-300-50-7", "1-1000-257-33", "3-17-5-1", "hot", "tiles", "no-rows", "c130"],
)
def test_scatter_add_matches_pallas_kernel(rng, integer, b, r, n, c, hot):
    ct, idx = _case(rng, b, r, n, c, integer, hot)
    if r == 0:  # the Pallas kernel takes no empty row axis: its definition, a zero tensor
        want = np.zeros((b, n, c), np.float32)
    else:
        want = np.asarray(scatter_add_matmul(jnp.asarray(ct), jnp.asarray(idx), n, interpret=True))
    got = scatter_add(torch.from_numpy(ct), torch.from_numpy(idx), n)
    assert got.shape == (b, n, c) and got.dtype == torch.float32
    if integer:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=FLOAT_TOL, rtol=0)
    np.testing.assert_array_equal(scatter_add_plain(torch.from_numpy(ct), torch.from_numpy(idx), n).numpy(),
                                  got.numpy())


def test_scatter_add_drops_out_of_range_rows():
    ct = torch.ones((1, 4, 2))
    idx = torch.tensor([[-1, 3, 1, 7]], dtype=torch.int32)
    want = torch.tensor([[[0.0, 0.0], [1.0, 1.0], [0.0, 0.0]]])
    torch.testing.assert_close(scatter_add(ct, idx, 3), want, atol=0, rtol=0)


def test_scatter_add_never_falls_back():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel's checks (a meta tensor is refused, not computed)."""
    ct = torch.empty((1, 8, 4), device="meta")
    idx = torch.empty((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        scatter_add(ct, idx, 4)
    with pytest.raises(ValueError, match="idx"):
        scatter_add(torch.zeros((1, 8, 4)), torch.zeros((1, 7), dtype=torch.int32), 4)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("op", ["gather_points", "group_points"])
@pytest.mark.parametrize("integer", [True, False])
def test_gather_gradient_matches_jax(rng, mode, op, integer):
    b, n, c = 2, 60, 9
    pts = rng.standard_normal((b, n, c)).astype(np.float32)
    shape = (b, 40) if op == "gather_points" else (b, 40, 6)
    idx = rng.integers(0, n, size=shape).astype(np.int32)
    idx[..., 1::3] = idx[..., :1]  # duplicates, as query padding repeats the first hit
    w = (rng.integers(-4, 5, size=shape + (c,)) if integer else rng.standard_normal(shape + (c,))).astype(np.float32)

    old = j_gather._GATHER_VJP
    try:
        j_gather.set_gather_vjp(mode)
        j_op = getattr(jops, op)
        want = np.asarray(jax.grad(lambda p: jnp.sum(j_op(p, jnp.asarray(idx)) * jnp.asarray(w)))(jnp.asarray(pts)))
    finally:
        j_gather.set_gather_vjp(old)

    p = torch.from_numpy(pts).requires_grad_(True)
    out = {"gather_points": gather_points, "group_points": group_points}[op](p, torch.from_numpy(idx))
    (out * torch.from_numpy(w)).sum().backward()
    if integer:
        np.testing.assert_array_equal(p.grad.numpy(), want)
    else:
        np.testing.assert_allclose(p.grad.numpy(), want, atol=FLOAT_TOL, rtol=0)


def test_indices_get_no_gradient_and_plain_backward_agrees(rng):
    """group_points' backward against the plain gather's own autograd
    (index_select, whose backward is index_add_: the same plain version)."""
    pts = torch.from_numpy(rng.standard_normal((2, 30, 5)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 30, size=(2, 12, 4)).astype(np.int32))
    grads = []
    for fn in (group_points, _flat_take):
        p = pts.clone().requires_grad_(True)
        fn(p, idx).square().sum().backward()
        grads.append(p.grad)
    torch.testing.assert_close(grads[0], grads[1], atol=0, rtol=0)
    with torch.no_grad():
        assert not group_points(pts.requires_grad_(True), idx).requires_grad
