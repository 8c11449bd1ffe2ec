"""Train-mode BatchNorm + ReLU (graspbalance_tpu_torch/ops/batchnorm.py) on
the CPU, where its plain version runs; the kernels themselves run on the
card (tests/test_torch_cuda.py).

  - ``bn_act_backward_plain``, the closed form that the kernels' backward
    computes, against autograd of ``bn_act_train_plain``: in float64 within
    1e-10, and in float32 within 1e-6 of each gradient's largest |value|
    (two float32 evaluations of the same per-channel sums over at most
    4,097 rows in other orders: autograd forms dx through the mean's and
    the variance's cotangents, the closed form from sum(g) and sum(g * d);
    each stays within 2.3e-7 of the float64 result on these inputs);
  - channel counts 3, 64, 302 (the graspable head's conv2) and 512, row
    counts that do not fill the kernels' 4-row rounds or their slabs, with
    and without the ReLU;
  - the running statistics' update at the schedule's first and last
    momenta (0.5, 0.001) against float64 arithmetic;
  - the data-parallel path (``group_moments``: sums added over the ranks in
    float64) on a process group of one gloo rank against the local path;
  - ``BatchNorm`` and ``MLPBlock`` outputs, running statistics and
    gradients on the CPU bit-equal to the formula the module had before
    the kernels (copied below), in both modes and both dtypes.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from graspbalance_tpu_torch import trace
from graspbalance_tpu_torch.nn.layers import BatchNorm, MLPBlock
from graspbalance_tpu_torch.ops.batchnorm import bn_act_backward_plain, bn_act_train, bn_act_train_plain
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

EPS = 1e-5
CASES = [(4097, 3), (1001, 64), (333, 302), (257, 512)]


def _inputs(rows, c, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, c)) * 2 + 1
    dy = rng.standard_normal((rows, c))
    w = 1 + 0.1 * rng.standard_normal(c)
    b = 0.1 * rng.standard_normal(c)
    return [torch.tensor(a, dtype=dtype) for a in (x, dy, w, b)]


def _autograd(x, dy, w, b, act):
    x, w, b = (t.clone().requires_grad_(True) for t in (x, w, b))
    rm, rv = torch.zeros_like(w.detach()), torch.ones_like(w.detach())
    y = bn_act_train_plain(x, w, b, rm, rv, 0.1, EPS, act)
    (y * dy).sum().backward()
    return x.grad, w.grad, b.grad


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("rows,c", CASES)
def test_backward_closed_form_matches_autograd_float64(rows, c, act):
    x, dy, w, b = _inputs(rows, c, torch.float64)
    for got, want in zip(bn_act_backward_plain(dy, x, w, b, EPS, act), _autograd(x, dy, w, b, act)):
        torch.testing.assert_close(got, want, atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("rows,c", CASES)
def test_backward_closed_form_matches_autograd_float32(rows, c, act):
    x, dy, w, b = _inputs(rows, c, torch.float32)
    for got, want in zip(bn_act_backward_plain(dy, x, w, b, EPS, act), _autograd(x, dy, w, b, act)):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("momentum", [0.5, 0.001])
@pytest.mark.parametrize("rows,c", CASES)
def test_running_statistics_update(rows, c, momentum):
    x, _, w, b = _inputs(rows, c, torch.float32)
    rng = np.random.default_rng(1)
    rm0 = rng.standard_normal(c).astype(np.float32)
    rv0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    rm, rv = torch.from_numpy(rm0.copy()), torch.from_numpy(rv0.copy())
    bn_act_train(x, w, b, rm, rv, momentum, EPS, True)
    xd = x.double().numpy()
    mean, var = xd.mean(0), xd.var(0)
    m = float(np.float32(momentum))
    np.testing.assert_allclose(rm.numpy(), (1 - m) * rm0 + m * mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rv.numpy(), (1 - m) * rv0 + m * var * rows / (rows - 1), rtol=1e-5, atol=1e-6)


@pytest.fixture
def group_of_one(tmp_path):
    if dist.is_initialized():
        pytest.skip("a process group is already set up in this process")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("act", [True, False])
def test_group_path_on_a_group_of_one(group_of_one, act):
    """The sums added over one rank in float64 give the local path's
    statistics, outputs and gradients within float32 rounding."""
    x, dy, w, b = _inputs(1001, 64, torch.float32)
    outs = []
    for group in (None, group_of_one):
        xg, wg, bg = (t.clone().requires_grad_(True) for t in (x, w, b))
        rm, rv = torch.zeros(64), torch.ones(64)
        y = bn_act_train_plain(xg, wg, bg, rm, rv, 0.5, EPS, act, group)
        (y * dy).sum().backward()
        outs.append((y.detach(), rm, rv, xg.grad, wg.grad, bg.grad))
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _parent_bn(bn, x):
    """BatchNorm.forward as the module had it before the kernels (one
    process, no data-parallel group)."""
    if not bn.training:
        mean, var = bn.running_mean, bn.running_var
    else:
        xf = x.to(bn.running_mean.dtype)
        axes = tuple(range(x.ndim - 1))
        mean = xf.mean(dim=axes)
        var = (xf * xf).mean(dim=axes) - mean * mean
        n = x.numel() // x.shape[-1]
        unbias = n / max(n - 1, 1)
        m = np.float32(bn.momentum)
        keep, m = float(np.float32(1.0) - m), float(m)
        with torch.no_grad():
            bn.running_mean.copy_(keep * bn.running_mean + m * mean)
            bn.running_var.copy_(keep * bn.running_var + m * (var * unbias))
    if bn.dtype == torch.float32:
        inv = bn.weight * (1.0 / torch.sqrt(var + bn.eps))
        return (x.to(mean.dtype) - mean) * inv + bn.bias
    d = bn.dtype
    inv = bn.weight.to(d) * (1.0 / torch.sqrt(var + bn.eps)).to(d)
    return (x.to(d) - mean.to(d)) * inv + bn.bias.to(d)


def _random_bn(c, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c, momentum=0.37, dtype=dtype)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
        bn.bias.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(c, generator=g))
    return bn


def _run(fn, module, x, dy):
    xg = x.clone().requires_grad_(True)
    y = fn(module, xg)
    (y.float() * dy).sum().backward()
    grads = [p.grad.clone() for p in module.parameters()]
    return [y.detach(), xg.grad, *grads, *(t.clone() for t in module.buffers())]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("shape", [(4, 50, 16), (2, 3, 5, 16), (7, 302)])
def test_batchnorm_on_the_cpu_bit_equal_to_the_parent(shape, training, dtype):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(2)) * 2 + 1
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    c = shape[-1]
    got = _run(lambda m, v: m(v), _random_bn(c, dtype, 4).train(training), x, dy)
    want = _run(_parent_bn, _random_bn(c, dtype, 4).train(training), x, dy)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("act", [True, False])
def test_mlp_block_on_the_cpu_bit_equal_to_the_parent(training, act):
    """MLPBlock with its ReLU fused into the norm against the dense layer,
    the parent's norm and torch.relu."""
    x = torch.randn((3, 40, 8, 24), generator=torch.Generator().manual_seed(5))
    dy = torch.randn((3, 40, 8, 64), generator=torch.Generator().manual_seed(6))

    def block():
        torch.manual_seed(7)
        mod = MLPBlock(24, 64, act=act)
        mod.bn.momentum = 0.5
        return mod.train(training)

    def parent(mod, v):
        y = _parent_bn(mod.bn, mod.dense(v))
        return torch.relu(y) if act else y

    for a, b in zip(_run(lambda m, v: m(v), block(), x, dy), _run(parent, block(), x, dy)):
        assert torch.equal(a, b)


def test_cpu_batchnorm_counts_neither_path():
    """The counters ``bn.fused`` and ``bn.plain`` count train-mode calls on
    CUDA tensors only."""
    trace.enable()
    try:
        BatchNorm(8).train()(torch.randn(32, 8))
    finally:
        trace.disable()
    counters = trace.take()["counters"]
    assert "bn.fused" not in counters and "bn.plain" not in counters


def test_bn_act_train_refuses_other_ranks():
    with pytest.raises(ValueError, match="rows, C"):
        bn_act_train(torch.zeros(2, 3, 4), torch.ones(4), torch.zeros(4), torch.zeros(4), torch.ones(4),
                     0.1, EPS, True)
