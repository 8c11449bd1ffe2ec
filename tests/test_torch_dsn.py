"""The port's DSN + mean shift + OBS stack against the JAX package on the
same numpy inputs: exact kNN, masked FPS, mean-shift clustering with the JAX
package's own Gumbel draws injected, object-balanced seed indices, and the
DSN forward with bridged weights (the tiny DSN of tests/test_pipeline.py).

Tolerances: kNN indices exactly and distances within rtol 1e-6 / atol 1e-7
(the JAX kernel test's tolerance); masked-FPS prefixes, mean-shift labels and
keep masks, and OBS indices exactly; mean-shift centers within 1e-5 (the
hill-climbing matmuls sum in another order); DSN outputs within 1e-4
absolute + 1e-4 relative (f32, products summed in other orders).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspbalance_tpu.data.synthetic import make_batch
from graspbalance_tpu.eval.meanshift import mean_shift_cluster as j_mean_shift_cluster
from graspbalance_tpu.eval.obs import foreground_indices as j_foreground_indices
from graspbalance_tpu.eval.obs import foreground_sampling as j_foreground_sampling
from graspbalance_tpu.eval.obs import object_balance_indices as j_object_balance_indices
from graspbalance_tpu.eval.obs import object_balance_sampling as j_object_balance_sampling
from graspbalance_tpu.models.dsn import DSN as JDSN
from graspbalance_tpu.models.dsn import cluster as j_cluster
from graspbalance_tpu.ops.fps import _masked_fps_single_xla
from graspbalance_tpu.ops.knn import knn as j_knn
from graspbalance_tpu.ops.pallas.fps_kernel import fps_pallas_2d_batched_masked
from graspbalance_tpu.ops.pallas.knn_kernel import knn_pallas
from graspbalance_tpu_torch.eval.meanshift import mean_shift_cluster, subsampled_count
from graspbalance_tpu_torch.eval.obs import (
    foreground_indices,
    foreground_sampling,
    object_balance_indices,
    object_balance_sampling,
)
from graspbalance_tpu_torch.models.dsn import DSN, cluster
from graspbalance_tpu_torch.ops.fps import furthest_point_sample_masked
from graspbalance_tpu_torch.ops.knn import knn
from graspbalance_tpu_torch.weights import load_flax_variables, state_dict_from_flax
from test_torch_model import _random_variables
from tiny import TINY_SCENE
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

TINY_PT_STAGES = ((64, 0.2, 8, 16, 1), (32, 0.4, 8, 32, 1))
TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.asarray(x))


def jax_gumbel(key, b: int, m: int, num_seeds: int = 50) -> np.ndarray:
    """The Gumbel draws of the JAX package's ``cluster`` under ``key``:
    split(key, B) per scene, then split -> (k0, kloop) and split(kloop,
    num_seeds), each drawing ``jax.random.categorical``'s gumbel(k, (m,)).
    Returns (B, 1 + num_seeds, m) float32, the port's ``gumbel`` layout."""
    rows = []
    for kb in jax.random.split(key, b):
        k0, kloop = jax.random.split(kb)
        keys = [k0] + list(jax.random.split(kloop, num_seeds))
        rows.append(np.stack([np.asarray(jax.random.gumbel(k, (m,), jnp.float32)) for k in keys]))
    return np.stack(rows)


@pytest.mark.parametrize("b,q,r,k", [(2, 200, 300, 16), (1, 50, 128, 3), (2, 129, 1100, 32)])
def test_knn_matches_jax(b, q, r, k):
    rng = np.random.default_rng(q)
    query = rng.standard_normal((b, q, 3)).astype(np.float32)
    ref = rng.standard_normal((b, r, 3)).astype(np.float32)
    want_d, want_i = j_knn(jnp.asarray(ref), jnp.asarray(query), k)
    kern_d, kern_i = knn_pallas(jnp.asarray(query), jnp.asarray(ref), k, interpret=True)
    dist, idx = knn(_t(ref), _t(query), k)
    assert idx.dtype == torch.int32 and dist.shape == (b, q, k)
    for d, i in ((want_d, want_i), (kern_d, kern_i)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(i))
        np.testing.assert_allclose(dist.numpy(), np.asarray(d), rtol=1e-6, atol=1e-7)


def test_knn_tie_order():
    """Duplicated points: ties resolve to the lower index on both sides."""
    base = np.random.default_rng(3).standard_normal((1, 40, 3)).astype(np.float32)
    pts = np.repeat(base, 3, axis=1)
    want_d, want_i = j_knn(jnp.asarray(pts), jnp.asarray(pts), 5)
    dist, idx = knn(_t(pts), _t(pts), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(dist.numpy(), np.asarray(want_d), rtol=1e-6, atol=1e-7)
    assert np.all(idx.numpy()[0, 0, :3] == [0, 1, 2])


@pytest.mark.parametrize("b,q,r,k", [(2, 70, 128, 33), (1, 300, 500, 40), (2, 129, 1100, 64)])
def test_knn_beyond_the_kernel_matches_jax(b, q, r, k):
    """k > 32: the JAX knn takes lax.top_k, the port a stable sort."""
    rng = np.random.default_rng(k)
    query = rng.standard_normal((b, q, 3)).astype(np.float32)
    ref = rng.standard_normal((b, r, 3)).astype(np.float32)
    want_d, want_i = j_knn(jnp.asarray(ref), jnp.asarray(query), k)
    dist, idx = knn(_t(ref), _t(query), k)
    assert idx.dtype == torch.int32 and dist.shape == (b, q, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(dist.numpy(), np.asarray(want_d), rtol=1e-6, atol=1e-7)


def test_knn_beyond_the_kernel_tie_order():
    """k = 40 on points each present three times: the lower index wins."""
    base = np.random.default_rng(4).standard_normal((2, 50, 3)).astype(np.float32)
    pts = np.repeat(base, 3, axis=1)
    want_d, want_i = j_knn(jnp.asarray(pts), jnp.asarray(pts), 40)
    dist, idx = knn(_t(pts), _t(pts), 40)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(dist.numpy(), np.asarray(want_d), rtol=1e-6, atol=1e-7)
    assert np.all(idx.numpy()[:, ::3, 0] == np.arange(0, 150, 3))
    assert np.all(np.diff(idx.numpy()[..., :3], axis=-1) == 1)


def test_knn_refuses_what_it_cannot_take():
    pts = torch.zeros((1, 10, 3))
    with pytest.raises(ValueError):
        knn(pts, pts, 11)
    with pytest.raises(ValueError):
        knn(pts, pts, 4, method="approx")


def _masked_case(rng, case):
    """(xyz (S, N, 3), valid (S, N), needed) of one kind of row."""
    s, n = 5, 300
    xyz = (rng.random((s, n, 3)) - 0.5).astype(np.float32)
    valid = rng.random((s, n)) < 0.4
    needed = 20 if case == "20" else None
    if case in ("None", "20"):  # mixed rows
        valid[0] = False  # no valid point: index 0 everywhere
        valid[1, :150] = False  # the seed is the first valid index
        valid[2, 7:] = False  # fewer valid points than samples
    elif case == "prefix":  # OBS's compacted rows: the valid points lead
        valid[:] = np.arange(n) < np.array([0, 1, 40, 150, n])[:, None]
    elif case == "single_valid":  # picked again at distance 0, needed > 1
        valid[:] = False
        valid[np.arange(s), [0, 5, 150, 299, 77]] = True
        needed = 30
    elif case == "duplicates":  # every point 4 times: ties go to the lowest index
        g = rng.integers(-2, 3, (s, n // 4, 3)).astype(np.float32)
        xyz = np.repeat(g, 4, axis=1)[:, rng.permutation(n)]
    elif case == "no_valid":
        valid[:] = False
    elif case == "needed_1":
        needed = 1
    elif case == "all_valid":
        valid[:] = True
    return xyz, valid, needed


@pytest.mark.parametrize(
    "case", ["None", "20", "prefix", "single_valid", "duplicates", "no_valid", "needed_1", "all_valid"]
)
def test_masked_fps_matches_jax(case):
    """The port's masked FPS (its plain version on the CPU) against the JAX
    package's XLA path and its Pallas kernel (interpreted), over the first
    max_needed slots, on the rows the kernel's tie and key logic must get
    right."""
    rng = np.random.default_rng(5)
    xyz, valid, needed = _masked_case(rng, case)
    m = 64
    want = np.asarray(
        jax.vmap(lambda p, v: _masked_fps_single_xla(p, v, m))(jnp.asarray(xyz), jnp.asarray(valid))
    )
    kw = {} if needed is None else {"max_needed": jnp.int32(needed)}
    kern = np.asarray(fps_pallas_2d_batched_masked(jnp.asarray(xyz), jnp.asarray(valid), m, interpret=True, **kw))
    got = furthest_point_sample_masked(_t(xyz), _t(valid), m, max_needed=needed).numpy()
    upto = m if needed is None else needed
    np.testing.assert_array_equal(got[:, :upto], want[:, :upto])
    np.testing.assert_array_equal(got[:, :upto], kern[:, :upto])
    has = valid.any(axis=1)
    np.testing.assert_array_equal(got[:, 0], np.argmax(valid, axis=1))  # the first valid index, else 0
    assert np.all(got[~has] == 0)
    assert np.all(np.take_along_axis(valid, got[:, :upto].astype(np.int64), 1)[has])


def _meanshift_inputs(rng, b, n):
    """Predicted centers: a few tight blobs plus scatter, ~60% foreground."""
    blobs = rng.uniform(-0.3, 0.3, (5, 3))
    pts = blobs[rng.integers(0, 5, (b, n))] + rng.normal(0, 0.01, (b, n, 3))
    pts[:, ::7] = rng.uniform(-0.3, 0.3, (b, len(range(0, n, 7)), 3))
    return pts.astype(np.float32), rng.random((b, n)) < 0.6


def test_mean_shift_matches_jax():
    rng = np.random.default_rng(2)
    b, n = 3, 600
    pts, fg = _meanshift_inputs(rng, b, n)
    fg[2] = False  # no foreground at all
    key = jax.random.PRNGKey(4)
    keys = jax.random.split(key, b)
    want = [j_mean_shift_cluster(jnp.asarray(pts[i]), jnp.asarray(fg[i]), keys[i]) for i in range(b)]
    noise = jax_gumbel(key, b, subsampled_count(n))
    labels, centers, keep = mean_shift_cluster(_t(pts), _t(fg), _t(noise))
    np.testing.assert_array_equal(labels.numpy(), np.stack([np.asarray(w[0]) for w in want]))
    np.testing.assert_array_equal(keep.numpy(), np.stack([np.asarray(w[2]) for w in want]))
    np.testing.assert_allclose(centers.numpy(), np.stack([np.asarray(w[1]) for w in want]), atol=1e-5, rtol=0)
    assert labels.numpy()[:2].max() >= 3  # several clusters survive
    assert np.all(labels.numpy()[2] == 0)


def test_cluster_matches_jax():
    """cluster(): xyz + offsets, one key split per scene, as the JAX package does."""
    rng = np.random.default_rng(9)
    b, n = 2, 500
    xyz, fg = _meanshift_inputs(rng, b, n)
    offsets = rng.normal(0, 0.002, (b, n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    want = j_cluster(jnp.asarray(xyz), jnp.asarray(offsets), jnp.asarray(fg), key)
    got = cluster(_t(xyz), _t(offsets), _t(fg), gumbel=_t(jax_gumbel(key, b, subsampled_count(n))))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # the port draws its own noise from a torch.Generator
    labels, _, _ = cluster(_t(xyz), _t(offsets), _t(fg), generator=torch.Generator().manual_seed(0))
    assert labels.shape == (b, n) and labels.dtype == torch.int32


@pytest.mark.parametrize(
    "case",
    [
        "balanced",  # 3 objects, remainder to the last
        "past_cap",  # objects larger than compact_cap: strided compaction
        "zero_objects",  # one scene with no object: the identity prefix
        "one_object",  # a single object: its quota cycles through fps_cap
    ],
)
def test_object_balance_indices_match_jax(case):
    rng = np.random.default_rng(1)
    b, n = 2, 400
    pts = (rng.random((b, n, 3)) - 0.5).astype(np.float32)
    kw = dict(num_seed=40, fps_cap=16, max_objects=4, compact_cap=128)
    if case == "balanced":
        labels = rng.integers(0, 4, (b, n))
    elif case == "past_cap":
        labels = rng.integers(0, 3, (b, n))  # ~130 points per object > 64
        kw["compact_cap"] = 64
    elif case == "zero_objects":
        labels = rng.integers(0, 3, (b, n))
        labels[1] = 0
    else:
        labels = np.where(rng.random((b, n)) < 0.2, 2, 0)
    labels = labels.astype(np.int32)
    want = np.asarray(j_object_balance_indices(jnp.asarray(pts), jnp.asarray(labels), **kw))
    got = object_balance_indices(_t(pts), _t(labels), **kw)
    assert got.dtype == torch.int32 and got.shape == (b, kw["num_seed"])
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "zero_objects":
        np.testing.assert_array_equal(got.numpy()[1], np.arange(kw["num_seed"]))
    else:
        picked = np.take_along_axis(labels, got.numpy().astype(np.int64), axis=1)
        assert np.all(picked > 0)


@pytest.fixture(scope="module")
def dsn_pair():
    """The tiny DSN in both packages, with the same random variables."""
    jdsn = JDSN(pt_stages=TINY_PT_STAGES)
    pc = jnp.zeros((1, TINY_SCENE.num_points, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jdsn.init(jax.random.PRNGKey(1), pc, train=False))
    variables = _random_variables(shapes, np.random.default_rng(21))
    dsn = load_flax_variables(DSN(TINY_PT_STAGES), variables).eval()
    return jdsn, variables, dsn


def test_dsn_forward_matches_jax(dsn_pair):
    jdsn, variables, dsn = dsn_pair
    pc = make_batch(3, 2, TINY_SCENE)["point_clouds"]
    want = jax.jit(lambda v, x: jdsn.apply(v, x, train=False))(variables, jnp.asarray(pc))
    got = dsn(_t(pc))
    for key in ("seed_xyz", "foreground_logits", "center_offsets"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=TOL, rtol=TOL)


def test_foreground_indices_match_jax():
    rng = np.random.default_rng(4)
    pts = (rng.random((2, 300, 3)) - 0.5).astype(np.float32)
    fg = rng.random((2, 300)) < 0.3
    want = np.asarray(j_foreground_indices(jnp.asarray(pts), jnp.asarray(fg), num_seed=48))
    np.testing.assert_array_equal(foreground_indices(_t(pts), _t(fg), num_seed=48).numpy(), want)


@pytest.mark.parametrize("kind", ["object_balance", "foreground"])
def test_sampling_matches_jax(kind):
    """The gathering wrappers: seed xyz, features and indices as the JAX package's."""
    rng = np.random.default_rng(6)
    b, n, c = 2, 300, 5
    pts = (rng.random((b, n, 3)) - 0.5).astype(np.float32)
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    if kind == "object_balance":
        sel = rng.integers(0, 4, (b, n)).astype(np.int32)
        kw = dict(num_seed=40, fps_cap=16, max_objects=4)
        want = j_object_balance_sampling(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(sel), **kw)
        got = object_balance_sampling(_t(pts), _t(feats), _t(sel), **kw)
    else:
        sel = rng.random((b, n)) < 0.3
        want = j_foreground_sampling(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(sel), num_seed=48)
        got = foreground_sampling(_t(pts), _t(feats), _t(sel), num_seed=48)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dsn_bridge_maps_every_key_once(dsn_pair):
    _, variables, dsn = dsn_pair
    sd = state_dict_from_flax(variables, dsn)
    assert sd.keys() == dsn.state_dict().keys()
    ln = variables["params"]["backbone"]["block1_0"]["ln1"]
    np.testing.assert_array_equal(sd["backbone.block1_0.ln1.weight"].numpy(), ln["scale"])
    np.testing.assert_array_equal(
        sd["backbone.block1_0.attn.pos1.weight"].numpy(),
        variables["params"]["backbone"]["block1_0"]["attn"]["pos1"]["kernel"].T,
    )
    broken = copy.deepcopy(variables)
    del broken["params"]["backbone"]["proj"]["bias"]
    with pytest.raises(ValueError):
        state_dict_from_flax(broken, dsn)
