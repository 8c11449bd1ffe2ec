"""The port's point-axis-sharded ops (graspbalance_tpu_torch/parallel/) and
the chunked-centers module forms they run, against the port's unsharded ops
and the JAX package's.

The sharded ops run on four gloo ranks on the CPU (parallel/ranks.py), each
on one torch thread, meeting through a ``file://`` store under tmp_path:
once on a (2, 2) ('data', 'point') mesh and once on a (1, 4) one, so the
point axis is split in 2 and in 4. Every point rank of a data coordinate
must return the same result, and the data coordinates' rows together the
whole batch's:

  - sharded_fps with the near-origin skip (a zeroed point in each cloud)
    and without it: exactly the port's FPS (ops/fps.py; without the skip
    its masked FPS with every point valid, which seeds index 0 and skips
    nothing) and the JAX package's;
  - sharded_ball_query in index and nearest order: exactly the port's
    ball query and the JAX package's;
  - sharded_sa_forward (DRP stage 1): indices and coordinates exactly, the
    features within 1e-6 of the unsharded module (each center's rows run
    the same operations; only products over fewer rows may round apart).

The chunked-centers forms (a subset of output rows against the whole
support) run in one process: ``SetAbstraction(query_idx=)``, and
``LocalAggregation`` / ``InvResMLP`` with ``centers=``, ``center_feats=``,
``query_idx=``. Each equals the rows of its full call within 1e-6, and the
JAX module's chunked call within TOL = 1e-5 (the port's forward against
the JAX package's rounds apart by a few ulps of the features).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspbalance_tpu import ops as jops
from graspbalance_tpu.models.drp import InvResMLP as JInvResMLP
from graspbalance_tpu.models.drp import LocalAggregation as JLocalAggregation
from graspbalance_tpu.nn.sa_fp import SetAbstraction as JSetAbstraction
from graspbalance_tpu_torch import ops
from graspbalance_tpu_torch.models.drp import FEATURE_TYPES, InvResMLP, LocalAggregation
from graspbalance_tpu_torch.nn.layers import init_flax_defaults_
from graspbalance_tpu_torch.nn.sa_fp import SetAbstraction
from graspbalance_tpu_torch.ops.fps import furthest_point_sample_masked_plain, furthest_point_sample_plain
from graspbalance_tpu_torch.parallel.ranks import run_ranks
from graspbalance_tpu_torch.weights import load_flax_variables
from test_torch_variants import _points, _vars
from torch_ranks import ops_ranks
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

TOL = 1e-5
ROW_TOL = 1e-6
MESHES = ("2x2", "1x4")
M, RADIUS, NSAMPLE, NPOINT, MLP = 32, 0.2, 16, 64, (16, 16, 32)


def _inputs():
    rng = np.random.default_rng(0)
    fps_pts = (rng.random((2, 256, 3), dtype=np.float32) - 0.5)
    fps_pts[:, 5] = 0.0  # a near-origin point, which the skip never selects
    bq_pts = (rng.random((2, 512, 3), dtype=np.float32) - 0.5)
    return fps_pts, bq_pts, bq_pts[:, :64].copy()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The four ranks' results, per key the data coordinates' rows joined
    (each checked equal on every point rank of its coordinate)."""
    tmp = tmp_path_factory.mktemp("parallel_ops")
    fps_pts, bq_pts, bq_ctr = _inputs()
    sa = init_flax_defaults_(SetAbstraction(0, RADIUS, NSAMPLE, MLP), torch.Generator().manual_seed(1)).eval()
    d = dict(fps_pts=torch.from_numpy(fps_pts), bq_pts=torch.from_numpy(bq_pts), bq_ctr=torch.from_numpy(bq_ctr),
             m=M, radius=RADIUS, nsample=NSAMPLE, npoint=NPOINT, mlp=MLP, sa=sa.state_dict())
    torch.save(d, tmp / "in.pt")
    run_ranks(ops_ranks, 4, (str(tmp / "in.pt"), str(tmp)), init_file=str(tmp / "store"), threads=1, timeout=240)
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(4)]
    joined = {}
    for key in ranks[0]:
        if key.startswith("data_rank"):
            continue
        tag = key.split("/")[1]
        by_row = {}
        for res in ranks:
            got = res[key] if isinstance(res[key], tuple) else (res[key],)
            first = by_row.setdefault(res[f"data_rank/{tag}"], got)
            for a, b in zip(first, got):  # replicated over 'point'
                torch.testing.assert_close(a, b, rtol=0, atol=0, msg=key)
        parts = [by_row[r] for r in sorted(by_row)]
        joined[key] = tuple(torch.cat(ts).numpy() for ts in zip(*parts))
    return joined, sa


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("skip_origin", [True, False])
def test_sharded_fps_exact(sharded, mesh, skip_origin):
    pts = torch.from_numpy(_inputs()[0])
    (got,) = sharded[0][f"fps/{mesh}/{skip_origin}"]
    if skip_origin:
        want = furthest_point_sample_plain(pts, M)
    else:
        want = furthest_point_sample_masked_plain(pts, torch.ones(pts.shape[:2], dtype=torch.bool), M)
    np.testing.assert_array_equal(got, want.numpy())
    jwant = jops.furthest_point_sample(jnp.asarray(pts.numpy()), M, skip_origin=skip_origin)
    np.testing.assert_array_equal(got, np.asarray(jwant))
    if skip_origin:
        assert not (got == 5).any()  # the zeroed point is never selected


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("order", ["index", "nearest"])
def test_sharded_ball_query_exact(sharded, mesh, order):
    _, pts, ctr = _inputs()
    (got,) = sharded[0][f"ball_query/{mesh}/{order}"]
    want = ops.ball_query(torch.from_numpy(pts), torch.from_numpy(ctr), RADIUS, NSAMPLE, order=order)
    np.testing.assert_array_equal(got, want.numpy())
    jwant = jops.ball_query(jnp.asarray(pts), jnp.asarray(ctr), RADIUS, NSAMPLE, order=order)
    np.testing.assert_array_equal(got, np.asarray(jwant))


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_sa_stage1_matches_unsharded(sharded, mesh):
    joined, sa = sharded
    pts = torch.from_numpy(_inputs()[1])
    got_xyz, got_feats, got_inds = joined[f"sa/{mesh}"]
    inds = furthest_point_sample_plain(pts, NPOINT)
    with torch.no_grad():
        want_xyz, want_feats = sa(pts, None, inds)
    np.testing.assert_array_equal(got_inds, inds.numpy())
    np.testing.assert_array_equal(got_xyz, want_xyz.numpy())
    np.testing.assert_allclose(got_feats, want_feats.numpy(), rtol=ROW_TOL, atol=ROW_TOL)


# --- the chunked-centers forms, in one process ------------------------------

ROWS = slice(8, 24)  # the chunk of output rows


def _check_rows(chunk, full, jchunk):
    np.testing.assert_allclose(chunk, full[:, ROWS], rtol=ROW_TOL, atol=ROW_TOL)
    np.testing.assert_allclose(chunk, jchunk, rtol=TOL, atol=TOL)


def test_set_abstraction_query_idx_chunk(rng):
    xyz, feats = _points(rng, 2, 200), rng.standard_normal((2, 200, 6)).astype(np.float32)
    jmod = JSetAbstraction(npoint=32, radius=0.1, nsample=8, mlp=(16, 24))
    jx, jf = jnp.asarray(xyz), jnp.asarray(feats)
    variables = _vars(jmod, jx, jf, seed=11)
    inds = np.array(jops.furthest_point_sample(jx, 32))
    qidx = np.array(jops.ball_query(jx, jops.gather_points(jx, jnp.asarray(inds)), 0.1, 8))
    _, jchunk, _ = jmod.apply(variables, jx, jf, inds=jnp.asarray(inds[:, ROWS]),
                              query_idx=jnp.asarray(qidx[:, ROWS]))
    mod = load_flax_variables(SetAbstraction(6, 0.1, 8, (16, 24)), variables).eval()
    tx, tf, ti = torch.from_numpy(xyz), torch.from_numpy(feats), torch.from_numpy(inds)
    with torch.no_grad():
        full_xyz, full = mod(tx, tf, ti)
        chunk_xyz, chunk = mod(tx, tf, ti[:, ROWS], query_idx=torch.from_numpy(qidx[:, ROWS]))
        np.testing.assert_array_equal(mod(tx, tf, ti, query_idx=torch.from_numpy(qidx))[1].numpy(), full.numpy())
    np.testing.assert_array_equal(chunk_xyz.numpy(), full_xyz[:, ROWS].numpy())
    _check_rows(chunk.numpy(), full.numpy(), np.asarray(jchunk))


def _chunk_args(xyz, feats, qidx):
    return dict(centers=xyz[:, ROWS], center_feats=feats[:, ROWS], query_idx=None if qidx is None else qidx[:, ROWS])


@pytest.mark.parametrize("feature_type", FEATURE_TYPES)
@pytest.mark.parametrize("grouper", ["ballquery", "knn"])
@pytest.mark.parametrize("given_idx", [False, True])
def test_local_aggregation_chunk(rng, feature_type, grouper, given_idx):
    xyz, feats = _points(rng, 2, 120), rng.standard_normal((2, 120, 16)).astype(np.float32)
    kw = dict(grouper=grouper, feature_type=feature_type)
    jmod = JLocalAggregation(16, 0.1, 8, **kw)
    jx, jf = jnp.asarray(xyz), jnp.asarray(feats)
    variables = _vars(jmod, jx, jf, train=False, seed=12)
    qidx = np.array(jops.ball_query(jx, jx, 0.1, 8)) if given_idx else None
    jchunk = jmod.apply(variables, jx, jf, train=False,
                        **jax.tree_util.tree_map(jnp.asarray, _chunk_args(xyz, feats, qidx)))
    mod = load_flax_variables(LocalAggregation(16, 0.1, 8, **kw), variables).eval()
    tx, tf = torch.from_numpy(xyz), torch.from_numpy(feats)
    with torch.no_grad():
        full = mod(tx, tf, query_idx=None if qidx is None else torch.from_numpy(qidx))
        chunk = mod(tx, tf, **_chunk_args(tx, tf, None if qidx is None else torch.from_numpy(qidx)))
    _check_rows(chunk.numpy(), full.numpy(), np.asarray(jchunk))


@pytest.mark.parametrize("order", ["index", "nearest"])
def test_inv_res_mlp_chunk(rng, order):
    xyz, feats = _points(rng, 2, 150), rng.standard_normal((2, 150, 16)).astype(np.float32)
    jmod = JInvResMLP(16, 0.1, 8, query_order=order)
    jx, jf = jnp.asarray(xyz), jnp.asarray(feats)
    variables = _vars(jmod, jx, jf, train=False, seed=13)
    jchunk = jmod.apply(variables, jx, jf, train=False, centers=jx[:, ROWS], center_feats=jf[:, ROWS])
    mod = load_flax_variables(InvResMLP(16, 0.1, 8, query_order=order), variables).eval()
    tx, tf = torch.from_numpy(xyz), torch.from_numpy(feats)
    with torch.no_grad():
        full = mod(tx, tf)
        chunk = mod(tx, tf, centers=tx[:, ROWS], center_feats=tf[:, ROWS])
    _check_rows(chunk.numpy(), full.numpy(), np.asarray(jchunk))
