"""The port's fused eval configuration against the JAX package: the fused
group MLP + reduction (ops/mlpmax.py) and the fused SetAbstraction and
LocalAggregation branches, the width MLP on gripper-frame coordinates
(ops/widthmlp.py:width_mlp_fused) and the width head's
``impl='fused_pallas'``, the class-plane selection (ops/select.py) and
``multi_cylinder_query(impl="select")``, the table-gather probe
(ops/table_gather.py), and the tiny GraspBalance with every grouping module
fused. The JAX side runs its Pallas kernels in interpret mode, and its
modules' fused branches under GB_FORCE_FUSED_EVAL=1, as its own tests do.

Tolerances: indices and gathered values exactly; the fused MLPs within
1e-5 absolute and relative against the Pallas kernels on the same inputs
(f32 products summed in other orders); the fused modules within 2e-4
relative + 2e-5 absolute, the JAX package's own tolerance for its fused
modules against their unfused paths; the width head within 1e-4 absolute
and relative (the JAX query's gripper-frame coordinates carry ~1e-6 m from
its bf16 hi/lo reconstruction); the tiny model as tests/test_torch_model.py
holds the default one (index keys exactly, floats within 1e-4, no path
argmax a near tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspbalance_tpu.data.synthetic import make_batch
from graspbalance_tpu.models.decode import pred_decode as j_pred_decode
from graspbalance_tpu.models.drp import LocalAggregation as JLocalAggregation
from graspbalance_tpu.models.graspbalance import GraspBalance as JGraspBalance
from graspbalance_tpu.models.heads import MultiScaleWidthGrouping as JMultiScaleWidthGrouping
from graspbalance_tpu.nn.sa_fp import SetAbstraction as JSetAbstraction
from graspbalance_tpu.ops import multi_cylinder_query as j_multi_cylinder_query
from graspbalance_tpu.ops.pallas.mlpmax_kernel import mlp_max_fused as j_mlp_max_fused
from graspbalance_tpu.ops.pallas.multicyl_kernel import multi_cylinder_group as j_multi_cylinder_group
from graspbalance_tpu.ops.pallas.select_kernel import multicyl_select as j_multicyl_select
from graspbalance_tpu.ops.pallas.widthmlp_kernel import width_mlp_fused as j_width_mlp_fused
from graspbalance_tpu_torch.models import GraspBalance, pred_decode
from graspbalance_tpu_torch.models.drp import LocalAggregation
from graspbalance_tpu_torch.models.heads import MultiScaleWidthGrouping
from graspbalance_tpu_torch.nn.layers import fused_eval_ok
from graspbalance_tpu_torch.nn.sa_fp import SetAbstraction
from graspbalance_tpu_torch.ops.mlpmax import mlp_max_fused, mlp_max_fused_plain
from graspbalance_tpu_torch.ops.query import NEVER_HIT, class_plane, multi_cylinder_query
from graspbalance_tpu_torch.ops.select import multicyl_select, multicyl_select_plain
from graspbalance_tpu_torch.ops.table_gather import table_gather, table_gather_plain
from graspbalance_tpu_torch.ops.widthmlp import width_mlp_fused, width_mlp_fused_plain
from graspbalance_tpu_torch.weights import init_random_, load_flax_variables
from test_torch_model import FLOAT_KEYS, INDEX_KEYS, SLICE_SEEDS, _margin, _random_variables
from tiny import TINY_NUM_SEED, TINY_NUM_VIEW, TINY_SCENE, TINY_STAGES
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

KERNEL_TOL = 1e-5
MODULE_RTOL, MODULE_ATOL = 2e-4, 2e-5
HEAD_TOL = 1e-4
MODEL_TOL = 1e-4
RADII = (0.02, 0.04, 0.06, 0.08)
HMIN = -0.02
HMAXS = (0.01, 0.02, 0.03, 0.04)


def _rotations(rng, shape):
    q, _ = np.linalg.qr(rng.standard_normal(shape + (3, 3)))
    return q.astype(np.float32)


def _jax_variables(module, rng, *args):
    """Random variables in ``module``'s flax tree (see test_torch_model)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, train=False))
    return _random_variables(shapes, rng)


# --- the fused group MLP + reduction (K12) ---


@pytest.mark.parametrize("reduction", ["max", "mean", "sum"])
@pytest.mark.parametrize("c_parts", [(3, 5), (3,)])
def test_mlp_max_plain_matches_pallas(rng, reduction, c_parts):
    b, n, k, widths = 2, 24, 8, (12, 16)
    parts = [rng.standard_normal((b, n, k, c)).astype(np.float32) for c in c_parts]
    w0_parts = [(rng.standard_normal((c, widths[0])) * 0.4).astype(np.float32) for c in c_parts]
    b0 = (rng.standard_normal(widths[0]) * 0.1).astype(np.float32)
    w1 = (rng.standard_normal(widths) * 0.3).astype(np.float32)
    b1 = (rng.standard_normal(widths[1]) * 0.1).astype(np.float32)
    want = j_mlp_max_fused(
        tuple(map(jnp.asarray, parts)),
        ((tuple(map(jnp.asarray, w0_parts)), jnp.asarray(b0)), (jnp.asarray(w1), jnp.asarray(b1))),
        reduction=reduction, interpret=True,
    )
    t = torch.from_numpy
    weights = ((tuple(map(t, w0_parts)), t(b0)), (t(w1), t(b1)))
    got = mlp_max_fused(tuple(map(t, parts)), weights, reduction=reduction)
    assert got.shape == (b, n, widths[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_TOL, rtol=KERNEL_TOL)
    chunked = mlp_max_fused_plain(tuple(map(t, parts)), weights, reduction=reduction, max_rows=3 * b * k)
    torch.testing.assert_close(chunked, got, atol=1e-6, rtol=1e-6)


def test_mlp_max_checks_its_inputs():
    parts = (torch.zeros(1, 4, 8, 3), torch.zeros(1, 4, 8, 5))
    with pytest.raises(ValueError, match="reduction"):
        mlp_max_fused(parts, (((torch.zeros(3, 4), torch.zeros(5, 4)), torch.zeros(4)),), reduction="min")
    with pytest.raises(ValueError, match="row block"):
        mlp_max_fused(parts, (((torch.zeros(3, 4),), torch.zeros(4)),))
    w0 = ((torch.zeros(3, 4), torch.zeros(5, 4)), torch.zeros(4))
    with pytest.raises(ValueError, match="layer 1"):
        mlp_max_fused(parts, (w0, (torch.zeros(6, 8), torch.zeros(8))))
    with pytest.raises(ValueError, match="layer 0"):
        mlp_max_fused(parts, (((torch.zeros(3, 4), torch.zeros(5, 4)), torch.zeros(6)),))


@pytest.mark.parametrize("with_features", [True, False])
def test_set_abstraction_fused_matches_jax(rng, monkeypatch, with_features):
    b, n = 2, 64
    xyz = (rng.random((b, n, 3)) - 0.5).astype(np.float32)
    feats = rng.standard_normal((b, n, 6)).astype(np.float32) if with_features else None
    jmod = JSetAbstraction(npoint=16, radius=0.4, nsample=8, mlp=(8, 12, 16))
    args = (jnp.asarray(xyz),) + ((jnp.asarray(feats),) if with_features else ())
    variables = _jax_variables(jmod, rng, *args)
    monkeypatch.setenv("GB_FORCE_FUSED_EVAL", "1")
    want_xyz, want, inds = jmod.apply(variables, *args, train=False)
    inds = torch.from_numpy(np.array(inds))
    mod = SetAbstraction(6 if with_features else 0, 0.4, 8, (8, 12, 16), fused_min_nsample=0)
    load_flax_variables(mod, variables).eval()
    got_xyz, got = mod(torch.from_numpy(xyz), torch.from_numpy(feats) if with_features else None, inds)
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODULE_RTOL, atol=MODULE_ATOL)
    # the fused branch computes the unfused one's function
    mod.fused_min_nsample = None
    unfused = mod(torch.from_numpy(xyz), torch.from_numpy(feats) if with_features else None, inds)[1]
    torch.testing.assert_close(got, unfused, rtol=MODULE_RTOL, atol=MODULE_ATOL)


def test_local_aggregation_fused_matches_jax(rng, monkeypatch):
    b, n, c = 2, 32, 12
    xyz = (rng.random((b, n, 3)) - 0.5).astype(np.float32)
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    jmod = JLocalAggregation(channels=c, radius=0.5, nsample=8)
    variables = _jax_variables(jmod, rng, jnp.asarray(xyz), jnp.asarray(feats))
    monkeypatch.setenv("GB_FORCE_FUSED_EVAL", "1")
    want = jmod.apply(variables, jnp.asarray(xyz), jnp.asarray(feats), train=False)
    mod = load_flax_variables(LocalAggregation(c, 0.5, 8, fused_min_nsample=0), variables).eval()
    got = mod(torch.from_numpy(xyz), torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODULE_RTOL, atol=MODULE_ATOL)
    mod.fused_min_nsample = None  # the lifted form, the default
    torch.testing.assert_close(got, mod(torch.from_numpy(xyz), torch.from_numpy(feats)),
                               rtol=MODULE_RTOL, atol=MODULE_ATOL)


def test_fused_gate(rng, monkeypatch):
    """Fused only in eval, for float32 and for nsample >= the threshold; a
    training module takes its usual path (with gradients)."""
    import graspbalance_tpu_torch.models.drp as drp

    xyz = torch.from_numpy((rng.random((1, 40, 3)) - 0.5).astype(np.float32))
    feats = torch.from_numpy(rng.standard_normal((1, 40, 4)).astype(np.float32))
    mod = init_random_(LocalAggregation(4, 0.5, 8, fused_min_nsample=16), seed=2).eval()
    calls = []

    def counting(parts, weights, **kw):
        calls.append(parts[0].shape)
        return mlp_max_fused_plain(parts, weights, **kw)

    monkeypatch.setattr(drp.mlpmax, "mlp_max_fused_plain", counting)
    mod(xyz, feats, plain=True)  # nsample 8 < 16
    mod.fused_min_nsample = 8
    mod(xyz, feats, plain=True)
    assert not fused_eval_ok(mod, feats.double())
    out = mod.train()(xyz, feats.requires_grad_(True), plain=True)
    assert calls == [(1, 40, 8, 3)]
    out.sum().backward()
    assert feats.grad is not None


# --- the width MLP on gripper-frame coordinates (K6) and the width head ---


@pytest.mark.parametrize("mlp,k,s", [((8, 12, 16), 16, 5), ((64, 128, 256), 64, 3)])
def test_width_mlp_fused_plain_matches_pallas(rng, mlp, k, s):
    head = init_random_(MultiScaleWidthGrouping(nsample=k, mlp=mlp), seed=3)
    weights = head.folded_weights()
    rel = (rng.standard_normal((2, 4, 4, s, k, 3)) * 0.05).astype(np.float32)
    j_weights = tuple(tuple((jnp.asarray(w.numpy()), jnp.asarray(b.numpy())) for w, b in ws) for ws in weights)
    want = np.asarray(j_width_mlp_fused(jnp.asarray(rel), j_weights, interpret=True))
    got = width_mlp_fused(torch.from_numpy(rel), weights)
    assert got.shape == (2, 4, s, 4 * mlp[-1])
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    chunked = width_mlp_fused_plain(torch.from_numpy(rel), weights, seed_chunk=2)
    torch.testing.assert_close(chunked, got, atol=1e-6, rtol=1e-6)


def _head_case(rng, b=2, n=300, m=7):
    cloud = (rng.random((b, n, 3)) - 0.5).astype(np.float32) * 0.2
    seeds = np.take_along_axis(cloud, rng.integers(0, n, size=(b, m))[..., None], axis=1)
    return cloud, seeds, _rotations(rng, (b, m))


def test_width_head_fused_pallas_matches_jax(rng):
    """The port's impl='fused_pallas' eval head against the JAX module's own
    composition of it (models/heads.py: the fused query with emit_idx=False,
    then _fused_mlp_tail), both Pallas kernels interpreted."""
    cloud, seeds, rot = _head_case(rng)
    mlp, k = (8, 12, 16), 16
    jmod = JMultiScaleWidthGrouping(nsample=k, mlp=mlp)
    args = tuple(map(jnp.asarray, (seeds, cloud, rot)))
    variables = _jax_variables(jmod, rng, *args)
    radii = tuple(s * jmod.cylinder_radius for s in jmod.scales)
    rel, _ = j_multi_cylinder_group(args[1], args[0], args[2], radii, jmod.hmin, tuple(jmod.hmax_list), k,
                                    emit_idx=False, interpret=True)
    folded = jmod.apply(variables, 4, method=lambda m, n_r: m._folded_mlp_weights(n_r))
    want = np.transpose(np.asarray(j_width_mlp_fused(rel, folded, interpret=True)), (0, 2, 1, 3))
    head = MultiScaleWidthGrouping(nsample=k, mlp=mlp, impl="fused_pallas")
    load_flax_variables(head, variables).eval()
    got = head(*map(torch.from_numpy, (seeds, cloud, rot)))
    assert got.shape == want.shape == (2, 7, 4, 4 * mlp[-1])
    np.testing.assert_allclose(got.numpy(), want, atol=HEAD_TOL, rtol=HEAD_TOL)
    # the default head computes the same function
    default = load_flax_variables(MultiScaleWidthGrouping(nsample=k, mlp=mlp), variables).eval()
    torch.testing.assert_close(got, default(*map(torch.from_numpy, (seeds, cloud, rot))),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


def test_width_head_fused_pallas_train_mode(rng):
    """Train mode: the query's rotated coordinates, each scale's SharedMLP
    on batch statistics, the max; the same function as the default branch's
    gather + rotate, and no gradient reaches the geometry."""
    cloud, seeds, rot = map(torch.from_numpy, _head_case(rng))
    fused = init_random_(MultiScaleWidthGrouping(nsample=16, mlp=(8, 12, 16), impl="fused_pallas"), seed=4).train()
    default = init_random_(MultiScaleWidthGrouping(nsample=16, mlp=(8, 12, 16)), seed=4).train()
    seeds.requires_grad_(True)
    got = fused(seeds, cloud, rot)
    torch.testing.assert_close(got, default(seeds.detach(), cloud, rot), atol=KERNEL_TOL, rtol=KERNEL_TOL)
    got.sum().backward()
    assert seeds.grad is None
    assert fused.mlp_scale0.layer0.dense.weight.grad is not None


def test_width_head_rejects_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        MultiScaleWidthGrouping(impl="xla")


# --- the class plane and its selection (K8) ---


def _random_class_plane(rng, rows, n, n_r, n_h):
    cls = rng.integers(0, n_r + 1, (rows, n)) * 8 + rng.integers(0, n_h + 1, (rows, n))
    cls[rng.random((rows, n)) < 0.3] = NEVER_HIT
    cls[0] = NEVER_HIT  # no hit in any combo
    cls[1, :-3] = NEVER_HIT  # fewer hits than k
    return cls.astype(np.uint8)


@pytest.mark.parametrize("nsample", [4, 16])
def test_select_plain_matches_pallas(rng, nsample):
    cls = _random_class_plane(rng, 13, 300, 4, 4)  # 13 rows: the Pallas side pads them
    want = np.asarray(j_multicyl_select(jnp.asarray(cls, jnp.bfloat16), 4, 4, nsample, interpret=True))
    got = multicyl_select(torch.from_numpy(cls), 4, 4, nsample)
    assert got.dtype == torch.int32 and got.shape == (13, 16, nsample)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0] == 0).all()
    chunked = multicyl_select_plain(torch.from_numpy(cls), 4, 4, nsample, chunk=5)
    torch.testing.assert_close(chunked, got, atol=0, rtol=0)


def test_select_query_matches_jax(rng):
    b, n, m, k = 2, 700, 40, 16
    cloud = (rng.random((b, n, 3)) - 0.5).astype(np.float32) * 0.4
    centers = np.take_along_axis(cloud, rng.integers(0, n, size=(b, m))[..., None], axis=1)
    centers[:, -4:] = 50.0  # far away: no hit in any combo
    rot = _rotations(rng, (b, m))
    want = np.asarray(j_multi_cylinder_query(
        *map(jnp.asarray, (cloud, centers, rot)), RADII, HMIN, HMAXS, k,
        impl="pallas_select", interpret=True,
    ))
    args = (*map(torch.from_numpy, (cloud, centers, rot)), RADII, HMIN, HMAXS, k)
    got = multi_cylinder_query(*args, impl="select", chunk=16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, :, :, -4:] == 0).all()
    torch.testing.assert_close(got, multi_cylinder_query(*args), atol=0, rtol=0)
    cls = class_plane(*args[:6])
    assert cls.dtype == torch.uint8 and cls.shape == (b, m, n)


def test_class_plane_needs_ascending_thresholds(rng):
    cloud = torch.zeros(1, 5, 3)
    with pytest.raises(ValueError, match="ascending"):
        class_plane(cloud, cloud[:, :1], torch.eye(3).expand(1, 1, 3, 3), (0.04, 0.02), HMIN, HMAXS)
    with pytest.raises(ValueError, match="at most 7"):
        class_plane(cloud, cloud[:, :1], torch.eye(3).expand(1, 1, 3, 3), RADII * 2, HMIN, HMAXS)
    with pytest.raises(ValueError, match="impl"):
        multi_cylinder_query(cloud, cloud[:, :1], torch.eye(3).expand(1, 1, 3, 3), RADII, HMIN, HMAXS, 4,
                             impl="pallas_select")


# --- the table-gather probe (K13) ---


# the kernel's cases beside the square-ish one: dim 0 with N % 4 != 0 on a
# taller table (its scalar path), dim 1 with many rows of one warp each
@pytest.mark.parametrize(
    "dim,m,n", [(0, 37, 19), (1, 37, 19), (0, 1030, 131), (1, 300, 66)], ids=["0", "1", "0-1030x131", "1-300x66"]
)
def test_table_gather_matches_take_along_axis(rng, dim, m, n):
    x = rng.random((m, n)).astype(np.float32)
    idx = rng.integers(0, (m, n)[dim], (m, n)).astype(np.int32)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(x), jnp.asarray(idx), axis=dim))
    got = table_gather(torch.from_numpy(x), torch.from_numpy(idx), dim)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(table_gather_plain(torch.from_numpy(x), torch.from_numpy(idx), dim).numpy(), want)


# --- the tiny GraspBalance with every grouping module fused ---


@pytest.fixture(scope="module")
def fused_slice_outputs():
    kw = dict(backbone_stages=TINY_STAGES, num_seed=TINY_NUM_SEED, num_view=TINY_NUM_VIEW)
    jmodel = JGraspBalance(**kw)
    pc = make_batch(SLICE_SEEDS[0], 2, TINY_SCENE)["point_clouds"]
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), {"point_clouds": jnp.asarray(pc[:1])}, train=False)
    )
    variables = _random_variables(shapes, np.random.default_rng(SLICE_SEEDS[1]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GB_FORCE_FUSED_EVAL", "1")
        j_ep = jax.jit(lambda v, x: jmodel.apply(v, {"point_clouds": x}, train=False))(variables, jnp.asarray(pc))
    j_grasps, j_valid = j_pred_decode(j_ep)
    model = GraspBalance(**kw, fused_backbone_min_nsample=0)
    load_flax_variables(model, variables)
    ep = model.eval()(torch.from_numpy(pc))
    grasps, valid = pred_decode(ep)
    j_out = {k: np.asarray(v) for k, v in j_ep.items() if v is not None}
    j_out.update(grasps=np.asarray(j_grasps), valid=np.asarray(j_valid))
    out = {k: v.numpy() for k, v in ep.items() if v is not None}
    out.update(grasps=grasps.numpy(), valid=valid.numpy())
    return j_out, out


@pytest.mark.parametrize("key", INDEX_KEYS + ("valid",))
def test_fused_model_index_end_points_exact(fused_slice_outputs, key):
    want, got = fused_slice_outputs[0][key], fused_slice_outputs[1][key]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", FLOAT_KEYS + ("grasps",))
def test_fused_model_float_end_points_close(fused_slice_outputs, key):
    want, got = fused_slice_outputs[0][key], fused_slice_outputs[1][key]
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=MODEL_TOL, rtol=MODEL_TOL)


def test_fused_model_argmaxes_are_not_near_ties(fused_slice_outputs):
    j, port = fused_slice_outputs
    assert _margin(j["view_score"], -1).min() > MODEL_TOL
    assert _margin(j["objectness_score"], -1).min() > MODEL_TOL
    assert _margin(j["grasp_angle_cls_pred"], 2).min() > MODEL_TOL
    margins = []
    for d in (j, port):
        ang = np.argmax(d["grasp_angle_cls_pred"], axis=2)[:, :, None, :]
        margins.append(_margin(np.take_along_axis(d["grasp_score_pred"], ang, axis=2)[:, :, 0], 2))
    tied = margins[0] == 0
    assert np.all(margins[1][tied] == 0)
    assert margins[0][~tied].min() > MODEL_TOL


def test_fused_model_loads_the_same_state_dict():
    """The fused configuration has the default's variables: one state_dict
    loads into both, strictly."""
    kw = dict(backbone_stages=TINY_STAGES, num_seed=TINY_NUM_SEED, num_view=TINY_NUM_VIEW)
    default = init_random_(GraspBalance(**kw), seed=7)
    fused = GraspBalance(**kw, fused_backbone_min_nsample=0, width_impl="fused_pallas")
    fused.load_state_dict(default.state_dict(), strict=True)
    assert fused.state_dict().keys() == default.state_dict().keys()
