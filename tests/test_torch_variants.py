"""The modules off the default model, on the port, against the JAX
package's (tiny shapes, float-valued inputs from numpy under a seed,
random variables in the JAX trees with non-trivial BatchNorm statistics,
bridged with weights.py):

  - nn/sa_fp.py: SetAbstractionMSG, SetAbstractionShift and
    SetAbstractionWOMLP (max, avg and rbf pooling), LocalFeaturePropagationMSG,
    in both query orders;
  - models/drp.py: LocalAggregation with each grouper (ball query in both
    orders, kNN at k <= 32, the kernel's range, and past it), feature type
    and reduction;
  - nn/registry.py: every norm (and suffix alias) and activation through
    MLPBlock, each block order, create_act's keyword arguments, the
    default group count and CHANNEL_MAP;
  - ops/trilinear.py and labels/focal.py (values and gradients);
  - the bfloat16 DSN forward, the JAX side compiled with
    ``xla_allow_excess_precision`` off (tests/test_torch_bf16.py says why);
  - ops.fps.random_sample's contract (jax.random's draws cannot be matched
    draw for draw by torch's generator: shape, distinct indices in range,
    and uniform counts over many draws instead);

(The GraspBalance variants are in tests/test_torch_heads.py.)

Tolerances: indices and masks exactly; float32 outputs within 1e-4
absolute + 1e-4 relative (sums in other orders; the registry's norms and
activations 1e-5); trilinear and focal 1e-6; the bfloat16 DSN's outputs
within BF16_TOL of each tensor's largest |value| (measured worst in the
constant's comment).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspbalance_tpu.data.synthetic import make_batch as j_make_batch
from graspbalance_tpu.labels.focal import binary_focal_loss as j_binary_focal_loss
from graspbalance_tpu.labels.focal import focal_loss as j_focal_loss
from graspbalance_tpu.models.drp import LocalAggregation as JLocalAggregation
from graspbalance_tpu.models.dsn import DSN as JDSN
from graspbalance_tpu.nn import registry as jreg
from graspbalance_tpu.nn import sa_fp as jsa
from graspbalance_tpu.nn.layers import MLPBlock as JMLPBlock
from graspbalance_tpu.ops.trilinear import trilinear_sample as j_trilinear_sample
from graspbalance_tpu_torch.labels.focal import binary_focal_loss, focal_loss
from graspbalance_tpu_torch.models import DSN
from graspbalance_tpu_torch.models.drp import LocalAggregation
from graspbalance_tpu_torch.nn import registry, sa_fp
from graspbalance_tpu_torch.nn.layers import MLPBlock
from graspbalance_tpu_torch.ops.fps import random_sample
from graspbalance_tpu_torch.ops.trilinear import trilinear_sample
from graspbalance_tpu_torch.weights import load_flax_variables
from test_torch_dsn import TINY_PT_STAGES
from test_torch_model import _random_variables
from tiny import TINY_SCENE
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

TOL = 1e-4
NORM_TOL = 1e-5
BF16_TOL = 1e-3  # measured 1.7e-7: every bfloat16 layer agrees bit for bit but the heads' first blocks (an ulp), once Dense rounds its product before adding the bias, as flax does


def _vars(module, *args, seed=0, **kw):
    """``module``'s variable tree with random values (numpy)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))
    return _random_variables(dict(shapes), np.random.default_rng(seed))


def _points(rng, b, n, scale=0.3):
    return ((rng.random((b, n, 3)) - 0.5) * scale).astype(np.float32)


# --- nn/sa_fp.py variants --------------------------------------------------


def _apply(jmod, variables, *args, **kw):
    return jax.tree_util.tree_map(np.asarray, jmod.apply(variables, *args, **kw))


@pytest.mark.parametrize("order", ["index", "nearest"])
@pytest.mark.parametrize("with_features", [False, True])
def test_set_abstraction_msg_matches_jax(rng, order, with_features):
    xyz, feats = _points(rng, 2, 300), rng.standard_normal((2, 300, 8)).astype(np.float32)
    f = feats if with_features else None
    kw = dict(npoint=40, radii=(0.05, 0.1), nsamples=(8, 16), mlps=((16, 32), (16, 24)), normalize_xyz=True,
              query_order=order)
    jmod = jsa.SetAbstractionMSG(**kw)
    variables = _vars(jmod, jnp.asarray(xyz), None if f is None else jnp.asarray(f), seed=3)
    want = _apply(jmod, variables, jnp.asarray(xyz), None if f is None else jnp.asarray(f))
    mod = sa_fp.SetAbstractionMSG(8 if with_features else 0, **kw)
    got = load_flax_variables(mod, variables).eval()(torch.from_numpy(xyz), None if f is None else torch.from_numpy(f))
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("pooling", ["max", "avg", "rbf"])
@pytest.mark.parametrize("order", ["index", "nearest"])
def test_set_abstraction_shift_and_womlp_match_jax(rng, pooling, order):
    xyz, feats = _points(rng, 2, 300), rng.standard_normal((2, 300, 8)).astype(np.float32)
    centers = _points(rng, 2, 25)
    kw = dict(radius=0.08, nsample=12, pooling=pooling, normalize_xyz=pooling == "rbf", query_order=order)
    jmod = jsa.SetAbstractionShift(mlp=(16, 32), **kw)
    args = tuple(map(jnp.asarray, (centers, xyz, feats)))
    variables = _vars(jmod, *args, seed=4)
    want = _apply(jmod, variables, *args)
    mod = load_flax_variables(sa_fp.SetAbstractionShift(8, mlp=(16, 32), **kw), variables).eval()
    got = mod(*map(torch.from_numpy, (centers, xyz, feats)))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL, rtol=TOL)

    jw = jsa.SetAbstractionWOMLP(npoint=30, **kw)
    want = _apply(jw, {}, jnp.asarray(xyz), jnp.asarray(feats))
    got = sa_fp.SetAbstractionWOMLP(30, **kw)(torch.from_numpy(xyz), torch.from_numpy(feats))
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_allclose(got[1].numpy(), want[1], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("order", ["index", "nearest"])
@pytest.mark.parametrize("skip", [False, True])
def test_local_feature_propagation_msg_matches_jax(rng, order, skip):
    xyz1, xyz2 = _points(rng, 2, 200), _points(rng, 2, 50)
    f1 = rng.standard_normal((2, 200, 8)).astype(np.float32)
    f2 = rng.standard_normal((2, 50, 6)).astype(np.float32) if skip else None
    kw = dict(radii=(0.06, 0.12), nsamples=(8, 16), mlps=((16, 32), (16, 32)), post_mlp=(32, 24),
              query_order=order)
    jmod = jsa.LocalFeaturePropagationMSG(**kw)
    args = (jnp.asarray(xyz2), jnp.asarray(xyz1), None if f2 is None else jnp.asarray(f2), jnp.asarray(f1))
    variables = _vars(jmod, *args, seed=5)
    want = _apply(jmod, variables, *args)
    mod = load_flax_variables(sa_fp.LocalFeaturePropagationMSG(8, 6 if skip else 0, **kw), variables).eval()
    got = mod(torch.from_numpy(xyz2), torch.from_numpy(xyz1), None if f2 is None else torch.from_numpy(f2),
              torch.from_numpy(f1))
    assert got.shape == (2, 50, 48)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL, rtol=TOL)


# --- models/drp.py LocalAggregation ----------------------------------------


LA_CASES = [("ballquery", ft, "max", "index") for ft in ("dp_fj", "dp_fj_df", "pi_dp_fj_df", "dp_df")]
LA_CASES += [("knn", ft, red, "index") for ft, red in (("dp_fj", "max"), ("dp_fj_df", "mean"),
                                                         ("pi_dp_fj_df", "sum"), ("dp_df", "avg"))]
LA_CASES += [("ballquery", "dp_fj", red, "nearest") for red in ("mean", "sum")]
LA_CASES += [("ballquery", "dp_df", "max", "nearest")]


@pytest.mark.parametrize("grouper, feature_type, reduction, order", LA_CASES)
@pytest.mark.parametrize("nsample", [16, 40])  # kNN: the kernel's k (<= 32) and a sorted k
def test_local_aggregation_matches_jax(rng, grouper, feature_type, reduction, order, nsample):
    xyz, feats = _points(rng, 2, 120), rng.standard_normal((2, 120, 16)).astype(np.float32)
    kw = dict(grouper=grouper, feature_type=feature_type, reduction=reduction, query_order=order)
    jmod = JLocalAggregation(16, 0.1, nsample, **kw)
    variables = _vars(jmod, jnp.asarray(xyz), jnp.asarray(feats), train=False, seed=6)
    want = _apply(jmod, variables, jnp.asarray(xyz), jnp.asarray(feats), train=False)
    mod = load_flax_variables(LocalAggregation(16, 0.1, nsample, **kw), variables).eval()
    got = mod(torch.from_numpy(xyz), torch.from_numpy(feats))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL, rtol=TOL)


# --- nn/registry.py ---------------------------------------------------------


def _block_pair(rng, features, train=False, **kw):
    x = (rng.standard_normal((2, 30, 5, 12)) * 2.0 + 0.5).astype(np.float32)
    jmod = JMLPBlock(features, **kw)
    variables = _vars(jmod, jnp.asarray(x), train=False, seed=7)
    if train:
        want, _ = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jmod.apply(variables, jnp.asarray(x), train=False)
    mod = load_flax_variables(MLPBlock(12, features, **kw), variables)
    got = mod.train(train)(torch.from_numpy(x))
    return np.asarray(want), got.detach().numpy()


NORMS = ["bn", "syncbn", "bn2d", "fastbn1d", "ln", "ln1d", "gn", "gn2d", "in", "in1d"]


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("train", [False, True])
def test_registry_norms_match_jax(rng, norm, train):
    want, got = _block_pair(rng, 24, train=train, norm_type=norm)
    np.testing.assert_allclose(got, want, atol=NORM_TOL, rtol=NORM_TOL)


ACTS = ["silu", "swish", "mish", "relu", "relu6", "leaky_relu", "leakyrelu", "elu", "celu", "selu", "gelu",
        "sigmoid", "tanh", "hard_sigmoid", "hard_swish", "prelu"]


@pytest.mark.parametrize("act", ACTS)
def test_registry_activations_match_jax(rng, act):
    want, got = _block_pair(rng, 24, act_type=act, norm_type="ln")
    np.testing.assert_allclose(got, want, atol=NORM_TOL, rtol=NORM_TOL)


@pytest.mark.parametrize("order", ["conv-norm-act", "norm-act-conv", "conv-act-norm"])
@pytest.mark.parametrize("norm", ["bn", "gn"])
def test_block_orders_match_jax(rng, order, norm):
    want, got = _block_pair(rng, 20, order=order, norm_type=norm, act_type="gelu")
    np.testing.assert_allclose(got, want, atol=NORM_TOL, rtol=NORM_TOL)
    want, got = _block_pair(rng, 20, order=order, use_bn=False)
    np.testing.assert_allclose(got, want, atol=NORM_TOL, rtol=NORM_TOL)


@pytest.mark.parametrize("args", [{"act": "leakyrelu", "negative_slope": 0.2}, {"act": "gelu", "approximate": False},
                                  {"act": "elu", "alpha": 0.5}, {"act": "CELU", "alpha": 2.0, "inplace": True},
                                  "Tanh", None, {"act": None}])
def test_create_act_matches_jax(rng, args):
    x = (rng.standard_normal((4, 33)) * 3).astype(np.float32)
    j, p = jreg.create_act(args), registry.create_act(args)
    if j is None:
        assert p is None
        return
    np.testing.assert_allclose(p(torch.from_numpy(x)).numpy(), np.asarray(j(jnp.asarray(x))), atol=NORM_TOL,
                               rtol=NORM_TOL)


def test_registry_tables_match_jax():
    for c in (1, 7, 24, 64, 96, 100, 250):
        assert registry.default_groups(c) == jreg._default_groups(c)
    assert registry.CHANNEL_MAP.keys() == jreg.CHANNEL_MAP.keys()
    for key, fn in registry.CHANNEL_MAP.items():
        assert fn(17) == jreg.CHANNEL_MAP[key](17), key
    with pytest.raises(ValueError, match="not supported"):
        registry.create_norm("weird", 8)
    with pytest.raises(ValueError, match="not supported"):
        registry.create_act("swoosh")
    assert isinstance(registry.create_norm({"norm": "gn", "num_groups": 4, "eps": 1e-3}, 8), registry.StatlessNorm)
    assert registry.create_norm("bn", 8, dimension="2d").eps == 1e-5
    assert isinstance(registry.create_act({"act": "prelu", "init": 0.1}), registry.PReLU)


# --- ops/trilinear.py, labels/focal.py -------------------------------------


def test_trilinear_sample_matches_jax(rng):
    volume = rng.standard_normal((2, 5, 4, 6, 3)).astype(np.float32)
    points = rng.uniform(-0.1, 1.1, (2, 50, 3)).astype(np.float32)  # some outside [0, 1]^3: clipped
    points[0, :3] = (0.0, 1.0, 0.5)
    want = np.asarray(j_trilinear_sample(jnp.asarray(volume), jnp.asarray(points)))
    got = trilinear_sample(torch.from_numpy(volume), torch.from_numpy(points)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_focal_loss_matches_jax(rng, reduction, weighted):
    logits = (rng.standard_normal((6, 10, 4)) * 2).astype(np.float32)
    target = rng.integers(0, 4, (6, 10))
    alpha = rng.uniform(0.5, 2.0, 4).astype(np.float32) if weighted else None
    valid = (rng.random((6, 10)) < 0.7).astype(np.float32) if weighted else None

    def jloss(x):
        return j_focal_loss(x, jnp.asarray(target), alpha=None if alpha is None else jnp.asarray(alpha),
                            valid=None if valid is None else jnp.asarray(valid), reduction=reduction)

    want = np.asarray(jloss(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    got = focal_loss(x, torch.from_numpy(target), alpha=None if alpha is None else torch.from_numpy(alpha),
                     valid=None if valid is None else torch.from_numpy(valid), reduction=reduction)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, rtol=1e-6)
    got.sum().backward()
    want_grad = np.asarray(jax.grad(lambda x: jnp.sum(jloss(x)))(jnp.asarray(logits)))
    np.testing.assert_allclose(x.grad.numpy(), want_grad, atol=1e-6, rtol=1e-5)


def test_binary_focal_loss_matches_jax(rng):
    logits = (rng.standard_normal((5, 40)) * 3).astype(np.float32)
    target = rng.integers(0, 3, (5, 40))  # 2: neither class, no term
    want = float(j_binary_focal_loss(jnp.asarray(logits), jnp.asarray(target)))
    x = torch.from_numpy(logits).requires_grad_()
    got = binary_focal_loss(x, torch.from_numpy(target))
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    got.backward()
    want_grad = np.asarray(jax.grad(lambda x: j_binary_focal_loss(x, jnp.asarray(target)))(jnp.asarray(logits)))
    np.testing.assert_allclose(x.grad.numpy(), want_grad, atol=1e-7, rtol=1e-5)


# --- the bfloat16 DSN -------------------------------------------------------


def test_bf16_dsn_forward_matches_jax():
    pc = j_make_batch(2, 2, TINY_SCENE)["point_clouds"]
    jdsn = JDSN(pt_stages=TINY_PT_STAGES, dtype=jnp.bfloat16)
    variables = _vars(jdsn, jnp.asarray(pc), train=False, seed=8)
    fn = jax.jit(lambda v, x: jdsn.apply(v, x, train=False))
    want = fn.lower(variables, jnp.asarray(pc)).compile({"xla_allow_excess_precision": False})(
        variables, jnp.asarray(pc))
    dsn = load_flax_variables(DSN(TINY_PT_STAGES, dtype=torch.bfloat16), variables).eval()
    assert {t.dtype for t in dsn.state_dict().values()} == {torch.float32}
    got = dsn(torch.from_numpy(pc))
    np.testing.assert_array_equal(got["seed_xyz"].numpy(), np.asarray(want["seed_xyz"]))
    for key in ("foreground_logits", "center_offsets"):
        g, w = got[key], np.asarray(want[key])
        assert g.dtype == torch.float32 and w.dtype == np.float32
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= BF16_TOL * scale, f"{key}: {err:.3g} > {BF16_TOL} x {scale:.3g}"
    # and it differs from the float32 DSN by bfloat16 rounding, not less
    f32 = load_flax_variables(DSN(TINY_PT_STAGES), variables).eval()(torch.from_numpy(pc))
    assert not torch.equal(f32["foreground_logits"], got["foreground_logits"])


# --- random_sample ------------------------------------------------------------


def test_random_sample_contract():
    xyz = torch.zeros((3, 50, 3))
    gen = torch.Generator().manual_seed(0)
    idx = random_sample(xyz, 20, gen)
    assert idx.shape == (3, 20) and idx.dtype == torch.int32
    for row in idx:
        assert len(set(row.tolist())) == 20 and int(row.min()) >= 0 and int(row.max()) < 50
    # every point drawn equally often: 2,000 draws of 20 of 50 points, 800
    # a point expected, binomial std ~22; 6 std either way
    counts = torch.bincount(torch.cat([random_sample(xyz, 20, gen).reshape(-1).long() for _ in range(667)]),
                            minlength=50)
    expect = 667 * 3 * 20 / 50
    assert int(counts.sum()) == 667 * 60
    assert float((counts - expect).abs().max()) < 6 * (expect * (1 - 20 / 50)) ** 0.5
    assert torch.equal(random_sample(xyz, 20, torch.Generator().manual_seed(0)), idx)  # seeded: reproducible
    with pytest.raises(ValueError, match="num_samples"):
        random_sample(xyz, 51, gen)
