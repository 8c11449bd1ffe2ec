"""The port's initialisation of a fresh model (nn.layers.init_flax_defaults_)
against flax's defaults, which the JAX package's modules use: every Dense
kernel lecun_normal (a normal truncated to +-2 std, rescaled to std
1/sqrt(fan_in)) and every bias 0; BatchNorm and LayerNorm scales 1,
offsets 0.

For each nn.Linear of GraspBalance (tests/tiny.py's stage table, 24 views)
and of DSN (tests/test_torch_dsn.py's tiny stages):
  - the bias is exactly 0;
  - max |w| <= 2 * std / 0.8796 + 1e-6, std = 1/sqrt(fan_in);
  - on layers with at least 4,096 weights (MIN_WEIGHTS: there the sample
    std of either side is within ~1.6% of the true one, so 10% is over six
    standard errors), the weight's sample std within 10% of the std of the
    JAX package's model.init parameter at the same path;
  - the same seed gives bit-equal weights, two seeds different ones.
Also BatchNorm / LayerNorm at their flax values, and create_train_state
initialising from cfg.train.seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from graspbalance_tpu.data.synthetic import make_batch as j_make_batch
from graspbalance_tpu.models.dsn import DSN as JDSN
from graspbalance_tpu.models.graspbalance import GraspBalance as JGraspBalance
from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
from graspbalance_tpu_torch.models import DSN, GraspBalance
from graspbalance_tpu_torch.nn.layers import TRUNC_NORMAL_STD, BatchNorm, init_flax_defaults_
from graspbalance_tpu_torch.train.config import Config, ModelConfig, TrainConfig
from graspbalance_tpu_torch.train.train_step import create_train_state
from graspbalance_tpu_torch.weights import state_dict_from_flax
from tiny import TINY_NUM_SEED, TINY_NUM_VIEW, TINY_SCENE, TINY_STAGES
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

MIN_WEIGHTS = 4096
STD_RTOL = 0.10
TINY_PT_STAGES = ((64, 0.2, 8, 16, 1), (32, 0.4, 8, 32, 1))


def _port_models():
    return {
        "graspbalance": GraspBalance(num_view=TINY_NUM_VIEW, backbone_stages=TINY_STAGES, num_seed=TINY_NUM_SEED),
        "dsn": DSN(TINY_PT_STAGES),
    }


@pytest.fixture(scope="module")
def jax_variables():
    """model.init of the JAX package's GraspBalance and DSN (numpy)."""
    batch = {k: jnp.asarray(v) for k, v in j_make_batch(0, 1, TINY_SCENE).items()}
    jgb = JGraspBalance(num_view=TINY_NUM_VIEW, backbone_stages=TINY_STAGES, num_seed=TINY_NUM_SEED)
    gb = jax.jit(lambda r, b: jgb.init(r, b, train=True))(jax.random.PRNGKey(0), batch)
    jdsn = JDSN(pt_stages=TINY_PT_STAGES)
    dsn = jax.jit(lambda r, pc: jdsn.init(r, pc, train=False))(jax.random.PRNGKey(1), batch["point_clouds"])
    to_np = lambda v: jax.tree_util.tree_map(np.asarray, dict(v))  # noqa: E731
    return {"graspbalance": to_np(gb), "dsn": to_np(dsn)}


def _linears(model):
    return [(name, mod) for name, mod in model.named_modules() if isinstance(mod, nn.Linear)]


@pytest.mark.parametrize("which", ["graspbalance", "dsn"])
def test_linear_layers_match_flax_defaults(jax_variables, which):
    model = _port_models()[which]
    init_flax_defaults_(model, torch.Generator().manual_seed(0))
    want = state_dict_from_flax(jax_variables[which], model)
    compared = 0
    for name, lin in _linears(model):
        w = lin.weight.detach()
        std = 1.0 / np.sqrt(lin.in_features)
        if lin.bias is not None:
            assert torch.count_nonzero(lin.bias) == 0, name
        assert float(w.abs().max()) <= 2 * std / TRUNC_NORMAL_STD + 1e-6, name
        if w.numel() >= MIN_WEIGHTS:
            j_std = float(want[f"{name}.weight"].std())
            assert abs(float(w.std()) - j_std) <= STD_RTOL * j_std, (name, float(w.std()), j_std)
            compared += 1
    assert compared >= (10 if which == "graspbalance" else 2), compared


@pytest.mark.parametrize("which", ["graspbalance", "dsn"])
def test_norms_at_flax_defaults(which):
    model = _port_models()[which]
    for mod in model.modules():  # move every norm off its default first
        if isinstance(mod, (BatchNorm, nn.LayerNorm)):
            with torch.no_grad():
                for t in (mod.weight, mod.bias) + ((mod.running_mean, mod.running_var) if isinstance(mod, BatchNorm) else ()):
                    t.add_(0.5)
    init_flax_defaults_(model, torch.Generator().manual_seed(0))
    n = 0
    for mod in model.modules():
        if isinstance(mod, (BatchNorm, nn.LayerNorm)):
            assert torch.all(mod.weight == 1) and torch.all(mod.bias == 0)
            if isinstance(mod, BatchNorm):
                assert torch.all(mod.running_mean == 0) and torch.all(mod.running_var == 1)
            n += 1
    assert n > 0


@pytest.mark.parametrize("which", ["graspbalance", "dsn"])
def test_seeded_weights(which):
    a, b, c = (init_flax_defaults_(_port_models()[which], torch.Generator().manual_seed(s)) for s in (3, 3, 4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    weights = [k for k in sa if k.endswith("weight") and sa[k].ndim == 2]
    assert weights and all(not torch.equal(sa[k], sc[k]) for k in weights)


def test_create_train_state_initialises_from_the_seed():
    cfg = Config(
        model=ModelConfig(num_view=TINY_NUM_VIEW, num_seed=TINY_NUM_SEED, backbone_stages=TINY_STAGES),
        train=TrainConfig(seed=5),
    )
    scene = SceneConfig(**{f: getattr(TINY_SCENE, f) for f in SceneConfig.__dataclass_fields__})
    sample = make_batch(0, 1, scene)
    state = create_train_state(cfg, 10, sample, device="cpu")
    want = init_flax_defaults_(_port_models()["graspbalance"], torch.Generator().manual_seed(5)).state_dict()
    got = state.model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert state.step == 0
    with pytest.raises(ValueError, match="grasp_labels"):
        create_train_state(cfg, 10, {k: v for k, v in sample.items() if k != "grasp_labels"}, device="cpu")
