"""graspbalance_tpu_torch/utils/misc.py against graspbalance_tpu/utils/misc.py
on the same variables (a tiny DRP's, random from a seed): the parameter
count and bytes exactly, the global norm within float32 rounding (1e-6
relative: both sum squares in float32, in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspbalance_tpu.models.drp import DRP as JDRP
from graspbalance_tpu.utils.misc import count_params as j_count_params
from graspbalance_tpu.utils.misc import param_bytes as j_param_bytes
from graspbalance_tpu.utils.misc import tree_norm as j_tree_norm
from graspbalance_tpu_torch.models.drp import DRP
from graspbalance_tpu_torch.utils.misc import count_params, param_bytes, tree_norm
from graspbalance_tpu_torch.weights import load_flax_variables
from test_torch_parallel_backbone import NUM_SEED, STAGES
from test_torch_variants import _vars
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)


@pytest.fixture(scope="module")
def models():
    pts = (np.random.default_rng(0).random((1, 256, 3), dtype=np.float32) - 0.5)
    variables = _vars(JDRP(stages=STAGES, num_seed=NUM_SEED), jnp.asarray(pts), train=False)
    return variables, load_flax_variables(DRP(STAGES, num_seed=NUM_SEED), variables)


def test_counts_match_jax(models):
    variables, drp = models
    params = variables["params"]
    assert count_params(drp) == j_count_params(params) > 0
    assert param_bytes(drp) == j_param_bytes(params) == 4 * count_params(drp)
    # a state dict holds the statistics too, as the JAX tree with batch_stats does
    assert count_params(drp.state_dict()) == j_count_params(variables)
    assert param_bytes(drp.state_dict()) == j_param_bytes(variables)


def test_tree_norm_matches_jax(models):
    variables, drp = models
    np.testing.assert_allclose(float(tree_norm(drp).detach()), float(j_tree_norm(variables["params"])), rtol=1e-6)


def test_tree_norm_of_gradients_skips_unused():
    lin = torch.nn.Linear(3, 2)
    extra = torch.nn.Parameter(torch.ones(4))  # no gradient: p.grad stays None
    lin(torch.ones(1, 3)).sum().backward()
    grads = [lin.weight.grad, lin.bias.grad, extra.grad]
    want = torch.sqrt(lin.weight.grad.square().sum() + lin.bias.grad.square().sum())
    assert float(tree_norm(grads)) == pytest.approx(float(want), rel=1e-7)
    assert count_params(grads) == 8
