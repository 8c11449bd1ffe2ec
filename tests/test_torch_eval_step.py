"""The port's eval step (train_step.eval_step) against the JAX package's
make_eval_step: the reference's loss-only eval, with BatchNorm on its
running statistics, the training label matching, and get_loss's metrics.

The model, batch and stage table are tests/test_torch_train.py's (its
pairwise BatchNorm mean fixture too, which only the initialisation's
train-mode forward reads here); the weights are the JAX initialisation
with running statistics moved off their defaults (means N(0, 0.01),
variances in [0.5, 1.5]), bridged with weights.py.

Tolerance: the loss and every metric within 1e-4 relative (1e-7 absolute
for metrics that are 0). Every top view of the JAX eval forward wins its
argmax by more than 1e-4, so a flip fails as a bad input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graspbalance_tpu.data.synthetic import make_batch as j_make_batch
from graspbalance_tpu.train import train_step as jts
from graspbalance_tpu_torch.data.synthetic import make_batch
from graspbalance_tpu_torch.train.train_step import build_model, eval_step
from graspbalance_tpu_torch.weights import load_flax_variables
from test_torch_train import CFG, J_SCENE, JCFG, SCENE, pairwise_bn_mean  # noqa: F401
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

TOL = 1e-4


@pytest.fixture(scope="module")
def eval_run(pairwise_bn_mean):  # noqa: F811
    """make_eval_step's metrics, the port's eval_step's, and the JAX eval
    forward's view scores, on the same batch and weights."""
    jbatch = {k: jnp.asarray(v) for k, v in j_make_batch(0, 2, J_SCENE).items()}
    jmodel = jts.build_model(JCFG)
    variables = jax.jit(lambda r, b: jmodel.init(r, b, train=True))(jax.random.PRNGKey(3), jbatch)
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.uniform(0.5, 1.5, x.shape) if path[-1].key == "var"
                         else 0.1 * rng.standard_normal(x.shape)).astype(np.float32),
        variables["batch_stats"],
    )
    variables = {"params": jax.tree_util.tree_map(np.asarray, variables["params"]), "batch_stats": stats}
    state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"], opt_state=(), tx=None)
    want = jts.make_eval_step(jmodel, JCFG)(state, jbatch)
    view_score = jax.jit(lambda v, b: jmodel.apply(v, b, train=False, match_labels=True)["view_score"])(
        variables, jbatch)
    model = load_flax_variables(build_model(CFG, device="cpu"), variables)
    got = eval_step(model, make_batch(0, 2, SCENE), CFG)
    return {k: float(v) for k, v in want.items()}, got, np.asarray(view_score), model


def test_eval_step_matches_jax(eval_run):
    want, got, view_score, _ = eval_run
    top2 = -np.sort(-view_score, axis=-1)
    assert (top2[..., 0] - top2[..., 1]).min() > TOL  # no top view near a tie
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(float(got[key]), want[key], rtol=TOL, atol=1e-7, err_msg=key)


def test_eval_step_runs_without_gradients_in_eval_mode(eval_run):
    got, model = eval_run[1], eval_run[3]
    assert not model.training
    assert all(not v.requires_grad and v.ndim == 0 for v in got.values())
    assert all(p.grad is None for p in model.parameters())
