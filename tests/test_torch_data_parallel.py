"""Data-parallel training on the port (graspbalance_tpu_torch/parallel/mesh.py,
train/train_step.py, train/seg_step.py, train/loop.py): n_data_shards=2 on
two gloo ranks on the CPU (parallel/ranks.py, one torch thread a rank, a
``file://`` store under tmp_path), each rank holding one of the batch's two
scenes.

The grasp model's step is held, from one state (the JAX model's initial
weights, bridged), on tests/test_torch_train.py's batch and stage table,
against the port's one-process step on the whole batch and against the JAX
package's make_train_step on the whole batch, which equals its mesh step
(tests/test_train.py). Then the same two-rank step with a planted fault
must fail the comparison with the one-process step: BatchNorm statistics of
each rank's own rows ('bn'), and each rank's own loss denominators with the
loss the mean of the ranks' ratios ('loss', DDP's convention). The DSN's
step is held against its one-process step from one state. The training
loop's ranks: tests/test_torch_data_parallel_loop.py.

The weights are the JAX model's initial ones, as in test_torch_train.py,
whose stage table and batch were chosen so that the batch-statistics
forward does not amplify rounding past its tolerances from them: from the
port's own seeded initialisation on the same table, the rounding of
BatchNorm's statistics alone (one process, float32 sums against float64
ones) already moves some gradients by 1.6e-2 of their tensor's largest.

Tolerances, two ranks against one process (both the port). The two ranks
add their partial sums of BatchNorm's statistics and of the losses'
denominators (in float64 across the ranks) where one process sums all rows
in one cascade, and this tiny model's batch-statistics forward amplifies
that rounding as it amplifies the port's against the JAX package's
(test_torch_train.py's docstring), so the bounds are those of the port
against the JAX package, test_torch_train.py's and test_torch_dsn_train.py's:
  - the loss and every metric: LOSS_RTOL = 1e-4 relative (atol 1e-7 where
    the metric is 0); measured at most 1.5e-6 (grasp model) and 1.1e-5
    (the DSN's center loss);
  - every gradient: within GRAD_TOL = 1e-3 of its tensor's largest |grad|,
    or of GRAD_FLOOR x the model's largest |grad| where that is larger (the
    biases whose exact gradient is 0 hold rounding noise on both sides);
    measured at most 1.2e-4 (grasp) and 2e-4 (DSN, a zero-gradient bias);
  - the parameters after Adam's first step: within 2 x lr + 1e-7 (Adam moves
    an element by lr whatever its gradient's size, so noise may step the
    other way), and within 1e-3 x lr + 2 ulp where the gradient is firm (its
    |grad| above FIRM x the gradient check's scale);
  - the BatchNorm running statistics: STAT_TOL = 1e-4 x max(1, largest
    |statistic|); measured 7e-6.
The planted faults move the loss by 7e-2 ('bn') and 9e-3 ('loss') relative
and the gradients by more than 0.5 of their tensors' largest.
Against the JAX step on the whole batch, test_torch_train.py's tolerances
for one step: the loss and metrics 1e-4 relative, parameters and running
statistics within STEP_TOL. Each rank ends every step with the same
parameters, bit for bit.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspbalance_tpu.train import train_step as jts
from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
from graspbalance_tpu_torch.models.dsn import DSN
from graspbalance_tpu_torch.parallel.ranks import run_ranks
from graspbalance_tpu_torch.train.config import config_to_dict
from graspbalance_tpu_torch.train.seg_step import init_dsn, make_seg_optimizer, seg_train_step
from graspbalance_tpu_torch.train.train_step import make_optimizer, train_step
from graspbalance_tpu_torch.weights import state_dict_from_flax
from test_torch_dsn_train import MAX_OBJECTS as DSN_MAX_OBJECTS
from test_torch_dsn_train import SCENE_KW as DSN_SCENE_KW
from test_torch_dsn_train import STAGES as DSN_STAGES
from test_torch_dsn_train import STEPS as DSN_STEPS
from test_torch_train import (  # noqa: F401  (pairwise_bn_mean and setup are fixtures)
    BATCH_SEED,
    CFG,
    EPOCH,
    JCFG,
    SCENE,
    STEP_TOL,
    STEPS_PER_EPOCH,
    _new_port_model,
    _np_tree,
    pairwise_bn_mean,
    setup,
)
from torch_ranks import FAULTS, after_step, dp_step_ranks
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

S = 2
LOSS = "loss/overall_loss"
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3
GRAD_FLOOR = 1e-4
FIRM = 1e-2
STAT_TOL = 1e-4
JAX_TOL = 1e-4
DP_CFG = dataclasses.replace(CFG, train=dataclasses.replace(CFG.train, n_data_shards=S))
FIRST_LR = CFG.train.learning_rate / 25  # OneCycle's first rate, max_lr / div_factor
DSN_LR = 1e-3


def _start_ranks(tmp, fn, world):
    """Run ``fn`` on ``world`` ranks on a thread, so that this process
    works on meanwhile; the returned function waits and returns the ranks'
    results (raising what the run raised)."""
    failure = []

    def run():
        try:
            run_ranks(fn, world, (str(tmp / "in.pt"), str(tmp)), init_file=str(tmp / "store"), threads=1,
                      timeout=300)
        except BaseException as e:  # raised by the waiting caller
            failure.append(e)

    thread = threading.Thread(target=run)
    thread.start()

    def wait():
        thread.join()
        if failure:
            raise failure[0]
        return [torch.load(tmp / f"rank{r}.pt") for r in range(world)]

    return wait


@pytest.fixture(scope="module")
def steps(setup, tmp_path_factory):
    """(the one-process port steps, the two ranks' results, the JAX step):
    the grasp model's step from the JAX initial variables on the whole
    batch, and the DSN's from init_dsn(0)."""
    batch, jmodel, variables = setup
    state0 = _new_port_model(variables).state_dict()
    tb = make_batch(BATCH_SEED, 2, SCENE)
    dsn_state0 = init_dsn(DSN(DSN_STAGES), 0).state_dict()
    db = make_batch(1, 2, SceneConfig(**DSN_SCENE_KW))
    tmp = tmp_path_factory.mktemp("dp_steps")
    torch.save({"cfg": config_to_dict(DP_CFG), "state": state0,
                "batch": {k: torch.from_numpy(v) for k, v in tb.items()},
                "epoch": EPOCH, "steps_per_epoch": STEPS_PER_EPOCH, "dsn_stages": DSN_STAGES,
                "dsn_state": dsn_state0, "dsn_steps": DSN_STEPS, "dsn_max_objects": DSN_MAX_OBJECTS,
                "dsn_cloud": torch.from_numpy(db["point_clouds"][..., :3].copy()),
                "dsn_instance": torch.from_numpy(db["instance_label"])}, tmp / "in.pt")
    ranks = _start_ranks(tmp, dp_step_ranks, S)

    model = _new_port_model(variables)
    optimizer, scheduler = make_optimizer(model, CFG, STEPS_PER_EPOCH)
    one = {"grasp": after_step(model, train_step(model, optimizer, scheduler, tb, EPOCH, CFG))}
    dsn = DSN(DSN_STAGES)
    dsn.load_state_dict(dsn_state0)
    optimizer, scheduler = make_seg_optimizer(dsn, DSN_STEPS, DSN_LR)
    one["dsn"] = after_step(dsn, seg_train_step(dsn, optimizer, scheduler, db["point_clouds"],
                                                db["instance_label"], DSN_MAX_OBJECTS))

    tx = jts.make_optimizer(JCFG, steps_per_epoch=STEPS_PER_EPOCH)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = jts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                            opt_state=tx.init(params), tx=tx)
    jstate, jmetrics = jts.make_train_step(jmodel, JCFG)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(EPOCH))
    jax_out = {"metrics": {k: float(v) for k, v in jmetrics.items()},
               "state": state_dict_from_flax(_np_tree({"params": jstate.params, "batch_stats": jstate.batch_stats}),
                                             model)}
    return one, ranks(), jax_out


def _check_step(got, want, lr):
    """Raise AssertionError where the two-rank step ``got`` leaves the
    one-process step ``want`` by more than the module's tolerances."""
    assert got["metrics"].keys() == want["metrics"].keys()
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    grads = want["grads"]
    model_max = max(float(g.abs().max()) for g in grads.values())
    for k, w in grads.items():
        scale = max(float(w.abs().max()), GRAD_FLOOR * model_max)
        err = float((got["grads"][k] - w).abs().max())
        assert err <= GRAD_TOL * scale, f"gradient {k}: {err:.3g} > {GRAD_TOL} x {scale:.3g}"
    for k, w in want["state"].items():
        g = got["state"][k]
        if "running" in k:
            np.testing.assert_allclose(g, w, atol=STAT_TOL * max(1.0, float(w.abs().max())), rtol=0, err_msg=k)
            continue
        np.testing.assert_allclose(g, w, atol=2 * lr + 1e-7, rtol=0, err_msg=k)
        gk = grads[k]
        firm = (gk.abs() > FIRM * max(float(gk.abs().max()), GRAD_FLOOR * model_max)).numpy()
        np.testing.assert_allclose(g.numpy()[firm], w.numpy()[firm], atol=1e-3 * lr, rtol=2.0**-22, err_msg=k)


def test_ranks_end_the_step_with_equal_parameters(steps):
    ranks = steps[1]
    for name in (*FAULTS, "dsn"):
        for k, v in ranks[0][name]["state"].items():
            if name == "bn" and "running" in k:  # the fault keeps each rank's own statistics
                continue
            assert torch.equal(v, ranks[1][name]["state"][k]), (name, k)


def test_two_rank_step_matches_one_process_step(steps):
    one, ranks, _ = steps
    _check_step(ranks[0]["none"], one["grasp"], FIRST_LR)


@pytest.mark.parametrize("fault", ["bn", "loss"])
def test_planted_fault_fails_the_comparison(steps, fault):
    one, ranks, _ = steps
    with pytest.raises(AssertionError):
        _check_step(ranks[0][fault], one["grasp"], FIRST_LR)


def test_two_rank_step_matches_jax_step(steps, setup):
    _, ranks, want = steps
    got = ranks[0]["none"]
    np.testing.assert_allclose(got["metrics"][LOSS], want["metrics"][LOSS], rtol=JAX_TOL)
    assert got["metrics"].keys() == want["metrics"].keys()
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=JAX_TOL, atol=1e-7, err_msg=k)
    assert got["state"].keys() == want["state"].keys()
    for k, w in want["state"].items():
        err = float((got["state"][k] - w).abs().max())
        assert err <= STEP_TOL, f"{k}: {err:.3g} > {STEP_TOL:.3g}"


def test_two_rank_dsn_step_matches_one_process_step(steps):
    one, ranks, _ = steps
    _check_step(ranks[0]["dsn"], one["dsn"], float(make_seg_optimizer(DSN(DSN_STAGES), DSN_STEPS, DSN_LR)[0]
                                                    .param_groups[0]["lr"]))
