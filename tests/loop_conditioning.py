"""Why tests/test_torch_loop.py starts the port's epoch 1 from the JAX run's
state: how well defined the training step's gradient is there.

    JAX_PLATFORMS=cpu python tests/loop_conditioning.py

Runs the JAX package's training step for tests/test_torch_loop.py's first
step (its stage table, scene, learning rate and pairwise BatchNorm means), then,
at the JAX state after step 1 and on step 2's batch, computes the gradient
four ways and prints, per tensor, the largest error over the tensor's
largest |gradient| (floored at 1e-4 of the model's largest): the port in
float32 and the JAX package in float32, each against the port in float64;
and the port in float64 with every parameter moved by one float32 ulp
(relative 2^-24, random signs), against the same unmoved. When the last is
as large as the first, the gradient is not defined closer than float32
rounding at that state, and two runs that step on from it part by whatever
their hosts' rounding picks.
"""

import dataclasses
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import graspbalance_tpu.nn.layers as j_layers  # noqa: E402
from graspbalance_tpu.data.synthetic import make_batch as j_make_batch  # noqa: E402
from graspbalance_tpu.labels.losses import get_loss as j_get_loss  # noqa: E402
from graspbalance_tpu.nn.layers import bn_momentum_schedule as j_bn_momentum_schedule  # noqa: E402
from graspbalance_tpu.train import train_step as jts  # noqa: E402
from graspbalance_tpu.train.config import TrainConfig as JTrainConfig  # noqa: E402
from graspbalance_tpu_torch.data.synthetic import make_batch  # noqa: E402
from graspbalance_tpu_torch.train.train_step import build_model, forward_loss, to_device  # noqa: E402
from graspbalance_tpu_torch.weights import state_dict_from_flax  # noqa: E402
from test_torch_loop import LOOP_LR, _PairwiseMeanNumpy  # noqa: E402
from test_torch_train import CFG, J_SCENE, JCFG, SCENE  # noqa: E402

STEPS_PER_EPOCH = 2  # tests/test_torch_loop.py's


def _port_grads(state_dict, dtype, batch_seed):
    """The port's training-forward gradient in ``dtype`` from ``state_dict``
    (name -> tensor), on make_batch(batch_seed)."""
    model = build_model(CFG, device="cpu").to(dtype)
    model.load_state_dict({k: v.to(dtype) for k, v in state_dict.items()})
    batch = {k: (v.to(dtype) if v.is_floating_point() else v)
             for k, v in to_device(make_batch(batch_seed, 2, SCENE), "cpu").items()}
    loss, _ = forward_loss(model, batch, 0, CFG)
    loss.backward()
    return {n: p.grad.double().numpy() for n, p in model.named_parameters()}


def _errors(got, want):
    top = max(float(np.abs(w).max()) for w in want.values())
    errs = {n: float(np.abs(got[n] - w).max()) / max(float(np.abs(w).max()), 1e-4 * top) for n, w in want.items()}
    worst = max(errs, key=errs.get)
    return f"median {np.median(list(errs.values())):.3g}, largest {errs[worst]:.3g} ({worst})"


def main():
    j_layers.jnp = _PairwiseMeanNumpy()
    jcfg = dataclasses.replace(JCFG, train=JTrainConfig(max_epoch=2, learning_rate=LOOP_LR, n_data_shards=1))
    jmodel, state = jts.create_train_state(jcfg, STEPS_PER_EPOCH, j_make_batch(0, 2, J_SCENE))
    step = jts.make_train_step(jmodel, jcfg)
    state, _ = step(state, {k: jnp.asarray(v) for k, v in j_make_batch(0, 2, J_SCENE).items()}, jnp.int32(0))
    s1 = jax.tree_util.tree_map(np.array, {"params": state.params, "batch_stats": state.batch_stats})

    def loss_fn(params, b):
        ep, _ = jmodel.apply({"params": params, "batch_stats": s1["batch_stats"]}, b, train=True,
                             bn_momentum=j_bn_momentum_schedule(0), mutable=["batch_stats"])
        ep["objectness_label"] = b["objectness_label"]
        return j_get_loss(ep)[0]

    jb = {k: jnp.asarray(v) for k, v in j_make_batch(1, 2, J_SCENE).items()}
    jgrads = jax.tree_util.tree_map(np.array, jax.jit(jax.grad(loss_fn))(s1["params"], jb))
    model = build_model(CFG, device="cpu")
    j32 = {k: v.double().numpy() for k, v in state_dict_from_flax(
        {"params": jgrads, "batch_stats": s1["batch_stats"]}, model).items() if "running" not in k}

    sd = state_dict_from_flax(s1, model)
    p32 = _port_grads(sd, torch.float32, 1)
    p64 = _port_grads(sd, torch.float64, 1)
    rng = np.random.default_rng(0)
    moved = {k: v if "running" in k else v.double() * (1 + torch.from_numpy(rng.choice([-1.0, 1.0], v.shape)) * 2.0**-24)
             for k, v in sd.items()}
    p64_moved = _port_grads(moved, torch.float64, 1)
    print(f"step 2's gradient at the JAX state after step 1 (LOOP_LR {LOOP_LR}):")
    print(f"  port float32 against port float64: {_errors(p32, p64)}")
    print(f"  JAX float32 against port float64: {_errors(j32, p64)}")
    print(f"  port float64, parameters moved one float32 ulp, against unmoved: {_errors(p64_moved, p64)}")


if __name__ == "__main__":
    main()
