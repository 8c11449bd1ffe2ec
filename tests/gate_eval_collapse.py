"""The quality gate's eval-mode collapse, reproduced on the CPU in both
packages at a cut stage table (one InvResMLP block per stage, 256/128/64/32
centres, 128 seeds, 300 views; 2,048-point gate scenes with 1,024 label
points), from the same JAX initial weights and on the same batches.

    JAX_PLATFORMS=cpu python tests/gate_eval_collapse.py --steps 100

Prints the kept grasps on two held-out gate batches before and after
training for each package (and for the port's eval on the JAX-trained
weights), the training losses every 20 steps, and, for the trained
weights of each, the seeds decoded as graspable and the objectness logit
margin (class 1 minus class 0) with the BatchNorm layers on their running
statistics and on each batch's own (momentum 0, nothing updated).
"""

import argparse
import copy
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from graspbalance_tpu.data.synthetic import SceneConfig as JSceneConfig  # noqa: E402
from graspbalance_tpu.data.synthetic import make_batch as j_make_batch  # noqa: E402
from graspbalance_tpu.eval.pipeline import GraspInference as JGraspInference  # noqa: E402
from graspbalance_tpu.train import train_step as jts  # noqa: E402
from graspbalance_tpu.train.config import Config as JConfig  # noqa: E402
from graspbalance_tpu.train.config import DataConfig as JDataConfig  # noqa: E402
from graspbalance_tpu.train.config import ModelConfig as JModelConfig  # noqa: E402
from graspbalance_tpu.train.config import TrainConfig as JTrainConfig  # noqa: E402
from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch  # noqa: E402
from graspbalance_tpu_torch.eval.pipeline import GraspInference  # noqa: E402
from graspbalance_tpu_torch.train.config import Config, DataConfig, ModelConfig, TrainConfig  # noqa: E402
from graspbalance_tpu_torch.train.train_step import (  # noqa: E402
    build_model,
    create_train_state,
    set_bn_momentum,
    train_step,
)
from graspbalance_tpu_torch.weights import load_flax_variables  # noqa: E402

STAGES = (
    (256, 0.04, 64, (64, 64, 128), 1, 0.08, 64),
    (128, 0.10, 32, (128, 128, 256), 1, 0.20, 32),
    (64, 0.20, 16, (128, 128, 256), 1, 0.40, 16),
    (32, 0.30, 16, (128, 128, 256), 1, 0.60, 16),
)
NUM_SEED = 128
SCENE = dict(num_points=2048, analytic_labels=True, emit_label_tensors=False, table_extent=0.15,
             object_scatter=0.12, max_grasp_points=1024, grasp_points_per_object=100)


def main():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=100)
    steps = p.parse_args().steps
    jscene, scene = JSceneConfig(**SCENE), SceneConfig(**SCENE)
    jcfg = JConfig(model=JModelConfig(num_seed=NUM_SEED, backbone_stages=STAGES), data=JDataConfig(analytic_labels=True),
                   train=JTrainConfig(max_epoch=1))
    cfg = Config(model=ModelConfig(num_seed=NUM_SEED, backbone_stages=STAGES), data=DataConfig(analytic_labels=True),
                 train=TrainConfig(max_epoch=1))
    jmodel, jstate = jts.create_train_state(jcfg, steps, j_make_batch(0, 2, jscene))
    initial = jax.tree_util.tree_map(np.array, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    state = create_train_state(cfg, steps, make_batch(0, 2, scene), device="cpu")
    load_flax_variables(state.model, initial)
    held = [j_make_batch(1_000_000 + i, 2, jscene)["point_clouds"] for i in range(2)]

    def jax_kept(variables):
        infer = JGraspInference(jmodel, variables)
        return sum(int(np.asarray(infer(jnp.asarray(c))[1]).sum()) for c in held)

    def port_model(state_dict):
        model = build_model(cfg, device="cpu")
        model.load_state_dict(state_dict)
        return model

    def port_kept(model):
        infer = GraspInference(port_model(model.state_dict()), device="cpu")
        return sum(int(infer(c)[1].sum()) for c in held)

    print(f"untrained: kept JAX {jax_kept(initial)}, port {port_kept(state.model)}", flush=True)
    step = jts.make_train_step(jmodel, jcfg)
    for i in range(steps):
        jstate, jm = step(jstate, {k: jnp.asarray(v) for k, v in j_make_batch(1 + i, 2, jscene).items()}, jnp.int32(0))
        m = train_step(state.model, state.optimizer, state.scheduler, make_batch(1 + i, 2, scene), 0, cfg)
        if i % 20 == 0 or i == steps - 1:
            print(f"step {i + 1}: loss JAX {float(jm['loss/overall_loss']):.4f} port "
                  f"{float(m['loss/overall_loss']):.4f}", flush=True)
    trained = jax.tree_util.tree_map(np.array, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    on_jax = load_flax_variables(build_model(cfg, device="cpu"), trained)
    print(f"trained: kept JAX {jax_kept(trained)}, port {port_kept(state.model)}, "
          f"port's eval on the JAX-trained weights {port_kept(on_jax)}", flush=True)
    for name, model in (("port-trained", state.model), ("JAX-trained", on_jax)):
        for mode in ("running", "batch"):
            probe = copy.deepcopy(port_model(model.state_dict()))
            probe.train(mode == "batch")
            set_bn_momentum(probe, 0.0)
            with torch.no_grad():
                margins = []
                for c in held:
                    ep = probe.backbone(torch.from_numpy(c))
                    o = probe.graspable(ep["fp2_xyz"], ep["fp2_features"])["objectness_score"]
                    margins.append((o[..., 1] - o[..., 0]).flatten())
                margin = torch.cat(margins)
            print(f"{name}, {mode} statistics: graspable seeds {int((margin > 0).sum())}/{margin.numel()}, "
                  f"margin median {float(margin.median()):.3f}, largest {float(margin.max()):.3f}", flush=True)


if __name__ == "__main__":
    main()
