"""The port's quality gate started from the JAX package's own initial
weights, so that the two gates differ only in how they train, not in the
random draw they start from.

    # on the CPU, with the JAX package: its gate's initial variables (the
    # full model, cfg.train.seed's key), bridged to the port's keys
    JAX_PLATFORMS=cpu python tests/gate_from_jax_init.py export logs/jax_gate_init.pt
    # on the card, without JAX: cli/quality_gate.run_gate from those weights
    python tests/gate_from_jax_init.py run logs/jax_gate_init.pt --steps 800 --dtype bfloat16

``run`` prints the gate's JSON line. Its "untrained" entry evaluates the
JAX initialisation itself, so it can be read against the JAX tool's own
untrained numbers at the gate's seeds (QUALITY_GATE_MIXED_r05.json).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def export(path: str, bs: int, num_points: int) -> None:
    import jax
    import numpy as np
    import torch

    from graspbalance_tpu.data.synthetic import make_batch
    from graspbalance_tpu.train import train_step as jts
    from graspbalance_tpu.train.config import Config, DataConfig, ModelConfig, TrainConfig
    from graspbalance_tpu_torch.train.config import Config as PortConfig
    from graspbalance_tpu_torch.train.train_step import build_model
    from graspbalance_tpu_torch.weights import state_dict_from_flax
    from tools.quality_gate import gate_scene

    cfg = Config(model=ModelConfig(dtype="bfloat16"), data=DataConfig(analytic_labels=True, batch_size=bs),
                 train=TrainConfig(max_epoch=1))
    _, state = jts.create_train_state(cfg, 1, make_batch(0, bs, gate_scene(num_points)))
    variables = jax.tree_util.tree_map(np.array, {"params": state.params, "batch_stats": state.batch_stats})
    torch.save(state_dict_from_flax(variables, build_model(PortConfig(), device="cpu")), path)
    print(f"wrote {path}")


def run(path: str, steps: int, bs: int, dtype: str, mixed_train: bool, device: str) -> None:
    import json

    import torch

    import graspbalance_tpu_torch.train.train_step as train_step
    from graspbalance_tpu_torch.cli.quality_gate import run_gate

    init = torch.load(path, weights_only=True)
    create = train_step.create_train_state

    def from_jax_init(*args, **kwargs):
        state = create(*args, **kwargs)
        state.model.load_state_dict(init)
        return state

    train_step.create_train_state = from_jax_init
    try:
        out = run_gate(steps, bs, dtype, mixed_train=mixed_train, device=device)
    finally:
        train_step.create_train_state = create
    print(json.dumps(out))


def main():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("command", choices=["export", "run"])
    p.add_argument("path")
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--bs", type=int, default=4)
    p.add_argument("--num_points", type=int, default=20000)
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--mixed_train", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    if args.command == "export":
        export(args.path, args.bs, args.num_points)
    else:
        run(args.path, args.steps, args.bs, args.dtype, args.mixed_train, args.device)


if __name__ == "__main__":
    main()
