"""Closed-loop quality gate at production scale (port of
tools/quality_gate.py):

    python -m graspbalance_tpu_torch.cli.quality_gate --steps 800 --bs 4

Trains the full GraspBalance model on freshly drawn synthetic scenes with
analytic labels (labels/analytic.py, expanded on the device), every step at
epoch 0's BatchNorm momentum, then runs the complete inference pipeline
(forward -> pred_decode -> NMS -> collision filter) on held-out scenes and
scores every surviving grasp against the rule that made the labels. Prints
one JSON line: untrained, trained and oracle metrics on the gate's scenes,
and the trained model and the oracle on a mild and a hard shift of the
scene distribution. Training runs in ``--dtype`` (bfloat16 by default, the
JAX package's production setting; parameters, BatchNorm statistics, the
loss and Adam stay float32); the evals always run a float32 model with the
trained weights. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

GATE_SEED0 = 1_000_000  # the held-out eval scenes
XDIST_MILD_SEED0 = 4_000_000
XDIST_HARD_SEED0 = 3_000_000


def gate_scene(num_points: int = 20000):
    """Compact clutter: FPS seeds sample by spatial coverage, so the default
    wide table would take most of the 1,024 seeds and starve the
    graspable-classification signal."""
    from graspbalance_tpu_torch.data.synthetic import SceneConfig

    return SceneConfig(num_points=num_points, analytic_labels=True, emit_label_tensors=False,
                       table_extent=0.15, object_scatter=0.12)


def _rounded(metrics: dict) -> dict:
    return {k: round(v, 4) if isinstance(v, float) else v for k, v in metrics.items()}


def run_gate(steps: int, bs: int, dtype: str, eval_batches: int = 4, num_points: int = 20000, lr: float = 1e-3,
             mixed_train: bool = False, log=print, *, device="cuda", model_cfg=None) -> dict:
    """Train ``steps`` steps at batch size ``bs`` in ``dtype`` and return
    the gate's JSON record. ``model_cfg`` (a ModelConfig, default the full
    model) replaces the model's settings but its dtype; ``mixed_train``
    alternates the gate's scenes with default-extent ones."""
    import torch

    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
    from graspbalance_tpu_torch.eval.quality import evaluate_oracle_quality, evaluate_quality
    from graspbalance_tpu_torch.train.config import Config, DataConfig, ModelConfig, TrainConfig
    from graspbalance_tpu_torch.train.loop import Prefetch
    from graspbalance_tpu_torch.train.train_step import build_model, create_train_state, train_step

    scene = gate_scene(num_points)
    cfg = Config(
        model=dataclasses.replace(model_cfg or ModelConfig(), dtype=dtype),
        data=DataConfig(analytic_labels=True, batch_size=bs),
        train=TrainConfig(max_epoch=1, learning_rate=lr),
    )
    state = create_train_state(cfg, steps, make_batch(0, bs, scene), device=device)
    # inference runs a float32 model: the parameters are stored in float32
    # whatever the compute dtype, and the width head's fused kernel is f32
    eval_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype="float32"))
    eval_model = build_model(eval_cfg, device=device)

    def q(scene_cfg, seed0):
        eval_model.load_state_dict(state.model.state_dict())
        return evaluate_quality(eval_model, scene_cfg, num_batches=eval_batches, batch_size=bs, seed0=seed0,
                                device=device)

    def oracle(scene_cfg, seed0):
        return evaluate_oracle_quality(scene_cfg, num_batches=eval_batches, batch_size=bs, seed0=seed0,
                                       device=device)

    t0 = time.time()
    untrained = q(scene, GATE_SEED0)
    log(f"untrained: {json.dumps(untrained)} ({time.time() - t0:.0f}s)")

    # mixed_train: alternate compact-clutter and default-extent scenes (the
    # hard-shift eval below has no survivors after compact-only training)
    wide_scene = SceneConfig(num_points=num_points, analytic_labels=True, emit_label_tensors=False)

    def batches():
        for i in range(steps):
            yield make_batch(1 + i, bs, wide_scene if (mixed_train and i % 2) else scene)

    t0 = time.time()
    first_loss = None
    metrics = {}
    for i, b in enumerate(Prefetch(batches(), depth=3)):
        metrics = train_step(state.model, state.optimizer, state.scheduler, b, 0, cfg)
        state.step += 1
        if i == 0:
            first_loss = float(metrics["loss/overall_loss"])
            log(f"step 1 loss {first_loss:.3f} ({time.time() - t0:.0f}s)")
        elif (i + 1) % 100 == 0:
            log(f"step {i + 1} loss {float(metrics['loss/overall_loss']):.3f} "
                f"graspable_acc {float(metrics['stage1_graspable_acc']):.3f} "
                f"recall {float(metrics['stage1_graspable_recall']):.3f} ({time.time() - t0:.0f}s)")
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    train_wall = time.time() - t0
    last_loss = float(metrics["loss/overall_loss"])

    trained = q(scene, GATE_SEED0)
    log(f"trained: {json.dumps(trained)}")
    gate_oracle = oracle(scene, GATE_SEED0)
    log(f"oracle: {json.dumps(gate_oracle)}")

    # cross-distribution evals: (a) mild, the same compact extents with
    # other clutter statistics (5 objects, another seed stream); (b) hard,
    # the default extents (2x table, 2x scatter), where few FPS seeds land
    # on objects
    mild = SceneConfig(num_points=num_points, analytic_labels=True, emit_label_tensors=False, table_extent=0.15,
                       object_scatter=0.12, num_objects=5)
    trained_xdist_mild = _rounded(q(mild, XDIST_MILD_SEED0))
    oracle_xdist_mild = oracle(mild, XDIST_MILD_SEED0)
    log(f"trained_xdist_mild: {json.dumps(trained_xdist_mild)}")
    log(f"oracle_xdist_mild: {json.dumps(oracle_xdist_mild)}")
    trained_xdist = _rounded(q(wide_scene, XDIST_HARD_SEED0))
    oracle_xdist = oracle(wide_scene, XDIST_HARD_SEED0)
    log(f"trained_xdist: {json.dumps(trained_xdist)}")
    log(f"oracle_xdist: {json.dumps(oracle_xdist)}")

    return {
        "config": "quality_gate_synthetic" + ("_mixed_train" if mixed_train else ""),
        "steps": steps,
        "bs": bs,
        "dtype": dtype,
        "train_wall_s": round(train_wall, 1),
        "first_loss": round(first_loss, 3),
        "last_loss": round(last_loss, 3),
        "untrained": untrained,
        "trained": trained,
        "oracle": gate_oracle,
        "trained_xdist_mild": trained_xdist_mild,
        "oracle_xdist_mild": oracle_xdist_mild,
        "trained_xdist": trained_xdist,
        "oracle_xdist": oracle_xdist,
        # the gate: the trained model's surviving grasps must far outscore
        # the untrained model's under the rule that made the labels
        "gate_ratio": round(trained["quality_mean"] / max(untrained["quality_mean"], 1e-6), 2),
        "quality_frac_of_oracle": round(trained["quality_mean"] / max(gate_oracle["quality_mean"], 1e-6), 3),
        "ap_frac_of_oracle": round(trained["ap_analytic"] / max(gate_oracle["ap_analytic"], 1e-6), 3),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--bs", type=int, default=4)
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--num_points", type=int, default=20000)
    p.add_argument("--eval_batches", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--mixed_train", action="store_true", help="alternate compact and default-extent scenes")
    p.add_argument("--device", default="cuda", help="torch device (default the card; 'cpu' runs the plain versions)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    out = run_gate(args.steps, args.bs, args.dtype, eval_batches=args.eval_batches, num_points=args.num_points,
                   lr=args.lr, mixed_train=args.mixed_train, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
