"""Where the quality gate's trained model loses its grasps: the gate's
recipe (cli/quality_gate.py: full model, bs=4, lr 1e-3 OneCycle, epoch 0's
BatchNorm momentum), then the held-out gate scenes scored twice, with the
BatchNorm layers on their running statistics (eval mode, as the gate
scores) and on each batch's own statistics (train mode at momentum 0, so
nothing is updated).

    python tests/gate_bn_modes.py --steps 800 --dtype bfloat16

Prints, per mode, the seeds decoded as graspable, the objectness logit
margin (class 1 minus class 0: median and largest), the kept grasps and
the analytic metrics, one JSON line each. Runs on the card unless
``--device cpu``.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--bs", type=int, default=4)
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--eval_batches", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    import dataclasses

    import numpy as np
    import torch

    from graspbalance_tpu_torch.cli.quality_gate import GATE_SEED0, gate_scene
    from graspbalance_tpu_torch.data.synthetic import make_batch
    from graspbalance_tpu_torch.eval.pipeline import make_postprocess
    from graspbalance_tpu_torch.eval.quality import _Scores
    from graspbalance_tpu_torch.models.decode import pred_decode
    from graspbalance_tpu_torch.train.config import Config, DataConfig, ModelConfig, TrainConfig
    from graspbalance_tpu_torch.train.loop import Prefetch
    from graspbalance_tpu_torch.train.train_step import build_model, create_train_state, set_bn_momentum, train_step

    scene = gate_scene()
    cfg = Config(model=ModelConfig(dtype=args.dtype), data=DataConfig(analytic_labels=True, batch_size=args.bs),
                 train=TrainConfig(max_epoch=1))
    state = create_train_state(cfg, args.steps, make_batch(0, args.bs, scene), device=args.device)
    batches = (make_batch(1 + i, args.bs, scene) for i in range(args.steps))
    for b in Prefetch(batches, depth=3):
        metrics = train_step(state.model, state.optimizer, state.scheduler, b, 0, cfg)
    print(json.dumps({"last_step": {k: float(v) for k, v in metrics.items()}}))

    model = build_model(dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype="float32")),
                        device=args.device)
    model.load_state_dict(state.model.state_dict())
    postprocess = make_postprocess(0.05)
    for mode in ("running statistics", "batch statistics"):
        model.train(mode == "batch statistics")
        set_bn_momentum(model, 0.0)
        scores, positive, seeds, margins = _Scores(), 0, 0, []
        with torch.no_grad():
            for i in range(args.eval_batches):
                batch = make_batch(GATE_SEED0 + i, args.bs, scene)
                cloud = torch.from_numpy(batch["point_clouds"]).to(args.device)
                ep = model(cloud)
                grasps, valid = pred_decode(ep)
                keep = postprocess(grasps, valid, cloud)
                o = ep["objectness_score"]
                margins.append((o[..., 1] - o[..., 0]).flatten().float().cpu())
                positive += int(valid.sum())
                seeds += valid.numel()
                scores.add(grasps.cpu().numpy(), keep.cpu().numpy(), batch, scene.num_depths)
        m = torch.cat(margins)
        print(json.dumps({"bn": mode, "graspable_seeds": positive, "seeds": seeds,
                          "margin_median": float(m.median()), "margin_max": float(m.max()), **scores.result()}))


if __name__ == "__main__":
    main()
