"""Inference CLI (port of graspbalance_tpu/cli/infer.py, with its flags and
``--device``): scenes -> decoded grasp arrays.

    python -m graspbalance_tpu_torch.cli.infer --checkpoint_dir logs/run/checkpoints

Without ``--dataset_root`` it runs a synthetic smoke batch; with it, it runs
over a GraspNet-1B split and writes per-frame (G, 17) npy files in the
layout graspnetAPI's GraspNetEval reads
(dump_dir/scene_xxxx/<camera>/xxxx.npy). ``--checkpoint_dir`` restores the
model a training run saved (its config.json and a checkpoint of this
package); without it the model has flax's initialisation from seed 0.
``--obs`` is parsed and unused, as in the JAX CLI. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint_dir", default="", help="checkpoint dir of a training run")
    p.add_argument("--best", action="store_true", help="restore the best-loss checkpoint instead of latest")
    p.add_argument("--dataset_root", default="")
    p.add_argument("--camera", default="realsense")
    p.add_argument("--split", default="test_seen")
    p.add_argument("--dump_dir", default="logs/dump")
    p.add_argument("--num_point", type=int, default=20000)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--obs", action="store_true", help="object-balanced sampling (needs DSN ckpt)")
    p.add_argument("--collision_thresh", type=float, default=0.05)
    p.add_argument("--max_scenes", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default the card; 'cpu' runs the plain versions)")
    return p.parse_args(argv)


def build_inference(cfg, checkpoint_dir: str, best: bool, collision_thresh: float, device):
    """A GraspInference of ``cfg``'s model (replaced by the training run's
    config.json in ``checkpoint_dir``, its data section kept) with the
    checkpoint's weights, or flax's initialisation from seed 0 without a
    checkpoint dir."""
    import dataclasses

    import torch

    from graspbalance_tpu_torch.eval.pipeline import GraspInference
    from graspbalance_tpu_torch.nn.layers import init_flax_defaults_
    from graspbalance_tpu_torch.train.checkpoints import load_config, load_inference_variables
    from graspbalance_tpu_torch.train.train_step import build_model

    if checkpoint_dir:
        # the architecture is not stored in the weights: rebuild the model
        # from the config the trainer saved beside the checkpoints
        saved = load_config(checkpoint_dir)
        if saved is not None:
            cfg = dataclasses.replace(saved, data=cfg.data)
    model = build_model(cfg, device=device)
    if checkpoint_dir:
        state, step = load_inference_variables(checkpoint_dir, best=best)
        model.load_state_dict(state)
        print(f"restored checkpoint step {step}")
    else:
        init_flax_defaults_(model, torch.Generator().manual_seed(0))
    return GraspInference(model, collision_thresh=collision_thresh, device=device)


def main(argv=None):
    """Parse ``argv`` (default the command line) and run; returns the
    synthetic batch's (grasps, keep), or the number of frames dumped."""
    args = parse_args(argv)
    from graspbalance_tpu_torch.train.config import Config, DataConfig

    cfg = Config(data=DataConfig(num_points=args.num_point))
    infer = build_inference(cfg, args.checkpoint_dir, args.best, args.collision_thresh, args.device)

    if not args.dataset_root:
        from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_point_clouds

        # make_batch(0, ...)'s clouds, without its label tensors
        grasps, keep = infer(make_point_clouds(0, args.batch_size, SceneConfig(num_points=args.num_point)))
        print(f"synthetic smoke: {keep.sum()} grasps kept of {keep.size}")
        return grasps, keep

    from graspbalance_tpu_torch.data.dataset import GraspNetDataset
    from graspbalance_tpu_torch.eval.pipeline import dump_dataset

    ds = GraspNetDataset(args.dataset_root, [], {}, camera=args.camera, split=args.split, num_points=args.num_point,
                         load_label=False)
    n = dump_dataset(infer, ds, args.dump_dir, args.camera, batch_size=args.batch_size,
                     max_frames=args.max_scenes * 256 if args.max_scenes else 0)
    print(
        "done. evaluate with graspnetAPI:\n"
        "  from graspnetAPI import GraspNetEval\n"
        f"  ge = GraspNetEval(root='{args.dataset_root}', camera='{args.camera}', split='{args.split}')\n"
        f"  ge.eval_seen('{args.dump_dir}', proc=24)"
    )
    return n


if __name__ == "__main__":
    main()
