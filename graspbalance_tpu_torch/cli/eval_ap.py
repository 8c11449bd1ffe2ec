"""One-command GraspNet-1B AP evaluation (port of
graspbalance_tpu/cli/eval_ap.py, with its flags and ``--device``):

    python -m graspbalance_tpu_torch.cli.eval_ap --dataset_root /data/graspnet --checkpoint_dir logs/run/checkpoints

checkpoint -> scene loop -> GraspGroup-layout dumps -> graspnetAPI's
GraspNetEval, where that package imports; without it the dump is left for
an offline evaluation and the command says how to run it. The weights come
from a checkpoint of this package (``--checkpoint_dir``) or from the flax
variable pickle ``{'params', 'batch_stats'}`` that tools/port_torch_ckpt.py
writes from a reference checkpoint (``--ported_pkl``, loaded through
``weights.load_flax_variables``). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_mutually_exclusive_group()
    src.add_argument("--checkpoint_dir", default="", help="checkpoint dir of a training run of this package")
    src.add_argument("--ported_pkl", default="",
                     help="{'params','batch_stats'} pickle from tools/port_torch_ckpt.py")
    p.add_argument("--best", action="store_true", help="best-loss checkpoint instead of latest")
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--camera", default="realsense", choices=["realsense", "kinect"])
    p.add_argument("--split", default="test_seen",
                   choices=["test_seen", "test_similar", "test_novel", "test", "all"])
    p.add_argument("--dump_dir", default="logs/dump_ap")
    p.add_argument("--num_point", type=int, default=20000)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--collision_thresh", type=float, default=0.05)
    p.add_argument("--max_frames", type=int, default=0, help="cap frames (0 = all)")
    p.add_argument("--proc", type=int, default=24, help="graspnetAPI eval workers")
    p.add_argument("--skip_dump", action="store_true",
                   help="evaluate an existing --dump_dir without re-running inference")
    p.add_argument("--device", default="cuda", help="torch device (default the card; 'cpu' runs the plain versions)")
    return p.parse_args(argv)


def build_inference(args):
    """The GraspInference of ``--ported_pkl``'s or ``--checkpoint_dir``'s
    weights."""
    from graspbalance_tpu_torch.cli.infer import build_inference as from_checkpoint
    from graspbalance_tpu_torch.eval.pipeline import GraspInference
    from graspbalance_tpu_torch.train.config import Config, DataConfig
    from graspbalance_tpu_torch.train.train_step import build_model
    from graspbalance_tpu_torch.weights import load_flax_variables

    cfg = Config(data=DataConfig(num_points=args.num_point))
    if args.ported_pkl:
        with open(args.ported_pkl, "rb") as f:
            variables = pickle.load(f)
        model = load_flax_variables(build_model(cfg, device="cpu"), variables)
        return GraspInference(model, collision_thresh=args.collision_thresh, device=args.device)
    if args.checkpoint_dir:
        return from_checkpoint(cfg, args.checkpoint_dir, args.best, args.collision_thresh, args.device)
    raise SystemExit("need --checkpoint_dir or --ported_pkl (or --skip_dump)")


def evaluate_dump(args):
    """The graspnetAPI stage; returns the AP dict, or None where graspnetAPI
    does not import."""
    try:
        from graspnetAPI import GraspNetEval
    except ImportError:
        print(
            "graspnetAPI not installed — dump is ready for offline eval:\n"
            "  from graspnetAPI import GraspNetEval\n"
            f"  ge = GraspNetEval(root='{args.dataset_root}', camera='{args.camera}', split='{args.split}')\n"
            f"  ge.{_EVAL_METHOD.get(args.split, 'eval_all')}('{args.dump_dir}', proc={args.proc})"
        )
        return None
    ge = GraspNetEval(root=args.dataset_root, camera=args.camera, split=args.split)
    method = getattr(ge, _EVAL_METHOD.get(args.split, "eval_all"))
    res, ap = method(args.dump_dir, proc=args.proc)
    out = {"split": args.split, "camera": args.camera, "AP": float(ap)}
    with open(os.path.join(args.dump_dir, "ap_result.json"), "w") as f:
        json.dump(out, f)
    import numpy as np

    np.save(os.path.join(args.dump_dir, "ap_accuracy.npy"), res)
    print(json.dumps(out))
    return out


_EVAL_METHOD = {
    "test_seen": "eval_seen",
    "test_similar": "eval_similar",
    "test_novel": "eval_novel",
    "test": "eval_all",
    "all": "eval_all",
}


def main(argv=None):
    """Parse ``argv`` (default the command line), dump unless
    ``--skip_dump``, and evaluate; returns the AP dict or None."""
    args = parse_args(argv)
    if not args.skip_dump:
        from graspbalance_tpu_torch.data.dataset import GraspNetDataset
        from graspbalance_tpu_torch.eval.pipeline import dump_dataset

        infer = build_inference(args)
        ds = GraspNetDataset(args.dataset_root, [], {}, camera=args.camera, split=args.split,
                             num_points=args.num_point, load_label=False)
        n = dump_dataset(infer, ds, args.dump_dir, args.camera, batch_size=args.batch_size,
                         max_frames=args.max_frames)
        print(f"dumped {n} frames to {args.dump_dir}")
    return evaluate_dump(args)


if __name__ == "__main__":
    main()
