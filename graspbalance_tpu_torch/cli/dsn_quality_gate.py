"""Closed-loop quality gate of the DSN (port of tools/dsn_quality_gate.py):

    python -m graspbalance_tpu_torch.cli.dsn_quality_gate --steps 500

Trains the DSN (point-transformer backbone + foreground / center-offset
heads) on synthetic scenes, then runs the inference side of OBS (forward ->
foreground argmax -> mean-shift clustering) on held-out scenes and scores it
against the generator's true instance labels (eval/seg_quality.py). The
oracle sends the true foreground and offsets through the same mean shift.
Prints one JSON line with the JAX tool's keys. Mean shift draws its Gumbel
noise from a ``torch.Generator`` seeded 7 + i for eval batch i (the JAX tool
from PRNGKey(7 + i)). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

EVAL_SEED0 = 2_000_000  # the held-out scenes
XDIST_SEED0 = 3_000_000  # the cross-distribution scenes
NOISE_SEED0 = 7  # mean shift's generator seed of eval batch 0


def run_dsn_gate(steps=500, bs=4, num_points=20000, lr=1e-3, eval_batches=4, max_objects=12, num_objects=8,
                 pt_stages=None, log=print, *, device="cuda", initial_state: dict | None = None) -> dict:
    """Train a DSN for ``steps`` steps on analytic synthetic scenes, then
    score the inference path on held-out scenes against the true instance
    labels; returns the gate's JSON record. ``pt_stages=None`` is the DSN's
    default (20k-point) stage table. The DSN starts from flax's
    initialisation from seed 0, or from ``initial_state`` (a state_dict)."""
    import numpy as np
    import torch

    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
    from graspbalance_tpu_torch.eval.pipeline import resolve_device
    from graspbalance_tpu_torch.eval.seg_quality import seg_quality
    from graspbalance_tpu_torch.models.dsn import DSN, cluster, compute_center_offset_labels
    from graspbalance_tpu_torch.train.loop import Prefetch
    from graspbalance_tpu_torch.train.seg_step import init_dsn, make_seg_optimizer, seg_train_step

    device = resolve_device(device)
    # compact clutter, as the grasp gate's; analytic_labels with
    # emit_label_tensors=False: the host makes only the geometry the DSN reads
    scene = SceneConfig(
        num_points=num_points, table_extent=0.15, object_scatter=0.12, num_objects=num_objects,
        max_objects=max_objects, analytic_labels=True, emit_label_tensors=False,
    )
    model = (DSN() if pt_stages is None else DSN(pt_stages=pt_stages)).to(device)
    if initial_state is None:
        init_dsn(model, 0)
    else:
        model.load_state_dict(initial_state)
    optimizer, scheduler = make_seg_optimizer(model, steps, lr)

    def tensors(batch):
        cloud = torch.from_numpy(batch["point_clouds"][..., :3]).to(device)
        return cloud, torch.from_numpy(batch["instance_label"].astype(np.int32)).to(device)

    @torch.no_grad()
    def evaluate(oracle=False, eval_scene=None, seed0=EVAL_SEED0):
        eval_scene = eval_scene or scene
        model.eval()
        agg = {"fg_iou": 0.0, "purity": 0.0, "cluster_count_err": 0.0}
        for i in range(eval_batches):
            eb = make_batch(seed0 + i, bs, eval_scene)
            cloud, inst = tensors(eb)
            gen = torch.Generator(device=device).manual_seed(NOISE_SEED0 + i)
            if oracle:
                # the true foreground and offsets through the same mean shift:
                # what a perfect DSN scores with this clustering on these scenes
                true_off = compute_center_offset_labels(cloud, inst, max_objects)
                labels, _, _ = cluster(cloud, true_off, inst > 0, generator=gen)
                fg_true = eb["instance_label"] > 0
                fgl = np.stack([~fg_true, fg_true], axis=-1).astype(np.float32)
            else:
                out = model(cloud)
                fg = torch.argmax(out["foreground_logits"], dim=-1) == 1
                labels, _, _ = cluster(cloud, out["center_offsets"], fg, generator=gen)
                fgl = out["foreground_logits"].cpu().numpy()
            m = seg_quality(fgl, labels.cpu().numpy(), eb["instance_label"])
            for k in agg:
                agg[k] += m[k] / eval_batches
        return {k: round(v, 4) for k, v in agg.items()}

    oracle = evaluate(oracle=True)
    log(f"oracle: {json.dumps(oracle)}")
    untrained = evaluate()
    log(f"untrained: {json.dumps(untrained)}")

    def batches():
        for i in range(steps):
            yield make_batch(1 + i, bs, scene)

    t0 = time.time()
    for i, b in enumerate(Prefetch(batches(), depth=3)):
        metrics = seg_train_step(model, optimizer, scheduler, *tensors(b), max_objects)
        if (i + 1) % 100 == 0:
            log(f"step {i + 1} loss {float(metrics['loss/seg_loss']):.3f} ({time.time() - t0:.0f}s)")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_wall = time.time() - t0

    trained = evaluate()
    log(f"trained: {json.dumps(trained)}")

    # mild cross-distribution: the same extents, fewer objects: did the DSN
    # learn objects, or these scenes?
    xdist_scene = dataclasses.replace(scene, num_objects=max(num_objects - 3, 2))
    trained_xdist = evaluate(eval_scene=xdist_scene, seed0=XDIST_SEED0)
    oracle_xdist = evaluate(oracle=True, eval_scene=xdist_scene, seed0=XDIST_SEED0)
    log(f"trained_xdist: {json.dumps(trained_xdist)}")
    log(f"oracle_xdist: {json.dumps(oracle_xdist)}")
    return {
        "config": "dsn_quality_gate_synthetic",
        "steps": steps,
        "bs": bs,
        "train_wall_s": round(train_wall, 1),
        "untrained": untrained,
        "trained": trained,
        "oracle": oracle,
        "trained_xdist": trained_xdist,
        "oracle_xdist": oracle_xdist,
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--bs", type=int, default=4)
    p.add_argument("--num_points", type=int, default=20000)
    p.add_argument("--eval_batches", type=int, default=4)
    p.add_argument("--device", default="cuda", help="torch device (default the card; 'cpu' runs the plain versions)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    print(json.dumps(run_dsn_gate(steps=args.steps, bs=args.bs, num_points=args.num_points,
                                  eval_batches=args.eval_batches, device=args.device)), flush=True)


if __name__ == "__main__":
    main()
