#!/usr/bin/env python3
"""Times the PyTorch port's main path, the GraspBalance eval forward +
pred_decode (bs=4, 20,000-point synthetic scenes from seed 0, random weights
from seed 0), for one or more checkouts of the repo on one CUDA card, in
alternating order, so that two versions are compared within one run:

    python3 time_main_path.py TREE_A TREE_B [--rounds 2] [--iters 30]

runs A, B, B, A (two rounds; odd rounds go in reverse order), each run in a
process of its own that imports graspbalance_tpu_torch from its tree and
builds that tree's kernels. Prints one JSON line per run (clouds/s, p50, min
and max ms per scene over the timed calls), one summary line per tree (the
runs' clouds/s and p50s, the median and the interquartile distance of the
run p50s, and the median's ratio to the first tree's), and, for two trees,
the rounds in which the second tree's p50 is lower than the first's.

With ``--collision`` each run times the collision counts instead, on the
decoded grasps of those scenes and the voxel-downsampled clouds (the
collision filter's inputs): ms per ``collision_counts`` call by CUDA events,
whether the counts equal ``collision_counts_plain``'s, and the device ms per
call of each kernel by torch.profiler.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

BATCH = 4
NUM_POINTS = 20000
SEED = 0
WARMUP = 3


def worker(tree: str, iters: int, collision: bool) -> None:
    """One run: time `iters` forward + decode calls of the tree's port, or
    `iters` collision_counts calls on their grasps."""
    sys.path.insert(0, tree)
    import torch

    import graspbalance_tpu_torch
    from graspbalance_tpu_torch import _build
    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_point_clouds
    from graspbalance_tpu_torch.models import GraspBalance, pred_decode
    from graspbalance_tpu_torch.weights import init_random_

    pkg = os.path.dirname(os.path.abspath(graspbalance_tpu_torch.__file__))
    if os.path.dirname(pkg) != tree:
        raise RuntimeError(f"imported the port from {pkg}, not from {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card")
    dev = torch.device("cuda", 0)
    _build.library()
    cloud = torch.from_numpy(make_point_clouds(SEED, BATCH, SceneConfig(num_points=NUM_POINTS))).to(dev)
    model = init_random_(GraspBalance(), SEED).to(dev).eval()
    if collision:
        collision_worker(tree, iters, cloud, model)
        return
    times = []
    for i in range(WARMUP + iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred_decode(model(cloud))
        torch.cuda.synchronize()
        if i >= WARMUP:
            times.append((time.perf_counter() - t) / BATCH * 1e3)
    print(json.dumps({"tree": tree, "ms": times}))


def collision_worker(tree: str, iters: int, cloud, model) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from graspbalance_tpu_torch.eval.collision import voxel_downsample_fixed
    from graspbalance_tpu_torch.models import pred_decode
    from graspbalance_tpu_torch.ops.collision import collision_counts, collision_counts_plain, pack_grasp_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        grasps, _ = pred_decode(model(cloud))
    points, valid = voxel_downsample_fixed(cloud)
    params = pack_grasp_params(grasps, 0.03, 0.01, 0.06)
    equal = torch.equal(collision_counts(points, valid, params), collision_counts_plain(points, valid, params))
    times = []
    for i in range(WARMUP + iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        collision_counts(points, valid, params)
        end.record()
        torch.cuda.synchronize()
        if i >= WARMUP:
            times.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            collision_counts(points, valid, params)
        torch.cuda.synchronize()
    device_ms = {e.key[:60]: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation}
    print(json.dumps({"tree": tree, "ms": times, "equal": equal, "device_ms": device_ms}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--collision", action="store_true", help="time the collision counts")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    trees = [os.path.abspath(t) for t in args.trees]
    if args.worker:
        worker(trees[0], args.iters, args.collision)
        return 0

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    runs = {t: [] for t in trees}
    for r in range(args.rounds):
        for tree in trees if r % 2 == 0 else trees[::-1]:
            out = json.loads(subprocess.run(
                [sys.executable, os.path.abspath(__file__), tree, "--iters", str(args.iters), "--worker"]
                + ["--collision"] * args.collision,
                capture_output=True, text=True, check=True, timeout=900,
            ).stdout.strip().splitlines()[-1])
            ms = out.pop("ms")
            runs[tree].append(ms)
            rate = {} if args.collision else {"clouds_s": 1e3 * len(ms) / sum(ms)}
            print(json.dumps({
                "tree": tree, "round": r, **rate,
                "p50_ms": statistics.median(ms), "min_ms": min(ms), "max_ms": max(ms),
                **{k: v for k, v in out.items() if k != "tree"},
            }))
    p50s = {t: [statistics.median(ms) for ms in per_run] for t, per_run in runs.items()}
    base = statistics.median(p50s[trees[0]])
    for tree in trees:
        q = statistics.quantiles(p50s[tree], n=4) if len(p50s[tree]) > 1 else [p50s[tree][0]] * 3
        rate = {} if args.collision else {"clouds_s": [1e3 * len(ms) / sum(ms) for ms in runs[tree]]}
        print(json.dumps({
            "tree": tree, **rate,
            "p50_ms": p50s[tree], "median_p50_ms": statistics.median(p50s[tree]),
            "iqr_p50_ms": q[2] - q[0], "median_vs_first": statistics.median(p50s[tree]) / base,
            "device": smi,
        }))
    if len(trees) == 2:
        a, b = p50s[trees[0]], p50s[trees[1]]
        print(json.dumps({"second_faster_rounds": sum(y < x for x, y in zip(a, b)), "rounds": len(a)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
