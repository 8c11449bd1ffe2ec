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

With ``--kernel NAME`` each run times one kernel's wrapper instead, on the
inputs its path gives it: ``fps``, the backbone's FPS of those scenes
(20,000 -> 2,048 points); ``collision``, the collision counts of the
decoded grasps of those scenes on the voxel-downsampled clouds (the
collision filter's inputs); ``fps_masked``, OBS's masked FPS on the
compacted rows of the scenes' own objects at the path's max_needed;
``select``, the class-plane selection on the forward's seeds and top-view
rotations (the width head's 4 x 4 combos at K = 64). It prints ms per call
by CUDA events, whether the result equals the plain version's (the masked
FPS over its first max_needed slots), and the device ms per call of each
kernel by torch.profiler.
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


def worker(tree: str, iters: int, kernel: str | None) -> None:
    """One run: time `iters` forward + decode calls of the tree's port, or
    `iters` calls of one kernel's wrapper on its path's inputs."""
    sys.path.insert(0, tree)
    import torch

    import graspbalance_tpu_torch
    from graspbalance_tpu_torch import _build
    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_scenes
    from graspbalance_tpu_torch.models import GraspBalance, pred_decode
    from graspbalance_tpu_torch.weights import init_random_

    pkg = os.path.dirname(os.path.abspath(graspbalance_tpu_torch.__file__))
    if os.path.dirname(pkg) != tree:
        raise RuntimeError(f"imported the port from {pkg}, not from {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card")
    dev = torch.device("cuda", 0)
    _build.library()
    clouds, instance = make_scenes(SEED, BATCH, SceneConfig(num_points=NUM_POINTS))
    cloud = torch.from_numpy(clouds).to(dev)
    model = init_random_(GraspBalance(), SEED).to(dev).eval()
    if kernel:
        kernel_worker(tree, iters, kernel, cloud, torch.from_numpy(instance).to(dev), model)
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


def kernel_inputs(kernel: str, cloud, instance, model):
    """(call, plain call, what to compare) of one kernel's wrapper on the
    inputs its path gives it."""
    import functools

    import torch

    from graspbalance_tpu_torch.models import pred_decode

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        ep = model(cloud)
    if kernel == "fps":
        from graspbalance_tpu_torch.ops.fps import furthest_point_sample, furthest_point_sample_plain

        args = (cloud, model.backbone.stages[0][0])
        return functools.partial(furthest_point_sample, *args), functools.partial(furthest_point_sample_plain,
                                                                                  *args), None
    if kernel == "collision":
        from graspbalance_tpu_torch.eval.collision import voxel_downsample_fixed
        from graspbalance_tpu_torch.ops.collision import collision_counts, collision_counts_plain, pack_grasp_params

        points, valid = voxel_downsample_fixed(cloud)
        args = (points, valid, pack_grasp_params(pred_decode(ep)[0], 0.03, 0.01, 0.06))
        return functools.partial(collision_counts, *args), functools.partial(collision_counts_plain, *args), None
    if kernel == "fps_masked":
        from graspbalance_tpu_torch.eval.obs import (
            COMPACT_CAP,
            FPS_CAP,
            _compact_mask,
            max_needed_steps,
            object_masks,
        )
        from graspbalance_tpu_torch.ops.fps import furthest_point_sample_masked, furthest_point_sample_masked_plain

        masks = object_masks(instance)
        cxyz, _, cvalid = _compact_mask(cloud, masks, COMPACT_CAP)
        cxyz = cxyz.reshape(-1, COMPACT_CAP, 3).contiguous()
        cvalid = cvalid.reshape(-1, COMPACT_CAP).contiguous()
        needed = max_needed_steps(masks.any(dim=2), model.backbone.num_seed)
        return (functools.partial(furthest_point_sample_masked, cxyz, cvalid, FPS_CAP, max_needed=needed),
                functools.partial(furthest_point_sample_masked_plain, cxyz, cvalid, FPS_CAP), int(needed))
    if kernel == "select":
        from graspbalance_tpu_torch.ops.query import class_plane
        from graspbalance_tpu_torch.ops.select import multicyl_select, multicyl_select_plain

        wg = model.width_grouping
        seeds, rot = ep["fp2_xyz"].contiguous(), ep["grasp_top_view_rot"].contiguous()
        cls = class_plane(cloud, seeds, rot, wg.radii, wg.hmin, wg.hmax_list).reshape(-1, cloud.shape[1])
        args = (cls, len(wg.radii), len(wg.hmax_list), wg.nsample)
        return functools.partial(multicyl_select, *args), functools.partial(multicyl_select_plain, *args), None
    raise ValueError(f"no kernel {kernel!r}")


def kernel_worker(tree: str, iters: int, kernel: str, cloud, instance, model) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run, run_plain, upto = kernel_inputs(kernel, cloud, instance, model)
    got, want = run(), run_plain()
    equal = torch.equal(got, want) if upto is None else torch.equal(got[:, :upto], want[:, :upto])
    times = []
    for i in range(WARMUP + iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        if i >= WARMUP:
            times.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    device_ms = {e.key[:60]: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation}
    print(json.dumps({"tree": tree, "ms": times, "equal": equal, "device_ms": device_ms}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--kernel", choices=("fps", "collision", "fps_masked", "select"),
                    help="time one kernel's wrapper on its path's inputs")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    trees = [os.path.abspath(t) for t in args.trees]
    if args.worker:
        worker(trees[0], args.iters, args.kernel)
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
                + (["--kernel", args.kernel] if args.kernel else []),
                capture_output=True, text=True, check=True, timeout=900,
            ).stdout.strip().splitlines()[-1])
            ms = out.pop("ms")
            runs[tree].append(ms)
            rate = {} if args.kernel else {"clouds_s": 1e3 * len(ms) / sum(ms)}
            print(json.dumps({
                "tree": tree, "round": r, **rate,
                "p50_ms": statistics.median(ms), "min_ms": min(ms), "max_ms": max(ms),
                **{k: v for k, v in out.items() if k != "tree"},
            }))
    p50s = {t: [statistics.median(ms) for ms in per_run] for t, per_run in runs.items()}
    base = statistics.median(p50s[trees[0]])
    for tree in trees:
        q = statistics.quantiles(p50s[tree], n=4) if len(p50s[tree]) > 1 else [p50s[tree][0]] * 3
        rate = {} if args.kernel else {"clouds_s": [1e3 * len(ms) / sum(ms) for ms in runs[tree]]}
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
