#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100: sm_90a).

    python3 chip_smoke.py

Drives the port's main path (graspbalance_tpu_torch): the full-width
GraspBalance eval forward and pred_decode at bs=4 on 20,000-point synthetic
scenes, with random weights from a seed. Phases, each fatal on failure:

  1. print the card's name and power limit (nvidia-smi);
  2. build the three CUDA kernels from csrc/*.cu and time the build;
  3. with TF32 off, compare each kernel with its plain PyTorch version at
     the main path's shapes: FPS indices exact, query indices exact and
     rotated coordinates within 1e-5, width MLP within 1e-4;
  4. run the forward + decode through the kernels, check that every kernel
     was launched, run it again through the plain versions, and compare the
     valid masks (exact) and the decoded grasps (equal within 1e-4 wherever
     no decode argmax is a near tie); check every output is finite;
  5. time the kernel path (clouds/s, p50 ms/scene) beside each kernel's and
     plain version's time.

Prints the kernel table as one JSON line, and as the last line
{"ok": true, "device": {...}}. Without CUDA it exits non-zero before any
result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

BATCH = 4
NUM_POINTS = 20000
SEED = 0
WIDTHMLP_TOL = 1e-4  # abs; f32 FMA order differs from the plain matmuls
REL_TOL = 1e-5  # abs, metres; both sides round the same ops, any gap is a fault
GRASP_TOL = 1e-4  # abs, on decoded grasps of seeds whose argmaxes agree


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (after one warm-up)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def argmax_margin(x, dim: int):
    """Gap between the largest and second-largest value along dim."""
    top2 = x.topk(2, dim=dim).values
    return top2.select(dim, 0) - top2.select(dim, 1)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke needs a CUDA card",
              file=sys.stderr)
        return 1

    from graspbalance_tpu_torch import _build
    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_point_clouds
    from graspbalance_tpu_torch.models import GraspBalance, pred_decode
    from graspbalance_tpu_torch.ops.fps import furthest_point_sample, furthest_point_sample_plain
    from graspbalance_tpu_torch.ops.gather import group_points
    from graspbalance_tpu_torch.ops.multicyl import multi_cylinder_group, multi_cylinder_group_plain
    from graspbalance_tpu_torch.ops.widthmlp import width_mlp_fused_rot, width_mlp_fused_rot_plain
    from graspbalance_tpu_torch.weights import init_random_

    dev = torch.device("cuda", 0)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s ({_build.library_path()})")

    # 3. each kernel against its plain version, at the main path's shapes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cloud = torch.from_numpy(
        make_point_clouds(SEED, BATCH, SceneConfig(num_points=NUM_POINTS))
    ).to(dev)
    model = init_random_(GraspBalance(), SEED).to(dev).eval()
    wg = model.width_grouping
    m = model.backbone.num_seed

    fps_k = furthest_point_sample(cloud, model.backbone.stages[0][0])
    fps_p = furthest_point_sample_plain(cloud, model.backbone.stages[0][0])
    fps_err = int((fps_k - fps_p).abs().max())
    require(torch.equal(fps_k, fps_p), f"FPS kernel != plain: {int((fps_k != fps_p).sum())} indices differ")

    with torch.no_grad():  # the path's own query inputs: seeds and their top-view rotations
        ep = model.backbone(cloud, sa_inds=fps_k)
        ep.update(model.graspable(ep["fp2_xyz"], ep["fp2_features"]))
    seeds, rot = ep["fp2_xyz"].contiguous(), ep["grasp_top_view_rot"].contiguous()
    qargs = (cloud, seeds, rot, wg.radii, wg.hmin, wg.hmax_list, wg.nsample)
    idx_k, rel_k = multi_cylinder_group(*qargs, emit_rel=True)
    idx_p, rel_p = multi_cylinder_group_plain(*qargs, emit_rel=True)
    require(torch.equal(idx_k, idx_p), f"query kernel != plain: {int((idx_k != idx_p).sum())} indices differ")
    rel_err = float((rel_k - rel_p).abs().max())
    require(rel_err <= REL_TOL, f"query rel error {rel_err} > {REL_TOL}")
    hits = idx_k[..., 1:] != idx_k[..., :1]
    print(f"query: {idx_k.shape} idx exact, rel max err {rel_err:.3g}; "
          f"share of slots past the first that differ from it {float(hits.float().mean()):.3f}")

    b, n_r, n_h, _, k = idx_k.shape
    grouped = group_points(
        cloud, idx_k.permute(0, 3, 1, 2, 4).reshape(b, m * n_r * n_h, k)
    ).reshape(b, m, n_r, n_h, k, 3)
    weights = wg.folded_weights()
    with torch.no_grad():
        mlp_k = width_mlp_fused_rot(grouped, seeds, rot, weights)
        mlp_p = width_mlp_fused_rot_plain(grouped, seeds, rot, weights)
    mlp_err = float((mlp_k - mlp_p).abs().max())
    require(mlp_err <= WIDTHMLP_TOL, f"width MLP error {mlp_err} > {WIDTHMLP_TOL}")
    print(f"width MLP: {tuple(mlp_k.shape)} max err {mlp_err:.3g} (max |out| {float(mlp_p.abs().max()):.3g})")

    with torch.no_grad():
        times = {
            "fps": (cuda_ms(lambda: furthest_point_sample(cloud, 2048), 5),
                    cuda_ms(lambda: furthest_point_sample_plain(cloud, 2048), 1)),
            "multicyl": (cuda_ms(lambda: multi_cylinder_group(*qargs), 5),
                         cuda_ms(lambda: multi_cylinder_group_plain(*qargs), 2)),
            "widthmlp": (cuda_ms(lambda: width_mlp_fused_rot(grouped, seeds, rot, weights), 5),
                         cuda_ms(lambda: width_mlp_fused_rot_plain(grouped, seeds, rot, weights), 2)),
        }
    errs = {"fps": fps_err, "multicyl": rel_err, "widthmlp": mlp_err}

    # 4. the main path through the kernels, then through the plain versions
    torch.cuda.synchronize()
    _build.reset_launches()
    ep = model(cloud)
    grasps, valid = pred_decode(ep)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    require(all(launches[n] > 0 for n in _build.KERNELS), f"a kernel was not launched: {launches}")
    require(grasps.shape == (BATCH, m, 17) and valid.shape == (BATCH, m), "decode shapes")
    for key, v in ep.items():
        if v is not None and v.is_floating_point():
            require(bool(torch.isfinite(v).all()), f"non-finite values in {key}")
    require(bool(torch.isfinite(grasps).all()), "non-finite grasps")

    ep_p = model(cloud, plain=True)
    grasps_p, valid_p = pred_decode(ep_p)
    require(torch.equal(valid, valid_p), "valid masks differ between kernel and plain paths")
    # a decode argmax can only flip where its margin is at most twice the gap
    # between the two paths' inputs to it: every seed whose grasp differs
    # must be such a near tie
    d_ang = float((ep["grasp_angle_cls_pred"] - ep_p["grasp_angle_cls_pred"]).abs().max())
    d_score = float((ep["grasp_score_pred"] - ep_p["grasp_score_pred"]).abs().max())
    firm = (argmax_margin(ep_p["grasp_angle_cls_pred"], 2) > 2 * d_ang).all(dim=-1)
    ang = ep_p["grasp_angle_cls_pred"].argmax(dim=2, keepdim=True)
    score_at = ep_p["grasp_score_pred"].gather(2, ang)[:, :, 0]
    firm &= argmax_margin(score_at, 2) > 2 * d_score
    row_err = (grasps - grasps_p).abs().amax(dim=-1)
    differ = row_err > GRASP_TOL
    require(not bool((differ & firm).any()),
            f"decoded grasps differ by up to {float(row_err[firm].max())} on seeds with firm argmaxes")
    require(float(differ.float().mean()) <= 0.05, f"{int(differ.sum())} decoded grasps differ")
    grasp_err = float(row_err[~differ].max())
    print(f"forward+decode: launches {launches}; {int(valid.sum())} valid seeds; "
          f"kernel vs plain: valid exact, grasps max err {grasp_err:.3g} on "
          f"{int((~differ).sum())}/{differ.numel()} seeds, {int(differ.sum())} near-tie seeds "
          f"decode another angle or depth (head gaps angle {d_ang:.3g}, score {d_score:.3g})")

    # 5. timing of the kernel path
    iters = []
    for _ in range(6):
        t1 = time.perf_counter()
        pred_decode(model(cloud))
        torch.cuda.synchronize()
        iters.append(time.perf_counter() - t1)
    iters = iters[1:]
    p50_ms = statistics.median(iters) / BATCH * 1e3
    clouds_s = BATCH * len(iters) / sum(iters)
    print(f"main path bs={BATCH}, {NUM_POINTS} pts: {clouds_s:.3f} clouds/s, "
          f"p50 {p50_ms:.3f} ms/scene ({smi})")

    sources = {"fps": "fps.cu", "multicyl": "multicyl.cu", "widthmlp": "widthmlp.cu"}
    replaces = {
        "fps": "graspbalance_tpu/ops/pallas/fps_kernel.py:357",
        "multicyl": "graspbalance_tpu/ops/pallas/multicyl_kernel.py:212",
        "widthmlp": "graspbalance_tpu/ops/pallas/widthmlp_kernel.py:197",
    }
    table = [
        {
            "name": name,
            "route": "cuda",
            "source": f"graspbalance_tpu_torch/csrc/{sources[name]}",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
        }
        for name in _build.KERNELS
    ]
    print(json.dumps({"kernels": table}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
