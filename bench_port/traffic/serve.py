"""The serving generator: one client calling ``GraspInference`` in a closed
loop, each call on the next ``batch`` scenes of a pool made in set-up, numpy
clouds in and numpy grasps and keep masks out.

Its mix file sets ``use_obs`` (the DSN, mean shift and object-balanced
re-seeding), ``batch``, ``pool`` scenes of ``num_points`` points with
``objects`` [lo, hi] boxes each (``scenes.py``), ``warmup`` calls and
``checked_calls``, the number of calls of the window whose answers the
reference checks (drawn from the seed). The mean-shift noise of every pool
batch is drawn from the seed in set-up and passed to the call, so that the
program and the reference draw the same.

The backbone's sampling contract (``reference/backbones/``) says which
indices it takes from the raw cloud. With OBS the DSN and the backbone share
one FPS of the cloud, the backbone taking its ``fps_prefix``: a backbone
whose contract is not such a prefix is refused on an OBS cell.

The check (``check``) follows the program stage by stage, each stage's
reference computed from what the program handed it, and each stage judged
by itself:

  fps_mismatch     the indices the backbone's contract takes from the cloud
                   (with OBS the shared FPS) against the reference's
  dsn_err          the DSN's foreground logits and center offsets against the
                   reference DSN's, max |a - b| / max |b| (OBS only)
  label_mismatch   instance labels against the reference's mean shift over the
                   program's DSN outputs and the same noise (OBS only)
  seed_mismatch    seeds whose index (with OBS the re-drawn seeds, against the
                   reference's OBS over the program's labels), position or
                   top view's approach vector is not the reference's: exact,
                   since each is a gather
  head_err         every head output against the reference model's on the
                   program's sampled indices, labels and top views, max |a - b| / max |b|,
                   and how far the program's top view of each seed lies below the
                   reference's best view score, over the largest score
  decode_mismatch  decoded grasp rows not equal to the reference's decode of the
                   program's head outputs
  keep_mismatch    keep-mask entries not equal to the reference's NMS and
                   collision filter on the program's grasps
"""

from __future__ import annotations

import itertools
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from bench_port import harness, host, scenes, tracing, weights
from bench_port.counts import model as model_counts
from bench_port.reference import dsn as ref_dsn_mod
from bench_port.reference import models as ref_models
from bench_port.reference import ops as ref_ops
from bench_port.reference import postprocess as ref_post
from bench_port.reference.layers import tf32_products

EP_KEYS = ("fp2_inds", "fp2_xyz", "objectness_score", "view_score", "grasp_top_view_inds", "grasp_top_view_xyz",
           "grasp_score_pred", "grasp_angle_cls_pred", "grasp_width_pred", "grasp_tolerance_pred")
HEAD_KEYS = ("objectness_score", "view_score", "grasp_score_pred", "grasp_angle_cls_pred", "grasp_width_pred",
             "grasp_tolerance_pred")
MEANSHIFT_SEEDS = 50
MEANSHIFT_SUBSAMPLE = 5


def reference_modules(cell, use_obs: bool, device):
    """The reference model (and DSN) of the cell's configuration, on
    ``device``. With ``use_obs``, refused where the backbone's sampling
    contract is not a prefix of one FPS of the raw cloud, which the DSN
    would share."""
    config = cell.config
    with torch.device(device):
        model = ref_models.GraspBalance(**config["model"], bench=cell.bench).eval()
        dsn = ref_dsn_mod.DSN(config["dsn"]["pt_stages"]).eval() if use_obs else None
    if use_obs and model.backbone.fps_prefix is None:
        raise ValueError(f"backbone {model.backbone_name!r} takes {', '.join(model.backbone.SAMPLED) or 'nothing'} "
                         "from the raw cloud, not a prefix of one FPS of it: an OBS cell shares one FPS between "
                         "the DSN and the backbone")
    return model, dsn


def ep_keys(cell) -> tuple:
    """The end points the check reads: the indices the backbone's contract
    samples, and the seeds' and the heads'."""
    backbone = ref_models.backbone_file(cell.config["model"]["backbone"], cell.bench).Backbone
    return tuple(backbone.SAMPLED) + EP_KEYS


def reference_sample(model, dsn, cloud):
    """The reference's sampling of the raw cloud: {key: indices} of the
    backbone's contract, and with a DSN the one FPS both networks share
    (else None), the DSN taking its first stage's npoint and the backbone
    its ``fps_prefix``, as the program's OBS path samples."""
    bb = model.backbone
    if dsn is None:
        return bb.sample(cloud), None
    shared = ref_ops.furthest_point_sample(cloud, max(bb.fps_prefix, dsn.pt_stages[0][0]))
    return {bb.SAMPLED[0]: shared[:, : bb.fps_prefix]}, shared


def make_inputs(cell, seed: int, device):
    """The seed's weights (one state dict per network, on the device), the
    scene pool as (n_batches, batch, N, 3) numpy clouds, and each batch's
    mean-shift noise."""
    tr = cell.traffic
    model_m, dsn_m = reference_modules(cell, tr["use_obs"], "meta")
    state = weights.random_state(weights.shapes_of(model_m), seed, device, salt=1)
    dsn_state = weights.random_state(weights.shapes_of(dsn_m), seed, device, salt=2) if dsn_m is not None else None
    clouds, counts = scenes.cloud_pool(seed, tr["pool"], tr["num_points"], tuple(tr["objects"]))
    nb = tr["pool"] // tr["batch"]
    clouds = clouds[: nb * tr["batch"]].reshape(nb, tr["batch"], tr["num_points"], 3)
    m = len(range(0, tr["num_points"], MEANSHIFT_SUBSAMPLE))
    u = torch.rand((nb, tr["batch"], 1 + MEANSHIFT_SEEDS, m), generator=weights.generator(seed, device, 3),
                   device=device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    inputs = SimpleNamespace(state=state, dsn_state=dsn_state, clouds=clouds, counts=counts, gumbel=gumbel)
    calibrate(cell, inputs, device)
    return inputs


@torch.no_grad()
def calibrate(cell, inputs, device) -> None:
    """Shift two biases of the random weights so that they decide as a
    trained model would on the pool's first scene: the DSN's foreground
    logit (``fg2.bias``) positive on ``foreground_share`` of its points and
    the objectness logit (``graspable.conv3.bias``) on ``objectness_share``
    of its seeds (those the cell's pipeline takes: the FPS seeds, or with
    OBS the re-drawn ones), the configuration's ``calibrate``. Random
    weights otherwise put one sign on nearly every point, so that OBS would
    find no object or one, and NMS and the collision filter would see no
    valid grasp or all. The reference computes the logits, on one scene."""
    cal = cell.config["calibrate"]
    use_obs = inputs.dsn_state is not None
    model, dsn = reference_modules(cell, use_obs, device)
    model.load_state_dict(inputs.state)
    xyz = torch.from_numpy(inputs.clouds[0, :1]).to(device)
    sampled, shared = reference_sample(model, dsn, xyz)
    ep = model.backbone(xyz, sampled)
    feats = ep["fp2_features"]
    if use_obs:
        dsn.load_state_dict(inputs.dsn_state)
        fg, off = dsn(xyz, shared[:, : dsn.pt_stages[0][0]])
        d = (fg[..., 1] - fg[..., 0]).flatten()
        inputs.dsn_state["fg2.bias"][1] -= torch.quantile(d, 1.0 - cal["foreground_share"])
        fg[..., 1] -= torch.quantile(d, 1.0 - cal["foreground_share"])
        labels = ref_dsn_mod.cluster(xyz, off, fg, inputs.gumbel[0, :1])
        obs = ref_ops.gather_points(xyz, ref_post.object_balance_indices(xyz, labels, num_seed=model.backbone.num_seed))
        feats = ref_ops.interpolate_features(obs, ep["fp2_xyz"], feats)
    obj = model.graspable(feats)["objectness_score"]
    d = (obj[..., 1] - obj[..., 0]).flatten()
    inputs.state["graspable.conv3.bias"][1] -= torch.quantile(d, 1.0 - cal["objectness_share"])


def build_program(cell, inputs, device):
    """The program's pipeline with the seed's weights."""
    from graspbalance_tpu_torch.eval.pipeline import GraspInference
    from graspbalance_tpu_torch.models.dsn import DSN
    from graspbalance_tpu_torch.models.graspbalance import GraspBalance

    with torch.device(device):
        model = GraspBalance(**cell.config["model"])
        dsn = DSN(cell.config["dsn"]["pt_stages"]) if cell.traffic["use_obs"] else None
    model.load_state_dict(inputs.state)
    if dsn is not None:
        dsn.load_state_dict(inputs.dsn_state)
    return GraspInference(model, dsn, use_obs=cell.traffic["use_obs"], device=device)


class Capture:
    """Keeps, for the calls it is switched on for, what the program's stages
    handed on: the shared FPS, the DSN's outputs, the labels, the model's
    end points (references to the device tensors; nothing is copied)."""

    def __init__(self, infer, keys):
        self.on, self.rec, self.keys = False, {}, keys
        if infer.use_obs:
            infer.sample = self._keep(infer.sample, "sa")
            infer.segment = self._keep(infer.segment, "labels", first=True)
            infer.dsn.register_forward_hook(self._dsn_hook)
        infer.model.register_forward_hook(self._model_hook)

    def _keep(self, fn, key, first=False):
        def kept(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.on:
                self.rec[key] = out[0] if first else out
            return out

        return kept

    def _dsn_hook(self, module, args, out):
        if self.on:
            self.rec["fg"], self.rec["off"] = out["foreground_logits"], out["center_offsets"]

    def _model_hook(self, module, args, out):
        if self.on:
            self.rec["ep"] = {k: out[k] for k in self.keys}

    def take(self):
        rec, self.rec = self.rec, {}
        return rec


def rel_err(a, b) -> float:
    d = float((a.float() - b.float()).abs().max())
    scale = max(float(b.float().abs().max()), 1e-30)
    return d / scale if np.isfinite(d) else float("inf")


def judge_one(rec, cloud, gumbel, model, dsn, values: dict) -> None:
    """Add one checked call's numbers to ``values`` (counts summed, errors
    maxed). ``rec``: the program's stages (``Capture``) and its answer."""
    ep = rec["ep"]
    sampled, shared = reference_sample(model, dsn, cloud)
    pairs = [(rec["sa"], shared)] if dsn is not None else [(ep[k], v) for k, v in sampled.items()]
    values["fps_mismatch"] += sum(int((got.to(want.device) != want).sum()) for got, want in pairs)
    labels = None
    if dsn is not None:
        fg, off = dsn(cloud, shared[:, : dsn.pt_stages[0][0]])
        values["dsn_err"] = max(values["dsn_err"], rel_err(rec["fg"], fg), rel_err(rec["off"], off))
        labels = rec["labels"]
        ref_labels = ref_dsn_mod.cluster(cloud, rec["off"], rec["fg"], gumbel)
        values["label_mismatch"] += int((ref_labels != labels).sum())
    ref_ep = model(cloud, {k: ep[k] for k in model.backbone.SAMPLED}, seed_cluster=labels,
                   top_view_inds=ep["grasp_top_view_inds"])
    seeds_off = ((ref_ep["fp2_inds"] != ep["fp2_inds"]) | (ref_ep["fp2_xyz"] != ep["fp2_xyz"]).any(dim=-1)
                 | (ref_ep["grasp_top_view_xyz"] != ep["grasp_top_view_xyz"]).any(dim=-1))
    values["seed_mismatch"] += int(seeds_off.sum())
    vs = ref_ep["view_score"]
    chosen = vs.gather(-1, ep["grasp_top_view_inds"].long().unsqueeze(-1))[..., 0]
    view_gap = float((vs.amax(dim=-1) - chosen).max()) / max(float(vs.abs().max()), 1e-30)
    values["head_err"] = max(values["head_err"], view_gap if np.isfinite(view_gap) else float("inf"),
                             *(rel_err(ep[k], ref_ep[k]) for k in HEAD_KEYS))
    grasps, valid = ref_models.pred_decode(ep)
    got = torch.as_tensor(rec["grasps"], device=grasps.device)
    values["decode_mismatch"] += int((grasps != got).any(dim=-1).sum())
    keep = ref_post.postprocess(got, valid, cloud)
    values["keep_mismatch"] += int((keep != torch.as_tensor(rec["keep"], device=keep.device)).sum())


def check(cell, inputs, records, device, due: int) -> dict:
    """name -> (value, limit) over the checked calls ``records`` (each the
    batch index, ``Capture``'s record and the answer), of the ``due`` calls
    drawn for the check that the window made (``malformed_calls`` counts
    those without a whole record of well-shaped stages; a window with none
    due counts one). Runs the
    reference layer by layer, after the program's state is freed."""
    use_obs = cell.traffic["use_obs"]
    model, dsn = reference_modules(cell, use_obs, device)
    model.load_state_dict(inputs.state)
    if dsn is not None:
        dsn.load_state_dict(inputs.dsn_state)
    names = ["fps_mismatch", "dsn_err", "label_mismatch", "seed_mismatch", "head_err",
             "decode_mismatch", "keep_mismatch", "malformed_calls"]
    if not use_obs:
        names = [n for n in names if n not in ("dsn_err", "label_mismatch")]
    values = dict.fromkeys(names, 0.0)
    needed = {"ep", "grasps", "keep"} | ({"sa", "fg", "off", "labels"} if use_obs else set())
    with torch.no_grad():
        for j, rec in records:
            if not needed <= rec.keys():  # an answer whose stages never ran
                values["malformed_calls"] += 1
                continue
            cloud = torch.from_numpy(inputs.clouds[j]).to(device)
            try:
                judge_one(rec, cloud, inputs.gumbel[j], model, dsn, values)
            except (RuntimeError, IndexError) as err:  # stages of the wrong shape
                print(f"call of batch {j}: {err}", file=sys.stderr)
                values["malformed_calls"] += 1
    values["malformed_calls"] += max(due, 1) - len(records)
    return {k: (float(v), float(cell.limits[k])) for k, v in values.items()}


def passed(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())


def control_record(cell, inputs, j: int, model, dsn) -> dict:
    """The reference with TF32 products in the program's place: what
    ``Capture`` would keep of one call, and its answer."""
    cloud = torch.from_numpy(inputs.clouds[j]).to(inputs.gumbel.device)
    rec = {}
    with torch.no_grad(), tf32_products():
        sampled, shared = reference_sample(model, dsn, cloud)
        labels = None
        if dsn is not None:
            rec["sa"] = shared
            rec["fg"], rec["off"] = dsn(cloud, shared[:, : dsn.pt_stages[0][0]])
            labels = rec["labels"] = ref_dsn_mod.cluster(cloud, rec["off"], rec["fg"], inputs.gumbel[j])
        ep = model(cloud, sampled, seed_cluster=labels)
        rec["ep"] = {k: ep[k] for k in ep_keys(cell)}
        grasps, valid = ref_models.pred_decode(ep)
        rec["grasps"], rec["keep"] = grasps.cpu().numpy(), ref_post.postprocess(grasps, valid, cloud).cpu().numpy()
    return rec


def readings(cell, seed: int, program: bool, device, fault=None) -> dict:
    """side -> checks without a window: the calls a run of ``seed`` would
    check (``checked_calls`` pool batches drawn from the seed), answered by
    the program and by the control, each judged by ``check``."""
    if fault is not None:
        raise ValueError("the serving cells' faults are planted by bench_port/tests (CPU)")
    dev = torch.device(device)
    inputs = make_inputs(cell, seed, dev)
    rng = np.random.default_rng(int(seed) % 2**63)
    batches = rng.choice(len(inputs.clouds), size=cell.traffic["checked_calls"], replace=True).tolist()
    out = {}
    if program:
        infer = build_program(cell, inputs, dev)
        cap = Capture(infer, ep_keys(cell))
        records = []
        for j in batches:
            cap.on = True
            grasps, keep = infer(inputs.clouds[j], gumbel=inputs.gumbel[j])
            rec = cap.take()
            rec["grasps"], rec["keep"] = grasps, keep
            records.append((j, rec))
        del infer, cap
        out["program"] = check(cell, inputs, records, dev, len(records))
    model, dsn = reference_modules(cell, cell.traffic["use_obs"], dev)
    model.load_state_dict(inputs.state)
    if dsn is not None:
        dsn.load_state_dict(inputs.dsn_state)
    records = [(j, control_record(cell, inputs, j, model, dsn)) for j in batches]
    del model, dsn
    out["control"] = check(cell, inputs, records, dev, len(records))
    return out


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def run(cell, *, seed: int, seconds: float, trace: bool, device: str, t0: float):
    tr = cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    parts = {"imports": time.perf_counter() - t0}  # set-up's marks, seconds from the process's start
    inputs = make_inputs(cell, seed, dev)
    parts["inputs"] = time.perf_counter() - t0
    infer = build_program(cell, inputs, dev)
    parts["program"] = time.perf_counter() - t0
    cap = Capture(infer, ep_keys(cell))
    spans = tracing.Spans()
    if trace and cuda:
        if infer.use_obs:
            infer.segment = spans.wrap("segment", infer.segment)
        infer.postprocess = spans.wrap("postprocess", infer.postprocess)
        spans.hook_module("model", infer.model)
    nb = len(inputs.clouds)

    def call(i):
        j = i % nb
        return infer(inputs.clouds[j], gumbel=inputs.gumbel[j])

    warm = []
    for i in range(tr["warmup"]):
        t = time.perf_counter()
        call(i)
        warm.append(time.perf_counter() - t)
    rng = np.random.default_rng(int(seed) % 2**63)
    expected = max(int(0.8 * seconds / max(float(np.median(warm[1:] or warm)), 1e-6)), 1)
    n_check = min(tr["checked_calls"], expected)
    to_check = set(rng.choice(expected, size=n_check, replace=False).tolist())
    if cuda:
        torch.cuda.synchronize()
    setup_s = parts["warmup"] = time.perf_counter() - t0

    records, lat = [], []
    spans.on = trace
    with host.steady():
        start = time.perf_counter()
        i = 0
        while time.perf_counter() - start < seconds:
            cap.on = i in to_check
            t = time.perf_counter()
            grasps, keep = call(tr["warmup"] + i)  # the pool's batches in turn, after the warm-up's
            lat.append(time.perf_counter() - t)
            if cap.on:
                rec = cap.take()
                rec["grasps"], rec["keep"] = grasps, keep
                records.append(((tr["warmup"] + i) % nb, rec))
            i += 1
        window_s = time.perf_counter() - start
    spans.on = cap.on = False
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    limit = power_limit() if cuda else "cpu"  # after the window: nvidia-smi is no part of set-up

    out = SimpleNamespace(
        attempted=len(lat), failed=0, setup_s=setup_s, window_s=window_s, latencies=lat,
        scenes_per_call=tr["batch"], breakdown=None, profile={}, kernels={}, spans={}, train=None,
        flops_per_call=model_counts.graspbalance_forward(cell.config["model"], tr["batch"], tr["num_points"],
                                                         bench=cell.bench)
        + (model_counts.dsn_forward(cell.config["dsn"]["pt_stages"], tr["batch"], tr["num_points"])
           if tr["use_obs"] else 0.0),
        peak_flops=cell.config["peak_flops"], peak_bytes=cell.config["peak_bytes"],
        device={"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)},
        notes={"power": limit, "setup_marks_s": parts, "scenes_objects_mean": float(np.mean(inputs.counts))})
    if records:
        obj = [r["ep"]["objectness_score"] for _, r in records if "ep" in r]
        out.notes["valid_share"] = float(np.mean([float((o[..., 1] > o[..., 0]).float().mean()) for o in obj]))
        out.notes["kept_share"] = float(np.mean([r["keep"].mean() for _, r in records]))
    if tr["use_obs"]:
        found = [float(r["labels"].amax(dim=1).float().mean()) for _, r in records if "labels" in r]
        out.notes["obs_objects_mean"] = float(np.mean(found)) if found else None
    if trace and cuda:
        out.spans = spans.ms()
        turn = itertools.count()  # one pass over the pool's batches, as the window cycles them
        out.profile = tracing.profile_stretch(lambda: call(next(turn)), nb)
        if out.profile:
            out.device.update(busy_s=out.profile["busy_s"], window_s=out.profile["window_s"])
            out.breakdown = {"device_ops": out.profile["device_ops"], "idle_gaps": out.profile["idle_gaps"]}
        out.kernels = harness.run_probes(cell, lambda: infer(inputs.clouds[0], gumbel=inputs.gumbel[0]))
    del infer, cap
    if cuda:
        torch.cuda.empty_cache()
    out.checks = check(cell, inputs, records, dev, sum(1 for i in to_check if i < len(lat)))
    out.correct = passed(out.checks)
    return out
