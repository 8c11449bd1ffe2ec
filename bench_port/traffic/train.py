"""The training generator: the program's own per-step path of its training
loop, ``Prefetch`` (a batch made ``prefetch_depth`` steps ahead on a host
thread) -> ``TransferCache.put`` -> ``train_step``, on a new batch every
step.

Its mix file sets ``batch`` scenes of ``num_points`` points with
``objects`` [lo, hi] boxes each, resting on the table (``scenes.py``),
``grasp_points_per_object`` label points an object padded to
``max_grasp_points``; the batches carry the scene geometry only, and the
step expands the analytic labels on the card. ``checked_steps`` steps are
taken in set-up through the same path, and the reference follows them.
The configuration's ``train`` block holds the optimizer's settings.

The check (``compare``), from one initial state, the same batches and
steps:

  loss1_err     the first step's loss against the reference's, |a - b| / |b|
  metric1_err   every metric of the first step, |a - b| / max(|b|, 1e-3)
  grad_gap      the first gradient, as the program's Adam holds it after one
                step (its first moment over 1 - beta1), against the
                reference's: over the leaves, the worst gap between the two
                norms over the larger of the reference leaf's and the median
                leaf's norm
  change_gap    the parameters' change after the checked steps, as grad_gap
                but the median leaf's gap

Leaves whose reference gradient norm is under a thousandth of the median
leaf's move under Adam by round-off alone (a bias that a BatchNorm after it
cancels) and are left out of both gaps. The later steps' losses and the
worst leaf's change are not compared: Adam's first update moves elements
whose gradient is round-off (a few in a million) by a whole step either
way, and batch statistics spread that through the next steps
(``diagnose`` reads them, PERF.md gives the readings).
"""

from __future__ import annotations

import contextlib
import statistics
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from bench_port import harness, host, scenes, tracing, weights
from bench_port.counts import model as model_counts
from bench_port.reference import labels as ref_labels
from bench_port.reference import models as ref_models
from bench_port.reference.layers import tf32_products

TINY_LEAF = 1e-3
BATCH_KEYS = ("point_clouds", "objectness_label", "object_poses", "obj_mask", "obj_sizes", "grasp_points",
              "grasp_pt_obj", "grasp_pt_mask")


def batches(cell, seed: int, stop: threading.Event):
    """Training batches (numpy dicts, the keys the step reads) from ``seed``
    until ``stop`` is set: each scene's object count the next of a cycle of
    ``lo..hi`` shuffled anew every cycle."""
    tr = cell.traffic
    rng = np.random.default_rng([int(seed) % 2**63, 7])
    counts = []
    while not stop.is_set():
        scenes_ = []
        for _ in range(tr["batch"]):
            if not counts:
                counts = list(scenes.object_counts(rng, tr["objects"][1] - tr["objects"][0] + 1, *tr["objects"]))
            scenes_.append(scenes.scene_geometry(
                rng, tr["num_points"], int(counts.pop()), max_objects=tr["max_objects"],
                max_grasp_points=tr["max_grasp_points"], grasp_points_per_object=tr["grasp_points_per_object"],
                resting=True))
        yield {k: np.stack([s[k] for s in scenes_]) for k in BATCH_KEYS}


def tuples(v):
    """JSON's lists as tuples, at every depth (the program's Config holds tuples)."""
    return tuple(tuples(x) for x in v) if isinstance(v, list) else v


def port_config(cell):
    """The program's Config for the cell."""
    from graspbalance_tpu_torch.train.config import Config, DataConfig, ModelConfig, TrainConfig

    tr = cell.traffic
    return Config(
        model=ModelConfig(**{k: tuples(v) for k, v in cell.config["model"].items()}, dtype=cell.config["dtype"]),
        data=DataConfig(num_points=tr["num_points"], max_objects=tr["max_objects"],
                        max_grasp_points=tr["max_grasp_points"], batch_size=tr["batch"], analytic_labels=True),
        train=TrainConfig(**cell.config["train"]),
    )


def initial_state(cell, seed: int, device):
    with torch.device("meta"):
        ref = ref_models.GraspBalance(**cell.config["model"], bench=cell.bench)
    return weights.flax_init_state(weights.shapes_of(ref), seed, device, salt=4)


class Program:
    """The program's model, optimizer, schedule, transfer cache and batch
    stream, with one call per step, as its training loop makes them."""

    def __init__(self, cell, seed: int, state, device):
        from graspbalance_tpu_torch.models.graspbalance import GraspBalance
        from graspbalance_tpu_torch.train.loop import Prefetch, TransferCache
        from graspbalance_tpu_torch.train.train_step import make_optimizer, train_step

        self.cfg = port_config(cell)
        with torch.device(device):
            self.model = GraspBalance(**cell.config["model"])
        self.model.load_state_dict(state)
        self.optimizer, self.scheduler = make_optimizer(self.model, self.cfg, cell.config["steps_per_epoch"])
        self.transfers = TransferCache(device)
        self.stop = threading.Event()
        self.prefetch = Prefetch(batches(cell, seed, self.stop), depth=cell.traffic["prefetch_depth"])
        self.stream = iter(self.prefetch)
        self._train_step = train_step

    def step(self):
        """One step; returns (the host batch, the step's metrics on the device)."""
        host = next(self.stream)
        metrics = self._train_step(self.model, self.optimizer, self.scheduler, self.transfers.put(host), 0, self.cfg)
        return host, metrics

    def close(self):
        """Stop the batch thread and wait for it."""
        self.stop.set()
        thread = self.prefetch._thread
        while thread.is_alive():
            try:
                next(self.stream)
            except StopIteration:
                break
        thread.join(timeout=60)


def leaves(model) -> dict:
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def first_steps(prog, n: int) -> SimpleNamespace:
    """The program's first ``n`` steps through its own path: the host
    batches, each step's metrics, the first gradient from Adam's first
    moment, and the parameters before and after."""
    beta1 = prog.optimizer.param_groups[0]["betas"][0]
    names = {p: k for k, p in prog.model.named_parameters()}
    p0, hosts, metrics, grad = leaves(prog.model), [], [], None
    for i in range(n):
        host, m = prog.step()
        hosts.append(host)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grad = {names[p]: st["exp_avg"].detach() / (1.0 - beta1) for p, st in prog.optimizer.state.items()}
            pa = leaves(prog.model)
    return SimpleNamespace(hosts=hosts, metrics=metrics, grad=grad, p0=p0, pa=pa, p1=leaves(prog.model))


def reference_steps(cell, state, hosts, device, tf32: bool = False) -> SimpleNamespace:
    """The reference's steps on ``hosts`` from ``state``: plain Adam and
    OneCycle (torch.optim) with the configuration's settings, the model in
    train mode; with ``tf32`` every product in TF32 (the control)."""
    t = cell.config["train"]
    with torch.device(device):
        model = ref_models.GraspBalance(**cell.config["model"], bench=cell.bench)
    model.load_state_dict(state)
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=t["learning_rate"], betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=t["weight_decay"], foreach=True)
    sched = torch.optim.lr_scheduler.OneCycleLR(
        opt, max_lr=t["learning_rate"], total_steps=t["max_epoch"] * cell.config["steps_per_epoch"],
        pct_start=0.3, div_factor=25.0, final_div_factor=1e4, anneal_strategy="cos", cycle_momentum=False)
    m = cell.config["model"]
    p0, metrics, grad = leaves(model), [], None
    for i, host in enumerate(hosts):
        batch = ref_labels.expand_labels({k: torch.as_tensor(v, device=device) for k, v in host.items()},
                                         m["num_view"], m["num_angle"], m["num_depth"])
        with tf32_products() if tf32 else contextlib.nullcontext():
            ep = model.forward_train(batch)
            ep["objectness_label"] = batch["objectness_label"]
            loss, mets = ref_labels.get_loss(ep)
            opt.zero_grad(set_to_none=True)
            loss.backward()
        del ep, batch
        metrics.append({k: float(v.detach()) for k, v in mets.items()})
        if i == 0:
            grad = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
        opt.step()
        sched.step()
        if i == 0:
            pa = leaves(model)
    return SimpleNamespace(metrics=metrics, grad=grad, p0=p0, pa=pa, p1=leaves(model))


def leaf_gaps(a: dict, b: dict, kept) -> list:
    """Per leaf of ``kept``: the gap between the two norms over the larger
    of ``b``'s norm of that leaf and of the median leaf."""
    nb = {k: float(b[k].norm()) for k in kept}
    scale = statistics.median(nb.values())
    return [abs(float(a[k].norm()) - nb[k]) / max(nb[k], scale) for k in kept]


def compare(got: SimpleNamespace, ref: SimpleNamespace, limits: dict) -> dict:
    """name -> (value, limit) of the program's (or the control's) first
    steps against the reference's (see the module docstring)."""
    g1, r1 = got.metrics[0], ref.metrics[0]
    gn = {k: float(v.norm()) for k, v in ref.grad.items()}
    med = statistics.median(gn.values())
    kept = [k for k in gn if gn[k] >= TINY_LEAF * med]
    values = {
        "loss1_err": abs(g1["loss/overall_loss"] - r1["loss/overall_loss"]) / abs(r1["loss/overall_loss"]),
        "metric1_err": max(abs(g1[k] - r1[k]) / max(abs(r1[k]), 1e-3) for k in r1),
        "grad_gap": max(leaf_gaps(got.grad, ref.grad, kept)) if set(kept) <= set(got.grad) else float("inf"),
        "change_gap": statistics.median(leaf_gaps({k: got.p1[k] - got.p0[k] for k in kept},
                                                  {k: ref.p1[k] - ref.p0[k] for k in kept}, kept)),
    }
    return {k: (float(v) if np.isfinite(v) else float("inf"), float(limits[k])) for k, v in values.items()}


def diagnose(got: SimpleNamespace, ref: SimpleNamespace) -> dict:
    """What the limits were set from: each step's loss gap, the worst and
    median leaf's gradient and change gaps, and the share of elements whose
    first Adam update went the other way, with their median gradient over
    their leaf's root mean square."""
    out = {f"loss_err.step{i + 1}": abs(g["loss/overall_loss"] - r["loss/overall_loss"]) / abs(r["loss/overall_loss"])
           for i, (g, r) in enumerate(zip(got.metrics, ref.metrics))}
    out.update({f"metric_err.step{i + 1}": max(abs(g[k] - r[k]) / max(abs(r[k]), 1e-3) for k in r)
                for i, (g, r) in enumerate(zip(got.metrics, ref.metrics))})
    gn = {k: float(v.norm()) for k, v in ref.grad.items()}
    kept = [k for k in gn if gn[k] >= TINY_LEAF * statistics.median(gn.values())]
    for name, a, b in (("grad", got.grad, ref.grad),
                       ("change", {k: got.p1[k] - got.p0[k] for k in kept}, {k: ref.p1[k] - ref.p0[k] for k in kept})):
        gaps = sorted(zip(leaf_gaps(a, b, kept), kept))
        out[f"{name}_gap.median"] = gaps[len(gaps) // 2][0]
        out[f"{name}_gap.worst"] = gaps[-1][0]
        out[f"{name}_gap.worst_leaf"] = gaps[-1][1]
    flips = total = 0
    rel = []
    for k in kept:
        da, db = got.pa[k] - got.p0[k], ref.pa[k] - ref.p0[k]
        f = torch.sign(da) != torch.sign(db)
        flips += int(f.sum())
        total += f.numel()
        g = ref.grad[k]
        if f.any():
            rel.append((g[f].abs() / g.pow(2).mean().sqrt()).median().item())
    out["step1_flipped_share"] = flips / max(total, 1)
    out["step1_flipped_grad_rel"] = statistics.median(rel) if rel else 0.0
    return out


def passed(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())


def readings(cell, seed: int, program: bool, device, fault=None) -> dict:
    """side -> checks without a window: the program's first steps (with
    ``fault`` planted, see ``FAULTS``) and the control's, each against the
    reference."""
    dev = torch.device(device)
    state = initial_state(cell, seed, dev)
    n = cell.traffic["checked_steps"]
    out, hosts = {}, None
    if program:
        prog = Program(cell, seed, state, dev)
        with FAULTS[fault](prog) if fault else contextlib.nullcontext():
            got = first_steps(prog, n)
        prog.close()
        hosts = got.hosts
        del prog
    if hosts is None:
        stop = threading.Event()
        gen = batches(cell, seed, stop)
        hosts = [next(gen) for _ in range(n)]
    ref = reference_steps(cell, state, hosts, dev)
    nan = float("nan")
    if program:
        side = "program" if not fault else f"fault:{fault}"
        out[side] = compare(got, ref, cell.limits)
        out[f"diag:{side}"] = {k: (v, nan) for k, v in diagnose(got, ref).items()}
    ctl = reference_steps(cell, state, hosts, dev, tf32=True)
    out["control"] = compare(ctl, ref, cell.limits)
    out["diag:control"] = {k: (v, nan) for k, v in diagnose(ctl, ref).items()}
    return out


class _HalfBatch:
    """The program's step on the first half of each batch, its loss the
    mean over that half."""

    def __init__(self, prog):
        self.prog = prog

    def __enter__(self):
        step = self.prog._train_step

        def half(model, opt, sched, batch, epoch, cfg):
            h = next(iter(batch.values())).shape[0] // 2
            return step(model, opt, sched, {k: v[:h] for k, v in batch.items()}, epoch, cfg)

        self.prog._train_step = half
        return self

    def __exit__(self, *exc):
        return False


class _Unchanged:
    """The program's step leaving its parameters as they were."""

    def __init__(self, prog):
        self.prog = prog

    def __enter__(self):
        step = self.prog._train_step

        def unchanged(model, opt, sched, batch, epoch, cfg):
            before = {k: p.detach().clone() for k, p in model.named_parameters()}
            out = step(model, opt, sched, batch, epoch, cfg)
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(before[k])
            return out

        self.prog._train_step = unchanged
        return self

    def __exit__(self, *exc):
        return False


FAULTS = {"half_batch": _HalfBatch, "unchanged": _Unchanged}


def run(cell, *, seed: int, seconds: float, trace: bool, device: str, t0: float):
    tr = cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    parts = {"imports": time.perf_counter() - t0}  # set-up's marks, seconds from the process's start
    state = initial_state(cell, seed, dev)
    parts["state"] = time.perf_counter() - t0
    prog = Program(cell, seed, state, dev)
    parts["program"] = time.perf_counter() - t0
    got = first_steps(prog, tr["checked_steps"])
    spans = tracing.Spans()
    if trace and cuda:
        fwd = prog.model.forward_train

        def forward_train(*args, **kwargs):
            spans.begin("forward")
            out = fwd(*args, **kwargs)
            spans.end("forward")
            spans.begin("backward")
            return out

        prog.model.forward_train = forward_train
        prog.optimizer.register_step_pre_hook(lambda *_: spans.end("backward"))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = parts["first_steps"] = time.perf_counter() - t0

    spans.on = trace and cuda
    wait0 = prog.prefetch.wait_s
    with host.steady():
        steps, start = 0, time.perf_counter()
        while time.perf_counter() - start < seconds:
            prog.step()
            steps += 1
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - start
    spans.on = False
    wait_s = prog.prefetch.wait_s - wait0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    from bench_port.traffic.serve import power_limit

    limit = power_limit() if cuda else "cpu"  # after the window: nvidia-smi is no part of set-up

    out = SimpleNamespace(
        attempted=steps, failed=0, setup_s=setup_s, window_s=window_s, latencies=[], scenes_per_call=None,
        breakdown=None, profile={}, kernels={}, spans={},
        train={"clouds": steps * tr["batch"], "peak_bytes": peak, "wait_s": wait_s},
        flops_per_call=3 * model_counts.graspbalance_forward(cell.config["model"], tr["batch"], tr["num_points"],
                                                             bench=cell.bench),
        peak_flops=cell.config["peak_flops"], peak_bytes=cell.config["peak_bytes"],
        device={"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if cuda else 0},
        notes={"power": limit, "setup_marks_s": parts, "losses": [m["loss/overall_loss"] for m in got.metrics]})
    if trace and cuda:
        out.spans = {k: v for k, v in spans.ms().items() if v}
        out.profile = tracing.profile_stretch(prog.step, tr["profile_steps"], n_host_calls=1)
        if out.profile:
            out.device.update(busy_s=out.profile["busy_s"], window_s=out.profile["window_s"])
            out.breakdown = {"device_ops": out.profile["device_ops"], "idle_gaps": out.profile["idle_gaps"]}
        out.kernels = harness.run_probes(cell, prog.step)
    prog.close()
    del prog
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_steps(cell, state, got.hosts, dev)
    out.checks = compare(got, ref, cell.limits)
    out.correct = passed(out.checks)
    return out

