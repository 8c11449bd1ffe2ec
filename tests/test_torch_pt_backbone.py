"""The Point Transformer backbone (``models/pt_backbone.py``,
``GraspBalance(backbone='pt')``) against the plain reference
``tests/pt_reference.py``, at a tiny stage table (256-point clouds, the
first stage keeping every point, stage 2 96 points, 32 seeds) on seeded
random weights:

  - the eval forward's end points (random BatchNorm statistics);
  - the train-mode forward, a loss on the seed features and every
    parameter's gradient;
  - a planted fault, the shared attention weights applied to contiguous
    channel groups, fails the same comparison;
  - the stage's one kNN, shared by its blocks, gives what a kNN for each
    layer gives, and the program searches once a stage (``knn.pairs``);
  - GraspInference with and without OBS, and the FPS length the OBS path
    shares with the DSN taken from the backbone (stage 1 keeps every point);
  - ``check_supported``, ``cli/train --backbone pt``, the GraspNet-1B
    loader's FPS length and one training step.

Tolerances: a float64 run of the reference sizes them. The program and the
float32 reference each round in float32; the program is held within
``ROUND_FACTOR`` times the float32 reference's own distance from float64
(the same rounding, in another order of summation, may land a few times
further off), or ``FLOOR`` of the tensor's largest |value| where both agree
with float64 to that (a gradient that is rounding noise, such as a bias
that a train-mode BatchNorm after it cancels). Indices are compared
exactly.
"""

import math

import numpy as np
import pytest
import torch

import graspbalance_tpu_torch.cli.train as cli
from graspbalance_tpu_torch import trace
from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
from graspbalance_tpu_torch.eval.meanshift import subsampled_count
from graspbalance_tpu_torch.eval.pipeline import GraspInference
from graspbalance_tpu_torch.models import DSN, GraspBalance
from graspbalance_tpu_torch.models import pt_backbone
from graspbalance_tpu_torch.models.graspbalance import fps_length
from graspbalance_tpu_torch.models.pt_backbone import PT_STAGES, PTBackbone
from graspbalance_tpu_torch.ops.fps import furthest_point_sample
from graspbalance_tpu_torch.train.config import Config, DataConfig, ModelConfig, TrainConfig
from graspbalance_tpu_torch.train.train_step import build_model, check_supported, make_optimizer, train_step
from pt_reference import PTReference
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

STAGES = ((256, 4, 16, 1), (96, 8, 16, 1), (48, 8, 32, 2), (16, 4, 32, 1), (8, 4, 64, 1))
NUM_SEED, NUM_VIEW = 32, 24
DSN_STAGES = ((64, 0.2, 8, 16, 1), (32, 0.4, 8, 32, 1))
SCENE = SceneConfig(num_points=256, num_views=NUM_VIEW, max_objects=4, max_grasp_points=128,
                    grasp_points_per_object=24, num_objects=3)
ROUND_FACTOR = 4.0
FLOOR = 1e-6
FLOAT_KEYS = ("fp2_xyz", "fp2_features")
INDEX_KEYS = ("fps_inds", "fp2_inds")


def random_state(module, seed: int) -> dict:
    """Every tensor of ``module``'s state drawn from ``seed``: a weight
    matrix at std 1/sqrt(in), biases at std 0.1, a norm's scale 1 + 0.1 n,
    running means 0.1 n and variances 1 + 0.2 |n| (statistics that are not
    the identity)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in module.state_dict().items():
        n = torch.randn(t.shape, generator=g)
        if name.endswith("running_var"):
            out[name] = 1.0 + 0.2 * n.abs()
        elif name.endswith("running_mean"):
            out[name] = 0.1 * n
        elif n.ndim == 2:
            out[name] = n / math.sqrt(t.shape[1])
        elif name.endswith("weight"):
            out[name] = 1.0 + 0.1 * n
        else:
            out[name] = 0.1 * n
    return out


def cloud(seed: int = 5, batch: int = 2) -> torch.Tensor:
    return torch.from_numpy(make_batch(seed, batch, SCENE)["point_clouds"])


def models(train: bool, seed: int = 3):
    """The program's backbone and the float32 and float64 references, one state."""
    prog = PTBackbone(STAGES, NUM_SEED)
    state = random_state(prog, seed)
    prog.load_state_dict(state)
    ref32, ref64 = PTReference(STAGES, NUM_SEED), PTReference(STAGES, NUM_SEED)
    ref32.load_state_dict(state)
    ref64.load_state_dict(state)
    ref64.double()
    for m in (prog, ref32, ref64):
        m.train(train)
    return prog, ref32, ref64


def far(got, ref32, ref64) -> tuple[float, float]:
    """(the program's distance from float64, its tolerance) for one tensor."""
    want = ref64.detach().double()
    scale = float(want.abs().max())
    own = float((ref32.detach().double() - want).abs().max())
    err = float((got.detach().double() - want).abs().max())
    return err, max(ROUND_FACTOR * own, FLOOR * scale)


SEED_W = torch.randn((NUM_SEED, 256), generator=torch.Generator().manual_seed(9))


def seed_loss(ep) -> torch.Tensor:
    """A loss on the seed features: their products with fixed random weights."""
    f = ep["fp2_features"]
    return (f * SEED_W.to(f.dtype)).sum() / f.shape[0]


def run_all(train: bool, stage_knn: bool = True):
    """End points (and with ``train`` the loss and gradients) of the
    program and both references on one cloud; the FPS is the program's."""
    prog, ref32, ref64 = models(train)
    xyz = cloud()
    out = {}
    for name, m, x in (("prog", prog, xyz), ("ref32", ref32, xyz), ("ref64", ref64, xyz.double())):
        fps = None if name == "prog" else out["prog"]["ep"]["fps_inds"]
        ep = m(x) if name == "prog" else m(x, fps, stage_knn=stage_knn)
        res = {"ep": ep}
        if train:
            loss = seed_loss(ep)
            loss.backward()
            res["loss"] = loss
            res["grads"] = {k: p.grad for k, p in m.named_parameters()}
        out[name] = res
    return out


def check(out) -> list[str]:
    """Every comparison beyond its tolerance, as text."""
    bad = []
    prog, r32, r64 = out["prog"], out["ref32"], out["ref64"]
    for key in INDEX_KEYS:
        if not torch.equal(prog["ep"][key].long(), r64["ep"][key].long()):
            bad.append(key)
    pairs = [(k, prog["ep"][k], r32["ep"][k], r64["ep"][k]) for k in FLOAT_KEYS]
    if "loss" in prog:
        pairs.append(("loss", prog["loss"], r32["loss"], r64["loss"]))
        model_max = max(float(g.abs().max()) for g in r64["grads"].values())
        for k, g in prog["grads"].items():
            err, tol = far(g, r32["grads"][k], r64["grads"][k])
            tol = max(tol, FLOOR * model_max)
            if not err <= tol:
                bad.append(f"grad {k}: {err:.3g} > {tol:.3g}")
    for k, a, b, c in pairs:
        err, tol = far(a, b, c)
        if not err <= tol:
            bad.append(f"{k}: {err:.3g} > {tol:.3g}")
    return bad


@pytest.fixture(scope="module")
def eval_runs():
    with torch.no_grad():
        return run_all(train=False)


@pytest.fixture(scope="module")
def train_runs():
    return run_all(train=True)


def test_modules_and_names():
    m = PTBackbone(STAGES, NUM_SEED)
    assert set(m.state_dict()) == set(PTReference(STAGES, NUM_SEED).state_dict())
    norms = [k for k in m.state_dict() if k.endswith("running_var")]
    assert norms and all(".bn." in f".{k}" for k in norms)  # every norm's tensors under a `.bn.` segment
    full = PTBackbone()
    assert full.stages == PT_STAGES and full.fps_prefix(full.stages) == 5000
    assert 7.7e6 < sum(p.numel() for p in full.parameters()) < 7.9e6
    assert full.block4_4.attn.w1.out_features == 256 // pt_backbone.SHARE_PLANES
    assert isinstance(GraspBalance(backbone="pt", backbone_stages=STAGES, num_seed=NUM_SEED, num_view=NUM_VIEW).backbone,
                      PTBackbone)


def test_pt_refuses_a_fused_grouping():
    """The backbone has no grouping module to fuse: the fused option is
    refused rather than dropped."""
    with pytest.raises(ValueError, match="fused_backbone_min_nsample"):
        GraspBalance(backbone="pt", backbone_stages=STAGES, num_seed=NUM_SEED, num_view=NUM_VIEW,
                     fused_backbone_min_nsample=16)


def test_eval_forward_matches_reference(eval_runs):
    assert not check(eval_runs), check(eval_runs)
    assert eval_runs["prog"]["ep"]["fp2_features"].shape == (2, NUM_SEED, 256)
    assert eval_runs["prog"]["ep"]["fps_inds"].shape == (2, STAGES[1][0])


def test_train_forward_loss_and_gradients_match_reference(train_runs):
    assert not check(train_runs), check(train_runs)
    grads = train_runs["prog"]["grads"]
    assert all(g is not None and torch.isfinite(g).all() for g in grads.values())
    assert float(grads["block1_0.attn.w2.weight"].abs().max()) > 0  # the attention's weights do learn


def contiguous_planes(values, weights):
    """The fault: weight c applied to the contiguous channels c*S .. c*S + S - 1."""
    b, n, k, c = values.shape
    g = weights.shape[-1]
    return (values.view(b, n, k, g, c // g) * weights.unsqueeze(-1)).sum(dim=2).reshape(b, n, c)


@pytest.mark.parametrize("train", [False, True])
def test_contiguous_share_planes_fault_fails(monkeypatch, train):
    monkeypatch.setattr(pt_backbone, "share_planes_sum", contiguous_planes)
    with torch.set_grad_enabled(train):
        bad = check(run_all(train=train))
    assert any(b.startswith("fp2_features") for b in bad), bad


def test_stage_knn_equals_a_knn_per_layer():
    with torch.no_grad():
        out = run_all(train=False, stage_knn=False)
    assert not check(out), check(out)
    prog = PTBackbone(STAGES, NUM_SEED).eval()
    b, n = 2, STAGES[0][0]
    trace.enable()
    try:
        with torch.no_grad():
            prog(cloud())
    finally:
        trace.disable()
        counters = trace.take()["counters"]
    sizes = [n] + [s[0] for s in STAGES[1:]]
    one_a_stage = sum(m * m for m in sizes)  # the stages' own searches
    one_a_stage += sum(sizes[i] * sizes[i - 1] for i in range(1, len(sizes)))  # transition-down
    one_a_stage += sum(sizes[i] * sizes[i + 1] for i in range(len(sizes) - 1))  # transition-up
    assert counters["knn.pairs"] == b * one_a_stage


def pt_model(**kw):
    return GraspBalance(backbone="pt", backbone_stages=STAGES, num_seed=NUM_SEED, num_view=NUM_VIEW, **kw)


@pytest.fixture(scope="module")
def inference_parts():
    model = pt_model()
    model.load_state_dict(random_state(model, 4))
    dsn = DSN(DSN_STAGES)
    dsn.load_state_dict(random_state(dsn, 6))
    return model, dsn


def test_obs_fps_length_comes_from_the_backbone(inference_parts):
    """Stage 1 keeps every point; the FPS the OBS path shares is the
    backbone's ``fps_prefix`` long (stage 2's npoint), not stage 1's npoint."""
    model, dsn = inference_parts
    infer = GraspInference(model, dsn, use_obs=True, device="cpu")
    assert infer.n0_model == model.backbone.fps_prefix(model.backbone.stages) == STAGES[1][0] != STAGES[0][0]
    xyz = cloud(7)
    np.testing.assert_array_equal(infer.sample(xyz).numpy(), furthest_point_sample(xyz, STAGES[1][0]).numpy())


@pytest.mark.parametrize("use_obs", [False, True])
def test_grasp_inference_runs_on_pt(inference_parts, use_obs):
    model, dsn = inference_parts
    infer = GraspInference(model, dsn, use_obs=use_obs, device="cpu")
    seen = {}
    hook = model.backbone.register_forward_hook(
        lambda mod, args, kwargs, out: seen.update(kw=kwargs, ep=dict(out)), with_kwargs=True)
    xyz = cloud(7)
    noise = torch.zeros((2, 1 + 50, subsampled_count(SCENE.num_points)))
    try:
        grasps, keep = infer(xyz.numpy(), gumbel=noise)
    finally:
        hook.remove()
    assert grasps.shape == (2, NUM_SEED, 17) and keep.shape == (2, NUM_SEED)
    assert np.isfinite(grasps).all()
    fps = furthest_point_sample(xyz, STAGES[1][0])
    if use_obs:  # the backbone is handed the shared FPS's prefix, as long as it asks
        np.testing.assert_array_equal(seen["kw"]["sa_inds"].numpy(), fps.numpy())
    ref = PTReference(STAGES, NUM_SEED).eval()
    ref.load_state_dict(model.backbone.state_dict())
    with torch.no_grad():
        want = ref(xyz, fps)
    np.testing.assert_array_equal(seen["ep"]["fps_inds"].numpy(), fps.numpy())
    err, tol = far(seen["ep"]["fp2_features"], want["fp2_features"], want["fp2_features"].double())
    assert err <= max(tol, FLOOR * float(want["fp2_features"].abs().max()))


def test_loader_fps_length_follows_the_backbone():
    """The GraspNet-1B loader precomputes the FPS its backbone takes."""
    assert fps_length("drp") == fps_length("pointnet2") == 2048
    assert fps_length("pt") == 5000
    assert fps_length("pt", STAGES) == STAGES[1][0]


def test_check_supported_and_cli_take_pt(monkeypatch):
    args = cli.parse_args(["--backbone", "pt", "--device", "cpu"])
    cfg = cli.config_from_args(args)
    assert cfg.model.backbone == "pt"
    check_supported(cfg)
    with pytest.raises(ValueError, match="backbone"):
        check_supported(Config(model=ModelConfig(backbone="nope")))
    assert sorted(cli.parse_args([]).__dict__) == sorted(args.__dict__)
    with pytest.raises(SystemExit):
        cli.parse_args(["--backbone", "nope"])


def test_one_training_step_on_pt():
    cfg = Config(model=ModelConfig(backbone="pt", backbone_stages=STAGES, num_seed=NUM_SEED, num_view=NUM_VIEW),
                 data=DataConfig(num_points=SCENE.num_points, batch_size=2, max_objects=SCENE.max_objects,
                                 max_grasp_points=SCENE.max_grasp_points),
                 train=TrainConfig(max_epoch=1))
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    opt, sched = make_optimizer(model, cfg, steps_per_epoch=4)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    metrics = train_step(model, opt, sched, make_batch(1, 2, SCENE), 0, cfg)
    assert math.isfinite(float(metrics["loss/overall_loss"]))
    moved = [k for k, p in model.named_parameters() if not torch.equal(p.detach(), before[k])]
    assert any(k.startswith("backbone.block1_0.attn.") for k in moved)
    assert any(k.startswith("backbone.dec1.") for k in moved)
