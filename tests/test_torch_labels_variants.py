"""The port's label variants against the JAX package: the synthetic scene
modes (static, analytic, analytic without label tensors, the extents), the
analytic label tensors and their expansion on the device, and the label
pipeline on labels whose ties the argmax tie order decides.

Tolerances:
  - make_batch in every mode: every key exactly (the same numpy draws);
    static labels are the same array object on every call;
  - analytic_label_tensors (numpy): exactly the JAX package's;
  - expand_batch_labels (torch): exactly the JAX package's numpy tensors,
    except elements whose width lies within one float32 ulp of
    GRASP_MAX_WIDTH (there the graspable flag may flip on a last-bit
    difference of the width's sum; their count is asserted to be the count
    of differing elements, and is 0 on these scenes); against the JAX
    package's own device expansion (jnp, which computes the friction's exp
    and the width's product in XLA) within 2e-7 absolute, the tolerance
    the JAX package holds its two expansions to (tests/test_quality.py);
  - process_grasp_labels, match_grasp_view_and_label and get_loss against
    the JAX package's, on labels quantised to six values so that the argmax
    ties the tie order decides are common, with some widths above
    GRASP_MAX_WIDTH, at tests/test_torch_train.py's tolerances: the
    matched label floats 1e-6 absolute, the loss and every metric 1e-4
    relative (1e-7 absolute for metrics that are 0);
  - a training step that expands analytic labels on the device against one
    on the host's tensors: bit-equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspbalance_tpu.data.synthetic import make_batch as j_make_batch
from graspbalance_tpu.labels import analytic as j_analytic
from graspbalance_tpu.labels.label_gen import (
    match_grasp_view_and_label as j_match_grasp_view_and_label,
    process_grasp_labels as j_process_grasp_labels,
)
from graspbalance_tpu.labels.losses import get_loss as j_get_loss
from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
from graspbalance_tpu_torch.labels.analytic import analytic_label_tensors, expand_batch_labels
from graspbalance_tpu_torch.labels.geometry import GRASP_MAX_WIDTH
from graspbalance_tpu_torch.labels.label_gen import match_grasp_view_and_label, process_grasp_labels
from graspbalance_tpu_torch.labels.losses import get_loss
from graspbalance_tpu_torch.train.config import Config, DataConfig, ModelConfig
from graspbalance_tpu_torch.train.train_step import create_train_state, to_device, train_step
from tiny import TINY_NUM_SEED, TINY_NUM_VIEW, TINY_QUALITY_SCENE, TINY_SCENE, TINY_STAGES
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

LABEL_KEYS = ("grasp_labels", "grasp_widths", "grasp_tolerance")
GEOMETRY_KEYS = ("obj_sizes", "grasp_pt_obj", "grasp_pt_mask")
NUM_SEEDS = 32
MODES = {
    "varied": {},
    "static": {"static_labels": True},
    "analytic": {"analytic_labels": True},
    "analytic_no_tensors": {"analytic_labels": True, "emit_label_tensors": False},
    "extents": {"table_frac": 0.3, "table_extent": 0.12, "object_scatter": 0.08},
    "quality_gate": dataclasses.asdict(TINY_QUALITY_SCENE),
}


def _port_scene(jcfg):
    return SceneConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(SceneConfig)})


@pytest.mark.parametrize("mode", MODES)
def test_make_batch_modes_match_jax(mode):
    jcfg = dataclasses.replace(TINY_SCENE, **MODES[mode])
    cfg = _port_scene(jcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for seed, b in ((0, 2), (5, 3)):
        want, got = j_make_batch(seed, b, jcfg), make_batch(seed, b, cfg)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if mode == "analytic_no_tensors":
        assert not set(LABEL_KEYS) & got.keys()


def test_static_labels_are_one_object():
    cfg = _port_scene(dataclasses.replace(TINY_SCENE, static_labels=True))
    a, b = make_batch(0, 2, cfg), make_batch(9, 2, cfg)
    for key in LABEL_KEYS:
        assert a[key] is b[key], key
        assert a[key].strides[0] == 0 and not a[key].flags.writeable, key
    assert not np.array_equal(a["point_clouds"], b["point_clouds"])  # the geometry varies


@pytest.mark.parametrize("num_views", [TINY_NUM_VIEW, 300])
def test_analytic_label_tensors_match_jax(num_views):
    b = make_batch(0, 2, _port_scene(dataclasses.replace(TINY_SCENE, analytic_labels=True, num_views=num_views)))
    for i in range(2):
        want = j_analytic.analytic_label_tensors(*(b[k][i] for k in GEOMETRY_KEYS), num_views, 12, 4, xp=np)
        got = analytic_label_tensors(*(b[k][i] for k in GEOMETRY_KEYS), num_views, 12, 4)
        for key, w, g in zip(LABEL_KEYS, want, got):
            assert g.dtype == np.float32 and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)


def _boundary(widths):
    """Elements whose width lies within one float32 ulp of GRASP_MAX_WIDTH."""
    edge = np.float32(GRASP_MAX_WIDTH)
    return np.abs(widths - edge) <= np.spacing(edge)


@pytest.mark.parametrize("num_views", [TINY_NUM_VIEW, 300])
def test_expand_batch_labels_matches_jax(num_views):
    cfg = _port_scene(dataclasses.replace(TINY_SCENE, analytic_labels=True, num_views=num_views))
    host = make_batch(0, 2, cfg)  # the numpy tensors, as the JAX package's host generator makes them
    got = expand_batch_labels({k: torch.from_numpy(host[k]) for k in GEOMETRY_KEYS}, num_views, 12, 4)
    j_dev = j_analytic.expand_batch_labels({k: jnp.asarray(host[k]) for k in GEOMETRY_KEYS}, num_views, 12, 4)
    boundary = _boundary(host["grasp_widths"])
    for key in LABEL_KEYS:
        g = got[key].numpy()
        assert g.shape == host[key].shape and g.dtype == np.float32, key
        differ = g != host[key]
        assert int(differ.sum()) == int((differ & boundary).sum()), key
        keep = ~boundary
        np.testing.assert_allclose(g[keep], np.asarray(j_dev[key])[keep], atol=2e-7, rtol=0, err_msg=key)
    assert int(boundary.sum()) == 0  # none on these scenes: every element compared exactly
    assert host["grasp_labels"].max() > 0 and (host["grasp_labels"] == 0).any()


def _label_inputs(seed: int, random_poses: bool):
    """A batch with labels quantised to six values (ties common) and 15% of
    the widths above GRASP_MAX_WIDTH; seeds are cloud points; top views and
    head predictions random."""
    rng = np.random.default_rng(seed)
    batch = make_batch(seed, 2, _port_scene(TINY_SCENE))
    shape = batch["grasp_labels"].shape
    vals = np.asarray([0.0, 0.0, 0.2, 0.4, 0.8, 1.2], np.float32)
    batch["grasp_labels"] = vals[rng.integers(0, len(vals), size=shape)]
    batch["grasp_widths"] = np.where(rng.random(shape) < 0.15, 0.5, batch["grasp_widths"]).astype(np.float32)
    if random_poses:
        q, _ = np.linalg.qr(rng.standard_normal(batch["object_poses"].shape[:2] + (3, 3)))
        q *= np.sign(np.linalg.det(q))[..., None, None]
        batch["object_poses"] = batch["object_poses"].copy()
        batch["object_poses"][..., :3] = q.astype(np.float32)
    b, n = batch["point_clouds"].shape[:2]
    seed_inds = np.stack([rng.choice(n, NUM_SEEDS, replace=False) for _ in range(b)]).astype(np.int32)
    seeds = np.take_along_axis(batch["point_clouds"], seed_inds[..., None], axis=1)
    v, a, d = shape[2:]
    top = rng.integers(0, v, (b, NUM_SEEDS)).astype(np.int32)
    preds = {
        "objectness_score": rng.standard_normal((b, NUM_SEEDS, 2)),
        "view_score": rng.standard_normal((b, NUM_SEEDS, v)),
        **{k: rng.standard_normal((b, NUM_SEEDS, a, d)) for k in (
            "grasp_score_pred", "grasp_angle_cls_pred", "grasp_width_pred", "grasp_tolerance_pred")},
    }
    preds = {k: x.astype(np.float32) for k, x in preds.items()}
    preds["fp2_inds"] = seed_inds
    preds["objectness_label"] = batch["objectness_label"]
    return batch, seeds, top, preds


def _port_loss(batch, seeds, top, preds):
    matched = match_grasp_view_and_label(
        torch.from_numpy(top), process_grasp_labels(torch.from_numpy(seeds), to_device(batch, "cpu"))
    )
    ep = {**{k: torch.from_numpy(v) for k, v in preds.items()}, **matched}
    loss, metrics = get_loss(ep)
    return matched, loss, metrics


@pytest.mark.parametrize("random_poses", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_labels_with_ties_match_jax(seed, random_poses):
    batch, seeds, top, preds = _label_inputs(seed, random_poses)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_matched = j_match_grasp_view_and_label(jnp.asarray(top), j_process_grasp_labels(jnp.asarray(seeds), jb))
    matched, loss, metrics = _port_loss(batch, seeds, top, preds)
    assert matched.keys() == j_matched.keys()
    for key in j_matched:
        np.testing.assert_allclose(matched[key].numpy(), np.asarray(j_matched[key]), atol=1e-6, rtol=0, err_msg=key)
    label = matched["batch_grasp_label_all"]
    assert float(label.max()) > 0 and bool((label == label.amax(dim=(-2, -1), keepdim=True)).sum() > label[..., 0, 0].numel())
    j_loss, j_metrics = j_get_loss({**{k: jnp.asarray(v) for k, v in preds.items()}, **j_matched})
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    assert metrics.keys() == j_metrics.keys()
    for key in j_metrics:
        np.testing.assert_allclose(float(metrics[key]), float(j_metrics[key]), rtol=1e-4, atol=1e-7, err_msg=key)


def test_train_step_expands_analytic_labels_on_the_device():
    """One training step on an analytic batch without label tensors (the
    step expands them) equals one on the same batch with the host's
    tensors, bit for bit (the expansion equals the host's exactly)."""
    scene = _port_scene(dataclasses.replace(TINY_SCENE, analytic_labels=True))
    host = make_batch(3, 2, scene)
    bare = make_batch(3, 2, dataclasses.replace(scene, emit_label_tensors=False))
    assert not set(LABEL_KEYS) & bare.keys()
    cfg = Config(model=ModelConfig(num_view=TINY_NUM_VIEW, num_seed=TINY_NUM_SEED, backbone_stages=TINY_STAGES),
                 data=DataConfig(analytic_labels=True))
    out = []
    for batch in (host, bare):
        s = create_train_state(cfg, 10, batch, device="cpu")
        metrics = train_step(s.model, s.optimizer, s.scheduler, batch, 0, cfg)
        out.append((metrics, s.model.state_dict()))
    (m_host, sd_host), (m_bare, sd_bare) = out
    assert all(torch.equal(m_host[k], m_bare[k]) for k in m_host)
    assert all(torch.equal(sd_host[k], sd_bare[k]) for k in sd_host)
