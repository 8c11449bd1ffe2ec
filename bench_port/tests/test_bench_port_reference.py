"""The frozen reference held to the program on the CPU, at tiny sizes and
on one state dict, stage by stage and with no stage fed from the other
side: the same FPS indices, labels, re-drawn seeds, decoded grasps and keep
masks, and float outputs within 1e-5 of the largest (both run the same
float32 operations on the CPU; the bound leaves room for a library that
sums in another order)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_port import harness
from bench_port.reference import dsn as ref_dsn
from bench_port.reference import models as ref_models
from bench_port.reference import postprocess as ref_post
from bench_port.tests.tiny import make_checkout, tiny_cells

TOL = 1e-5


def close(a, b):
    return float((a - b).abs().max()) <= TOL * max(float(b.abs().max()), 1e-30)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell_name", tiny_cells("serve"))
def test_reference_follows_the_program(tmp_path, cell_name):
    """Each serving cell's configuration, through its backbone's reference
    file and sampling contract."""
    cell = harness.load_cell(make_checkout(tmp_path), cell_name)
    gen = cell.generator()
    obs = cell.traffic["use_obs"]
    inputs = gen.make_inputs(cell, 11, torch.device("cpu"))
    infer = gen.build_program(cell, inputs, "cpu")
    ref, d_ref = gen.reference_modules(cell, obs, "cpu")
    ref.load_state_dict(inputs.state)
    if obs:
        d_ref.load_state_dict(inputs.dsn_state)
    clouds, gumbel = inputs.clouds[1], inputs.gumbel[1]
    xyz = torch.from_numpy(clouds)

    labels = None
    with torch.no_grad():
        sampled, shared = gen.reference_sample(ref, d_ref, xyz)
        if obs:
            got_labels, got_sa = infer.segment(xyz, gumbel=gumbel)
            assert torch.equal(got_sa, sampled[ref.backbone.SAMPLED[0]])
            dsn_sa = shared[:, : d_ref.pt_stages[0][0]]
            fg, off = d_ref(xyz, dsn_sa)
            ep_d = infer.dsn(xyz, sa_inds=dsn_sa)
            assert close(ep_d["foreground_logits"], fg) and close(ep_d["center_offsets"], off)
            labels = ref_dsn.cluster(xyz, off, fg, gumbel)
            assert torch.equal(got_labels, labels)
            assert int(labels.max()) >= 1  # the mean shift found objects
        ep = ref(xyz, sampled, seed_cluster=labels)
        got = infer.forward(xyz, gumbel=gumbel)
    for key in (*ref.backbone.SAMPLED, "fp2_inds", "grasp_top_view_inds"):
        assert torch.equal(got[key], ep[key]), key
    for key in ("objectness_score", "view_score", "grasp_score_pred", "grasp_angle_cls_pred", "grasp_width_pred",
                "grasp_tolerance_pred", "fp2_xyz"):
        assert close(got[key], ep[key]), key
    grasps, valid = ref_models.pred_decode(ep)
    keep = ref_post.postprocess(grasps, valid, xyz)
    got_grasps, got_keep = infer(clouds, gumbel=gumbel)
    np.testing.assert_allclose(got_grasps, grasps.numpy(), rtol=0, atol=TOL)
    assert np.array_equal(got_keep, keep.numpy())
    assert valid.any() and keep.any()  # the calibrated weights keep some grasps
