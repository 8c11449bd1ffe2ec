"""The port's GraspNet-1B data path against the JAX package's, on the
hand-made dataset trees of tests/test_data.py (the dataset itself is not in
the repository): data/dataset.py (items, collate, make_dataloaders' batches
and telemetry), data/utils.py, data/native.py (with the native library, and
with its numpy fallbacks), data/generators.py and the host voxel downsample
of eval/collision.py; and cli/train_seg over a tree.

Tolerance: none. The port keeps its own copy of these numpy modules, so
every array must equal the JAX package's exactly, key for key, at the same
seeds.
"""

import dataclasses
import functools
import io
import os
import struct

import numpy as np
import pytest

import graspbalance_tpu.data.dataset as jds
import graspbalance_tpu.data.generators as jgen
import graspbalance_tpu.data.native as jnative
import graspbalance_tpu.data.utils as jutils
from graspbalance_tpu.eval.collision import voxel_downsample as j_voxel_downsample
from graspbalance_tpu.train.config import Config as JConfig
from graspbalance_tpu.train.config import DataConfig as JDataConfig
import graspbalance_tpu_torch.data.dataset as ds
import graspbalance_tpu_torch.data.generators as gen
import graspbalance_tpu_torch.data.native as native
import graspbalance_tpu_torch.data.utils as utils
import graspbalance_tpu_torch.models.dsn as dsn_module
from graspbalance_tpu_torch.cli import train_seg
from graspbalance_tpu_torch.eval.collision import voxel_downsample
from graspbalance_tpu_torch.train.config import Config, DataConfig
from test_data import fabricate_dataset
from test_generators import tolerance_oracle
from test_torch_dsn_train import STAGES
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)


def assert_same(got, want, what=""):
    """Exactly equal: the same keys, dtypes, shapes and values."""
    if isinstance(want, dict):
        assert list(got) == list(want), what
        for k in want:
            assert_same(got[k], want[k], f"{what}/{k}")
        return
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("graspnet"))
    return fabricate_dataset(root, n_scenes=2)


@pytest.fixture(scope="module")
def depth_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("graspnet_depth"))
    return fabricate_dataset(root, real_depth=True)


# GraspNetDataset settings of tests/test_data.py's cases, and the loader's own
DATASETS = {
    "contract": dict(num_points=2048, max_objects=4, max_grasp_points=256, remove_outlier=False,
                     remove_invisible=True),
    "dense_truncation": dict(num_points=2048, max_objects=4, max_grasp_points=256, remove_outlier=False,
                             remove_invisible=False),
    "dense_fits": dict(num_points=2048, max_objects=4, max_grasp_points=512, remove_outlier=False,
                       remove_invisible=False),
    "paired_offsets": dict(num_points=1024, max_objects=4, max_grasp_points=256, remove_outlier=False,
                           remove_invisible=False, paired=True, return_center_offsets=True),
    "augment_fps": dict(num_points=1024, max_objects=2, max_grasp_points=128, remove_outlier=False, augment=True,
                        precompute_fps=64, seed=3),
}


@pytest.mark.parametrize("name", DATASETS)
def test_dataset_items_equal_jax(tree, name):
    kw = DATASETS[name]
    want_valid, want_labels = jds.load_grasp_labels(tree)
    valid, labels = ds.load_grasp_labels(tree)
    assert valid == want_valid
    assert_same(labels, want_labels, "labels")
    jdata = jds.GraspNetDataset(tree, want_valid, want_labels, camera="realsense", split="all", **kw)
    data = ds.GraspNetDataset(tree, valid, labels, camera="realsense", split="all", **kw)
    assert data.samples == jdata.samples and len(data) == 4
    for epoch in (0, 1):
        jdata.epoch = data.epoch = epoch
        for i in range(len(data)):
            assert_same(data[i], jdata[i], f"{name} epoch {epoch} item {i}")
    assert (data.truncated_items, data.truncated_points) == (jdata.truncated_items, jdata.truncated_points)
    if name == "dense_truncation":
        assert data.truncated_items == 8 and data.truncated_points == 8 * (360 - 256)
    assert_same(ds.collate([data[0], data[3]]), jds.collate([jdata[0], jdata[3]]), "collate")


def test_ncm_items_equal_jax(depth_tree):
    """The noisy-clean mix: the depth path (PNG, meta) and the per-object mix
    draw for draw, over 10 epochs; both branches taken."""
    kw = dict(camera="realsense", split="all", num_points=256, load_label=False, remove_outlier=False, ncm=True)
    jdata = jds.GraspNetDataset(depth_tree, [], {}, **kw)
    data = ds.GraspNetDataset(depth_tree, [], {}, **kw)
    noisy = 0
    for epoch in range(10):
        jdata.epoch = data.epoch = epoch
        for i in range(len(data)):
            item = data[i]
            assert_same(item, jdata[i], f"epoch {epoch} item {i}")
            noisy += bool(np.isclose(item["point_clouds"][:, 2], 0.8, atol=1e-3).any())
    assert 0 < noisy < 10 * len(data)


def test_mix_equals_jax():
    rng = np.random.default_rng(0)
    pcd = rng.random((300, 3)).astype(np.float32)
    seg = rng.integers(0, 5, 300).astype(np.int32)
    cpcd, cseg = rng.random((200, 3)).astype(np.float32), rng.integers(0, 5, 200).astype(np.int32)
    want = jds.GraspNetDataset._mix(None, pcd, seg, cpcd, cseg, np.random.default_rng(1))
    got = ds.GraspNetDataset._mix(None, pcd, seg, cpcd, cseg, np.random.default_rng(1))
    assert_same(got, want)


@pytest.mark.parametrize("num_workers", [1, 3])
def test_make_dataloaders_batches_and_telemetry_equal_jax(tree, num_workers):
    """make_dataloaders' training stream (two epochs: the order and the
    augmentation change) and eval stream, and the telemetry after each."""
    fields = dict(dataset_root=tree, num_points=1024, max_objects=4, max_grasp_points=128, batch_size=2,
                  num_workers=num_workers, ncm=False, augment=True, precompute_fps=True)
    j_train, j_eval, j_steps = jds.make_dataloaders(JConfig(data=JDataConfig(**fields)))
    train, evaluate, steps = ds.make_dataloaders(Config(data=DataConfig(**fields)))
    assert steps == j_steps == 2
    for epoch in (0, 1):
        got, want = list(train(epoch)), list(j_train(epoch))
        assert len(got) == len(want) == 2
        for b, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"epoch {epoch} batch {b}")
            assert g["sa_inds"].shape == (2, 2048)
        assert train.telemetry() == j_train.telemetry()
    assert train.telemetry()["data/truncated_items"] > 0
    assert list(evaluate()) == list(j_eval()) == []  # the tree has no test_seen scene


def test_batches_are_fresh_arrays(tree):
    """Every batch is a new collate (the training loop's transfer cache
    keys its uploads on the host array's identity)."""
    cfg = Config(data=DataConfig(dataset_root=tree, num_points=512, max_objects=4, max_grasp_points=64,
                                 batch_size=1, ncm=False, precompute_fps=False))
    train, _, _ = ds.make_dataloaders(cfg)
    batches = list(train(0))
    assert len(batches) == 4
    ids = {id(b[k]) for b in batches for k in b}
    assert len(ids) == 4 * len(batches[0])


def test_host_utils_equal_jax():
    rng = np.random.default_rng(0)
    depth = (rng.random((16, 20)) * 1000).astype(np.uint16)
    cam = utils.CameraInfo(20, 16, 600.0, 610.0, 9.5, 8.0, 1000.0)
    jcam = jutils.CameraInfo(**dataclasses.asdict(cam))
    for organized in (True, False):
        assert_same(utils.create_point_cloud_from_depth_image(depth, cam, organized),
                    jutils.create_point_cloud_from_depth_image(depth, jcam, organized))
    cloud = rng.random((200, 3)).astype(np.float32)
    seg = np.zeros(200, np.int32)
    seg[40:90] = rng.integers(1, 4, 50)
    trans = np.eye(4)
    trans[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    trans[:3, 3] = [0.1, -0.2, 0.3]
    for t in (None, trans, trans[:3]):
        assert_same(utils.transform_points(cloud, trans if t is None else t),
                    jutils.transform_points(cloud, trans if t is None else t))
        assert_same(utils.get_workspace_mask(cloud, seg, t, organized=False, outlier=0.01),
                    jutils.get_workspace_mask(cloud, seg, t, organized=False, outlier=0.01))
    gp = rng.random((300, 3)).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)[:3]
    for th in (0.01, 0.05):
        assert_same(utils.remove_invisible_grasp_points(cloud, gp, pose, th),
                    jutils.remove_invisible_grasp_points(cloud, gp, pose, th))
    assert_same(utils.remove_invisible_grasp_points(cloud[:0], gp, pose), jutils.remove_invisible_grasp_points(
        cloud[:0], gp, pose))
    for n_avail, n in ((500, 200), (100, 250)):
        assert_same(utils.sample_points(n_avail, n, np.random.default_rng(n)),
                    jutils.sample_points(n_avail, n, np.random.default_rng(n)))
    poses = rng.random((3, 3, 4)).astype(np.float32)
    for seed in range(6):  # both sides of the flip draw
        assert_same(utils.augment_flip_rot(cloud, poses, np.random.default_rng(seed)),
                    jutils.augment_flip_rot(cloud, poses, np.random.default_rng(seed)), f"augment {seed}")


def _native_calls(mod, rng):
    pts = (rng.random((500, 3), dtype=np.float32) - 0.5)
    pts[:7] = 0.0  # points at the origin, which host_fps skips
    depth = (rng.random((12, 16)) * 1000).astype(np.uint16)
    cloud, gp = rng.random((300, 3), dtype=np.float32), rng.random((100, 3), dtype=np.float32)
    pose = np.eye(4, dtype=np.float32)[:3]
    return {
        "host_fps": mod.host_fps(pts, 64),
        "host_fps_all": mod.host_fps(pts, 64, skip_origin=False),
        "depth_to_cloud": mod.depth_to_cloud(depth, 600.0, 600.0, 8.0, 6.0, 1000.0),
        "depth_to_cloud_f32": mod.depth_to_cloud(depth.astype(np.float32), 600.0, 600.0, 8.0, 6.0, 1000.0),
        "visibility_mask": mod.visibility_mask(cloud, gp, pose, 0.05),
        "voxel_downsample": mod.voxel_downsample(pts * 0.05, 0.01),
    }


@pytest.mark.parametrize("library", ["built", "absent"])
def test_native_bindings_equal_jax(library, monkeypatch):
    """With the library (native/libgb_native.so) both packages call it; with
    it absent both run their numpy fallbacks."""
    if library == "absent":
        for mod in (native, jnative):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_TRIED", True)
    assert native.available() == jnative.available() == (library == "built" and jnative.available())
    got, want = _native_calls(native, np.random.default_rng(1)), _native_calls(jnative, np.random.default_rng(1))
    assert_same(got, want, library)


def test_voxel_downsample_equals_jax():
    rng = np.random.default_rng(2)
    for n, voxel in ((1000, 0.01), (5000, 0.005)):
        pts = (rng.random((n, 3)) * 0.1 - 0.05).astype(np.float32)
        got = voxel_downsample(pts, voxel)
        assert_same(got, j_voxel_downsample(pts, voxel))
        assert len(got) == len(np.unique(np.floor(pts / voxel).astype(int), axis=0))


def test_tolerance_labels_equal_jax():
    rng = np.random.default_rng(3)
    pts = (rng.random((25, 3), dtype=np.float32) - 0.5) * 0.08
    scores = rng.random((25, 6, 3, 2)).astype(np.float32) * 1.2
    scores[rng.random(scores.shape) < 0.3] = 0
    got = gen.tolerance_for_object(pts, scores)
    assert_same(got, jgen.tolerance_for_object(pts, scores))
    np.testing.assert_allclose(got, tolerance_oracle(pts, scores), atol=1e-7)
    assert_same(gen.tolerance_for_object(pts[:10] * 0.1, np.full((10, 2, 2, 2), 0.4, np.float32)),
                jgen.tolerance_for_object(pts[:10] * 0.1, np.full((10, 2, 2, 2), 0.4, np.float32)))


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
def test_ply_reader_equals_jax(tmp_path, fmt):
    pts = np.random.default_rng(4).random((9, 3)).astype(np.float32)
    path = tmp_path / "m.ply"
    header = (f"ply\nformat {fmt} 1.0\nelement vertex {len(pts)}\nproperty float x\nproperty float y\n"
              "property float z\nproperty uchar red\nend_header\n")
    body = io.BytesIO()
    for row in pts:
        if fmt == "ascii":
            body.write((" ".join(f"{v:.6f}" for v in row) + " 7\n").encode())
        else:
            body.write(struct.pack("<fffB", *row, 7))
    path.write_bytes(header.encode() + body.getvalue())
    got = gen.read_ply_vertices(str(path))
    assert_same(got, jgen.read_ply_vertices(str(path)))
    np.testing.assert_allclose(got, pts, atol=1e-5)


def test_clean_scene_projection_equals_jax():
    rng = np.random.default_rng(5)
    assert_same(gen.create_table_points(1.0, 1.0, 0.01, dx=-0.5, dy=-0.5),
                jgen.create_table_points(1.0, 1.0, 0.01, dx=-0.5, dy=-0.5))
    model = (rng.random((200, 3), dtype=np.float32) - 0.5) * 0.04
    near, far = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
    near[2, 3], far[2, 3] = 0.5, 5.0
    observed = (rng.random((500, 3), dtype=np.float32) - 0.5) * 0.05
    observed[:, 2] += 0.5
    args = ([model, model.copy()], [0, 1], [near[:3], far[:3]], observed, np.eye(4), np.eye(4))
    got = gen.project_models_to_camera(*args)
    assert_same(got, jgen.project_models_to_camera(*args))
    assert (got[1] == 1).sum() > 0 and (got[1] == 2).sum() == 0


def test_dense_instance_labels():
    inst = np.array([[0, 17, 17, 3, 88, 0], [5, 5, 9, 9, 9, 5]], np.int32)
    got = train_seg.dense_instance_labels(inst)
    np.testing.assert_array_equal(got, [[0, 2, 2, 1, 3, 0], [1, 1, 2, 2, 2, 1]])
    assert got.dtype == np.int32


def test_train_seg_on_a_dataset_root(tree, tmp_path, monkeypatch):
    """cli/train_seg --dataset_root: make_dataloaders' stream (augmentation
    and the host FPS precompute on, as the CLI's config has them; the
    noisy-clean mix off, since the hand-made tree's depth frames are blank;
    the DSN at tests/test_torch_dsn_train.py's stage table), 2 epochs of 2
    steps, a checkpoint each."""
    real = ds.make_dataloaders
    monkeypatch.setattr(ds, "make_dataloaders",
                        lambda cfg: real(dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, ncm=False))))
    monkeypatch.setattr(dsn_module, "DSN", functools.partial(dsn_module.DSN, pt_stages=STAGES))
    log_dir = str(tmp_path / "dsn")
    state = train_seg.main(["--dataset_root", tree, "--num_point", "512", "--batch_size", "2", "--max_epoch", "2",
                            "--max_objects", "4", "--log_dir", log_dir, "--device", "cpu"])
    assert state.step == 4
    assert sorted(f for f in os.listdir(os.path.join(log_dir, "checkpoints")) if f.endswith(".pt")) == [
        "step_2.pt", "step_4.pt"]
    assert all(np.isfinite(p.detach().numpy()).all() for p in state.model.parameters())
