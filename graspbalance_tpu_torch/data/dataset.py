"""GraspNet-1Billion dataset with padded fixed-shape labels (port of
graspbalance_tpu/data/dataset.py, numpy only; item for item the same
arrays).

Rebuild of the reference dataset stack (DataProcessing/
graspnet_wonoise_dataset.py + graspnet_dataset.py): same directory layout,
same per-item pipeline (clean-scene npy or raw depth, 20k-point sampling,
per-object visibility + min(max(Np/4,300),Np) label subsample, collision ->
score 0, flip/rot augmentation, NcM noisy-clean per-object mix), but the
output is the padded flat-array contract consumed by the on-device label
pipeline (labels/label_gen.py) instead of ragged lists of tensors:

  point_clouds (N,3) f32          objectness_label (N,) i32
  instance_label (N,) i32         object_poses (O,3,4) f32  obj_mask (O,)
  grasp_points (P,3) f32          grasp_pt_obj (P,) i32     grasp_pt_mask (P,)
  grasp_labels/widths/tolerance (P,V,A,D) f32
  [optional] sa_inds (F,) i32     host-precomputed FPS indices, the
                                  backbone's fps_length (DRP's 2048)

Offsets note: the reference ships (angle, depth, width) offset channels but
only width is ever consumed (TrainModel/loss.py:126-131 extracts all three,
uses widths alone; pred_decode derives angle/depth from bin indices) — so
only offsets[..., 2] is loaded, cutting label memory 3x.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from graspbalance_tpu_torch.data.utils import (
    CameraInfo,
    augment_flip_rot,
    create_point_cloud_from_depth_image,
    get_workspace_mask,
    remove_invisible_grasp_points,
    sample_points,
)

SPLIT_SCENES = {
    "train": range(100),
    "test": range(100, 190),
    "test_seen": range(100, 130),
    "test_similar": range(130, 190),
    "test_novel": range(160, 190),
    "all": range(190),
}

NUM_OBJECTS = 88
INVALID_OBJECT = 18  # excluded by the reference (load_grasp_labels, :964-969)


def load_grasp_labels(root: str, tolerance_root: str | None = None):
    """Load per-object grasp labels: {obj_id_1based: (points, widths,
    scores, tolerance)}. Only the width channel of the offsets is kept."""
    valid, labels = [], {}
    tol_root = tolerance_root or os.path.join(root, "tolerance")
    for i in range(NUM_OBJECTS):
        if i == INVALID_OBJECT:
            continue
        path = os.path.join(root, "grasp_label", f"{i:03d}_labels.npz")
        if not os.path.exists(path):
            continue
        lbl = np.load(path)
        tol_path = os.path.join(tol_root, f"{i:03d}_tolerance.npy")
        tolerance = (
            np.load(tol_path)
            if os.path.exists(tol_path)
            else np.zeros_like(lbl["scores"], np.float32)
        )
        valid.append(i + 1)  # 1-based, aligned with the seg label pngs
        labels[i + 1] = (
            lbl["points"].astype(np.float32),
            lbl["offsets"][..., 2].astype(np.float32),  # widths only
            lbl["scores"].astype(np.float32),
            tolerance.astype(np.float32),
        )
    return valid, labels


class GraspNetDataset:
    """Map-style dataset yielding padded per-sample dicts."""

    def __init__(
        self,
        root: str,
        valid_obj_idxs,
        grasp_labels,
        camera: str = "realsense",
        split: str = "train",
        num_points: int = 20000,
        max_objects: int = 16,
        max_grasp_points: int = 4096,
        remove_outlier: bool = True,
        remove_invisible: bool = True,
        augment: bool = False,
        ncm: bool = False,
        load_label: bool = True,
        precompute_fps: int = 0,
        paired: bool = False,
        return_center_offsets: bool = False,
        seed: int = 0,
    ):
        """`paired`: also return the clean (noise-free) cloud for the same
        frame (GraspPoseDataset_Align, graspnet_wonoise_dataset.py:499-769).
        `return_center_offsets`: host-computed per-point vectors to each
        instance centroid (GraspPoseSegDataset's 3D_offsets, :392-496)."""
        assert num_points <= 50000
        self.root = root
        self.camera = camera
        self.num_points = num_points
        self.max_objects = max_objects
        self.max_grasp_points = max_grasp_points
        self.remove_outlier = remove_outlier
        self.remove_invisible = remove_invisible
        self.augment = augment
        self.ncm = ncm
        self.paired = paired
        self.return_center_offsets = return_center_offsets
        self.load_label = load_label
        self.precompute_fps = precompute_fps
        self.valid_obj_idxs = set(valid_obj_idxs)
        self.grasp_labels = grasp_labels
        self._seed = seed
        self.epoch = 0  # set by the loader per epoch; varies augmentation
        # truncation telemetry: counts of items whose per-object desired
        # grasp-point total exceeded max_grasp_points (labels were then
        # proportionally shrunk, see __getitem__) and of points dropped.
        # Incremented from ThreadPoolExecutor workers (_batched with
        # num_workers > 1), so the read-modify-write needs the lock
        import threading

        self._telemetry_lock = threading.Lock()
        self.truncated_items = 0
        self.truncated_points = 0

        scene_names = [f"scene_{x:04d}" for x in SPLIT_SCENES[split]]
        self.samples = []  # (scene, frame)
        self.collision_labels = {}
        for scene in scene_names:
            scene_dir = os.path.join(root, "scenes", scene, camera)
            if not os.path.isdir(scene_dir):
                continue
            n_frames = len(
                [f for f in os.listdir(os.path.join(scene_dir, "depth"))]
            ) if os.path.isdir(os.path.join(scene_dir, "depth")) else 256
            for f in range(n_frames):
                self.samples.append((scene, f))
            if load_label:
                cpath = os.path.join(
                    root, "collision_label", scene, "collision_labels.npz"
                )
                if os.path.exists(cpath):
                    arrs = np.load(cpath)
                    self.collision_labels[scene] = [
                        arrs[f"arr_{i}"] for i in range(len(arrs.files))
                    ]

    def __len__(self):
        return len(self.samples)

    # -- raw inputs ------------------------------------------------------

    def _load_clean(self, scene, frame):
        base = os.path.join(self.root, "clean_scenes", scene, self.camera)
        cloud = np.load(os.path.join(base, "points", f"{frame:04d}.npy"))
        seg = np.load(os.path.join(base, "seg", f"{frame:04d}.npy"))
        return cloud.astype(np.float32), seg.astype(np.int32)

    def _load_depth(self, scene, frame):
        """Raw depth path (graspnet_dataset.py:100-133): back-project,
        mask by depth>0 & workspace box around the segmented foreground."""
        from PIL import Image
        import scipy.io as scio

        base = os.path.join(self.root, "scenes", scene, self.camera)
        depth = np.array(Image.open(os.path.join(base, "depth", f"{frame:04d}.png")))
        seg = np.array(Image.open(os.path.join(base, "label", f"{frame:04d}.png")))
        meta = scio.loadmat(os.path.join(base, "meta", f"{frame:04d}.mat"))
        intrinsic = meta["intrinsic_matrix"]
        factor_depth = float(np.ravel(meta["factor_depth"])[0])
        cam = CameraInfo(
            depth.shape[1], depth.shape[0],
            intrinsic[0, 0], intrinsic[1, 1],
            intrinsic[0, 2], intrinsic[1, 2], factor_depth,
        )
        cloud = create_point_cloud_from_depth_image(depth, cam, organized=True)
        depth_mask = depth > 0
        if self.remove_outlier:
            camera_poses = np.load(os.path.join(base, "camera_poses.npy"))
            align = np.load(os.path.join(base, "cam0_wrt_table.npy"))
            trans = align @ camera_poses[frame]
            ws = get_workspace_mask(cloud, seg, trans, organized=True, outlier=0.02)
            mask = depth_mask & ws
        else:
            mask = depth_mask
        return (
            cloud[mask].astype(np.float32),
            seg[mask].astype(np.int32),
        )

    def _meta(self, scene, frame):
        import scipy.io as scio

        meta = scio.loadmat(
            os.path.join(
                self.root, "scenes", scene, self.camera, "meta", f"{frame:04d}.mat"
            )
        )
        obj_idxs = meta["cls_indexes"].flatten().astype(np.int32)
        poses = meta["poses"].astype(np.float32)  # (3, 4, O)
        return obj_idxs, poses

    # -- item assembly ---------------------------------------------------

    def __getitem__(self, index):
        scene, frame = self.samples[index]
        # per-(seed, epoch, index) stream: thread-safe under the pooled
        # loader (a shared Generator races) and reproducible
        rng = np.random.default_rng((self._seed, self.epoch, index))
        use_noise = self.ncm and rng.integers(0, 2) == 1

        if use_noise:
            cloud, seg = self._load_depth(scene, frame)
            # NcM: per object, 75% keep noisy camera points / 25% swap in
            # clean CAD-projected points (mix(), :924-937)
            try:
                ccloud, cseg = self._load_clean(scene, frame)
                cloud, seg = self._mix(cloud, seg, ccloud, cseg, rng)
            except FileNotFoundError:
                pass
        else:
            try:
                cloud, seg = self._load_clean(scene, frame)
            except FileNotFoundError:
                cloud, seg = self._load_depth(scene, frame)

        idxs = sample_points(len(cloud), self.num_points, rng)
        cloud_s = cloud[idxs]
        seg_s = seg[idxs]

        if not self.load_label:
            return {"point_clouds": cloud_s.astype(np.float32)}

        obj_idxs, poses = self._meta(scene, frame)
        collision = self.collision_labels.get(scene)

        o_max, p_max = self.max_objects, self.max_grasp_points
        out_poses = np.zeros((o_max, 3, 4), np.float32)
        obj_mask = np.zeros(o_max, bool)
        g_pts = np.zeros((p_max, 3), np.float32)
        g_obj = np.zeros(p_max, np.int32)
        g_mask = np.zeros(p_max, bool)
        lbl_shapes = None
        g_lab = g_wid = g_tol = None

        # Pass 1: per-object reference take counts. The reference keeps
        # min(max(Np/4, 300), Np) grasp points PER OBJECT with no global cap
        # (graspnet_dataset.py:208); our padded buffer has p_max slots total,
        # so when the desired total overflows we shrink every object's take
        # proportionally (preserving the reference's per-object ratios)
        # instead of silently dropping trailing objects — the latter is
        # exactly the small-object starvation GraspBalance exists to avoid.
        per_obj = []  # (i, obj_idx, points, widths, scores, tolerance, coll)
        for i, obj_idx in enumerate(obj_idxs):
            if int(obj_idx) not in self.valid_obj_idxs:
                continue
            if (seg_s == obj_idx).sum() < 50:
                continue
            if len(per_obj) >= o_max:
                break
            points, widths, scores, tolerance = self.grasp_labels[int(obj_idx)]
            coll = collision[i] if collision is not None else None
            if self.remove_invisible:
                vis = remove_invisible_grasp_points(
                    cloud_s[seg_s == obj_idx], points, poses[:, :, i], th=0.01
                )
                points, widths = points[vis], widths[vis]
                scores, tolerance = scores[vis], tolerance[vis]
                if coll is not None:
                    coll = coll[vis]
            if len(points) == 0:
                continue
            per_obj.append((i, points, widths, scores, tolerance, coll))

        desired = np.array(
            [min(max(len(p) // 4, 300), len(p)) for _, p, *_ in per_obj],
            np.int64,
        )
        takes = desired.copy()
        if desired.sum() > p_max:
            # largest-remainder proportional allocation: floor(d*p_max/total)
            # (never exceeds the original desire or Np), then hand leftover
            # slots to the largest fractional remainders
            total = int(desired.sum())
            scaled = desired * p_max
            takes = scaled // total
            rem = scaled - takes * total
            for j in np.argsort(-rem)[: p_max - int(takes.sum())]:
                takes[j] += 1
            with self._telemetry_lock:
                self.truncated_items += 1
                self.truncated_points += total - p_max

        slot, cursor = 0, 0
        for (i, points, widths, scores, tolerance, coll), take in zip(
            per_obj, takes
        ):
            take = int(take)
            if take <= 0:
                continue
            sel = rng.choice(len(points), take, replace=False)
            sl = slice(cursor, cursor + take)
            g_pts[sl] = points[sel]
            g_obj[sl] = slot
            g_mask[sl] = True
            if lbl_shapes is None:
                v, a, d = scores.shape[1:]
                lbl_shapes = (v, a, d)
                g_lab = np.zeros((p_max, v, a, d), np.float32)
                g_wid = np.zeros((p_max, v, a, d), np.float32)
                g_tol = np.zeros((p_max, v, a, d), np.float32)
            s = scores[sel].copy()
            t = tolerance[sel].copy()
            if coll is not None:
                c = coll[sel]
                s[c] = 0
                t[c] = 0
            g_lab[sl] = s
            g_wid[sl] = widths[sel]
            g_tol[sl] = t
            out_poses[slot] = poses[:, :, i]
            obj_mask[slot] = True
            slot += 1
            cursor += take

        if lbl_shapes is None:  # no valid objects: emit minimal labels
            g_lab = np.zeros((p_max, 300, 12, 4), np.float32)
            g_wid = np.zeros_like(g_lab)
            g_tol = np.zeros_like(g_lab)

        if self.augment:
            cloud_s, out_poses, _ = augment_flip_rot(cloud_s, out_poses, rng)

        item = {
            "point_clouds": cloud_s.astype(np.float32),
            "objectness_label": (seg_s > 0).astype(np.int32),
            "instance_label": seg_s.astype(np.int32),
        }
        if self.paired:
            try:
                ccloud, _ = self._load_clean(scene, frame)
                cidx = sample_points(len(ccloud), self.num_points, rng)
                item["clean_point_clouds"] = ccloud[cidx].astype(np.float32)
            except FileNotFoundError:
                item["clean_point_clouds"] = cloud_s.astype(np.float32)
        if self.return_center_offsets:
            offsets = np.zeros_like(cloud_s)
            for obj in np.unique(seg_s):
                if obj == 0:
                    continue
                m = seg_s == obj
                offsets[m] = cloud_s[m].mean(axis=0) - cloud_s[m]
            item["center_offset_label"] = offsets.astype(np.float32)
        item.update({
            "object_poses": out_poses,
            "obj_mask": obj_mask,
            "grasp_points": g_pts,
            "grasp_pt_obj": g_obj,
            "grasp_pt_mask": g_mask,
            "grasp_labels": g_lab,
            "grasp_widths": g_wid,
            "grasp_tolerance": g_tol,
        })
        if self.precompute_fps:
            from graspbalance_tpu_torch.data.native import host_fps

            item["sa_inds"] = host_fps(cloud_s, self.precompute_fps)
        return item

    def _mix(self, pcd, pcd_seg, cpcd, cpcd_seg, rng):
        """Per-object 75/25 noisy/clean mix (graspnet_wonoise_dataset.py:
        924-937)."""
        out_p, out_s = [], []
        for obj in np.unique(pcd_seg):
            if rng.random() > 0.25:
                m = pcd_seg == obj
                out_p.append(pcd[m])
                out_s.append(pcd_seg[m])
            else:
                m = cpcd_seg == obj
                out_p.append(cpcd[m])
                out_s.append(cpcd_seg[m])
        return np.concatenate(out_p), np.concatenate(out_s)


def collate(items: list[dict]) -> dict:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def make_dataloaders(cfg):
    """(train_batches(epoch), eval_batches(), steps_per_epoch) for Config."""
    from graspbalance_tpu_torch.models.graspbalance import fps_length

    d, m = cfg.data, cfg.model
    valid, labels = load_grasp_labels(d.dataset_root)
    common = dict(
        root=d.dataset_root,
        valid_obj_idxs=valid,
        grasp_labels=labels,
        camera=d.camera,
        num_points=d.num_points,
        max_objects=d.max_objects,
        max_grasp_points=d.max_grasp_points,
        precompute_fps=fps_length(m.backbone, m.backbone_stages) if d.precompute_fps else 0,
    )
    train_ds = GraspNetDataset(
        split="train", remove_outlier=True, augment=d.augment, ncm=d.ncm, **common
    )
    eval_ds = GraspNetDataset(
        split="test_seen", remove_outlier=True, augment=False, ncm=False, **common
    )
    bs = d.batch_size
    steps = len(train_ds) // bs

    def train_batches(epoch: int) -> Iterator[dict]:
        train_ds.epoch = epoch
        order = np.random.default_rng(epoch).permutation(len(train_ds))
        yield from _batched(train_ds, order, bs, d.num_workers)

    def eval_batches() -> Iterator[dict]:
        yield from _batched(eval_ds, np.arange(len(eval_ds)), bs, d.num_workers)

    def telemetry() -> dict:
        """Data-pipeline counters for the train metric stream (VERDICT r3
        #8): without this, a dense scene whose per-object grasp-point total
        exceeds max_grasp_points truncates silently in production logs."""
        return {
            "data/truncated_items": float(train_ds.truncated_items),
            "data/truncated_points": float(train_ds.truncated_points),
        }

    train_batches.telemetry = telemetry
    return train_batches, eval_batches, steps


def _batched(ds, order, bs, num_workers) -> Iterator[dict]:
    if num_workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(num_workers) as pool:
            for i in range(0, len(order) - bs + 1, bs):
                yield collate(list(pool.map(ds.__getitem__, order[i : i + bs])))
    else:
        for i in range(0, len(order) - bs + 1, bs):
            yield collate([ds[j] for j in order[i : i + bs]])
