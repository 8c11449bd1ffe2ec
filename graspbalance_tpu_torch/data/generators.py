"""Offline label generators (port of graspbalance_tpu/data/generators.py,
numpy and scipy; the reference's DataProcessing/ rebuilt).

1. Clean-scene generation (generate_clean_data.py:61-289): project the
   scene's CAD models + a synthetic table plane into the camera frame,
   keep only projected points within 8 mm of the really-observed cloud,
   save per-frame points/seg npys. No Open3D: minimal PLY reader + the
   native hash voxel downsample + scipy cKDTree for the distance crop.
   (The reference writes 'clear_scenes' but its loader reads
   'clean_scenes' — one of its unrunnable inconsistencies; we write
   'clean_scenes' to match the loader.)

2. Tolerance labels (generate_tolerance_label.py:27-94): per grasp point,
   per (view, angle, depth) bin, the largest radius r <= 0.05 (in 1 mm
   steps) at which >= 80% of the labeled points within r have a friction
   score in (0, mu_thresh]; the radius sweep stops at the first radius
   where no bin qualifies. The reference forks one process per grasp
   point; here sorted-prefix-sum vectorization does a whole object in one
   pass (~10^3x fewer spawns).
"""

from __future__ import annotations

import os
import struct

import numpy as np

V, A, D = 300, 12, 4
RADII = np.array([0.001 * x for x in range(51)], np.float64)


# ---------------------------------------------------------------------------
# minimal PLY vertex reader (ascii + binary_little_endian)
# ---------------------------------------------------------------------------

def read_ply_vertices(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n_vertex = 0
        props = []
        in_vertex = False
        for l in header:
            if l.startswith("element"):
                parts = l.split()
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_vertex = int(parts[2])
            elif l.startswith("property") and in_vertex:
                props.append(tuple(l.split()[1:]))
        type_map = {
            "float": ("f", 4), "float32": ("f", 4), "double": ("d", 8),
            "float64": ("d", 8), "uchar": ("B", 1), "uint8": ("B", 1),
            "char": ("b", 1), "int8": ("b", 1), "short": ("h", 2),
            "ushort": ("H", 2), "int": ("i", 4), "int32": ("i", 4),
            "uint": ("I", 4), "uint32": ("I", 4),
        }
        names = [p[1] for p in props]
        if fmt == "ascii":
            rows = []
            for _ in range(n_vertex):
                vals = f.readline().split()
                rows.append([float(v) for v in vals[: len(props)]])
            arr = np.asarray(rows)
        elif fmt == "binary_little_endian":
            fmt_str = "<" + "".join(type_map[p[0]][0] for p in props)
            size = struct.calcsize(fmt_str)
            raw = f.read(size * n_vertex)
            arr = np.asarray(
                [struct.unpack_from(fmt_str, raw, i * size) for i in range(n_vertex)],
                np.float64,
            )
        else:
            raise ValueError(f"unsupported ply format {fmt}")
        ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
        return arr[:, [ix, iy, iz]].astype(np.float32)


# ---------------------------------------------------------------------------
# clean scenes
# ---------------------------------------------------------------------------

def create_table_points(lx, ly, lz, dx=0.0, dy=0.0, dz=0.0, grid=(0.002, 0.002, 0.008)):
    """Synthetic table slab grid (generate_clean_data.py:197-216)."""
    xs = np.linspace(0, lx, int(lx / grid[0])) + dx
    ys = np.linspace(0, ly, int(ly / grid[1])) + dy
    zs = np.linspace(0, lz, int(lz / grid[2])) + dz
    g = np.stack(np.meshgrid(xs, ys, zs, indexing="xy"), axis=-1)
    return g.reshape(-1, 3).astype(np.float32)


def project_models_to_camera(
    model_points: list[np.ndarray],
    obj_ids: list[int],
    poses: list[np.ndarray],
    scene_cloud: np.ndarray,
    align_mat: np.ndarray,
    camera_pose: np.ndarray,
    voxel: float = 0.005,
    crop_dist: float = 0.008,
):
    """Combine voxel-downsampled CAD models (already in camera frame via
    `poses`) + table plane, crop to points within crop_dist of the observed
    cloud. Returns (points (M,3), seg (M,))."""
    from scipy.spatial import cKDTree

    from graspbalance_tpu_torch.data.native import voxel_downsample

    parts, segs = [], []
    for pts, obj_id, pose in zip(model_points, obj_ids, poses):
        p = pts @ pose[:3, :3].T + pose[:3, 3]
        p = voxel_downsample(p.astype(np.float32), voxel)
        parts.append(p)
        segs.append(np.full(len(p), obj_id + 1, np.int32))
    table = create_table_points(1.0, 1.0, 0.01, dx=-0.5, dy=-0.5, dz=0)
    inv = np.linalg.inv(align_mat @ camera_pose)
    table_cam = table @ inv[:3, :3].T + inv[:3, 3]
    parts.append(table_cam.astype(np.float32))
    segs.append(np.zeros(len(table_cam), np.int32))
    combined = np.concatenate(parts)
    seg = np.concatenate(segs)
    tree = cKDTree(scene_cloud)
    dists, _ = tree.query(combined, k=1)
    keep = dists < crop_dist
    return combined[keep], seg[keep]


def generate_clean_scene_frame(root: str, scene: str, frame: int, camera: str,
                               model_cache: dict) -> None:
    """Generate + save one frame's clean scene (save_data, :125-177)."""
    import scipy.io as scio
    from PIL import Image

    from graspbalance_tpu_torch.data.utils import (
        CameraInfo,
        create_point_cloud_from_depth_image,
        get_workspace_mask,
    )

    base = os.path.join(root, "scenes", scene, camera)
    depth = np.array(Image.open(os.path.join(base, "depth", f"{frame:04d}.png")))
    seg = np.array(Image.open(os.path.join(base, "label", f"{frame:04d}.png")))
    meta = scio.loadmat(os.path.join(base, "meta", f"{frame:04d}.mat"))
    intr = meta["intrinsic_matrix"]
    cam = CameraInfo(
        depth.shape[1], depth.shape[0], intr[0][0], intr[1][1],
        intr[0][2], intr[1][2], float(np.ravel(meta["factor_depth"])[0]),
    )
    cloud = create_point_cloud_from_depth_image(depth, cam, organized=True)
    camera_poses = np.load(os.path.join(base, "camera_poses.npy"))
    align = np.load(os.path.join(base, "cam0_wrt_table.npy"))
    trans = align @ camera_poses[frame]
    mask = (depth > 0) & get_workspace_mask(cloud, seg, trans, True, 0.02)
    observed = cloud[mask]

    obj_idxs = meta["cls_indexes"].flatten().astype(int)
    poses = meta["poses"]
    models = []
    for i in obj_idxs:
        if i - 1 not in model_cache:
            model_cache[i - 1] = read_ply_vertices(
                os.path.join(root, "models", f"{i - 1:03d}", "nontextured.ply")
            )
        models.append(model_cache[i - 1])
    pts, seg_out = project_models_to_camera(
        models,
        [i - 1 for i in obj_idxs],
        [poses[:, :, k] for k in range(len(obj_idxs))],
        observed,
        align,
        camera_poses[frame],
    )
    out_base = os.path.join(root, "clean_scenes", scene, camera)
    os.makedirs(os.path.join(out_base, "points"), exist_ok=True)
    os.makedirs(os.path.join(out_base, "seg"), exist_ok=True)
    np.save(os.path.join(out_base, "points", f"{frame:04d}.npy"), pts)
    np.save(os.path.join(out_base, "seg", f"{frame:04d}.npy"), seg_out)


# ---------------------------------------------------------------------------
# tolerance labels
# ---------------------------------------------------------------------------

def tolerance_for_object(
    points: np.ndarray,
    scores: np.ndarray,
    pos_ratio_thresh: float = 0.8,
    mu_thresh: float = 0.55,
    radii: np.ndarray = RADII,
) -> np.ndarray:
    """(Np,3), (Np,V,A,D) -> tolerance (Np,V,A,D) float32.

    Exact reference semantics (worker(), generate_tolerance_label.py:73-87):
    ascending radius sweep per point, tol[bin] = last radius where the
    positive ratio among neighbors <= r reaches the threshold; the sweep
    stops at the first radius where no bin qualifies.
    """
    n = len(points)
    vad = scores.shape[1:]
    flat = scores.reshape(n, -1)
    pos = ((flat > 0) & (flat <= mu_thresh)).astype(np.float32)
    out = np.zeros((n,) + vad, np.float32)
    d = np.linalg.norm(points[:, None, :] - points[None, :, :], axis=-1)
    order = np.argsort(d, axis=1, kind="stable")
    d_sorted = np.take_along_axis(d, order, axis=1)
    for i in range(n):
        pos_sorted = pos[order[i]]  # (Np, VAD)
        prefix = np.cumsum(pos_sorted, axis=0)  # inclusive
        counts = np.searchsorted(d_sorted[i], radii, side="right")  # (R,)
        ratio = prefix[counts - 1] / counts[:, None]  # (R, VAD); counts >= 1
        qualify = ratio >= pos_ratio_thresh
        any_q = qualify.any(axis=1)
        stop = np.argmin(any_q) if not any_q.all() else len(radii)
        if stop == 0 and not any_q[0]:
            continue
        qualify[stop:] = False
        tol_idx = np.where(
            qualify.any(axis=0), qualify.shape[0] - 1 - np.argmax(qualify[::-1], axis=0), -1
        )
        tol = np.where(tol_idx >= 0, radii[np.maximum(tol_idx, 0)], 0.0)
        out[i] = tol.reshape(vad).astype(np.float32)
    return out


def generate_tolerance_labels(root: str, out_dir: str = "tolerance",
                              objects=range(88), **kw) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for i in objects:
        path = os.path.join(root, "grasp_label", f"{i:03d}_labels.npz")
        if not os.path.exists(path):
            continue
        lbl = np.load(path)
        tol = tolerance_for_object(
            lbl["points"].astype(np.float32), lbl["scores"].astype(np.float32), **kw
        )
        np.save(os.path.join(out_dir, f"{i:03d}_tolerance.npy"), tol)
