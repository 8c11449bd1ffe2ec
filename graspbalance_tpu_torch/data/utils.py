"""Host-side point-cloud utilities, numpy only (port of
graspbalance_tpu/data/utils.py, the reference's data_utils.py).

The hot paths (depth projection, workspace mask, visibility check, FPS
precompute) also have native C++ implementations in native/ (loaded via
ctypes when built, see data/native.py); these numpy versions are the
always-available fallback and the correctness oracle.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CameraInfo:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    scale: float


def create_point_cloud_from_depth_image(
    depth: np.ndarray, camera: CameraInfo, organized: bool = True
) -> np.ndarray:
    """Pinhole back-projection (data_utils.py:14-25)."""
    assert depth.shape == (camera.height, camera.width)
    xmap, ymap = np.meshgrid(
        np.arange(camera.width), np.arange(camera.height)
    )
    z = depth / camera.scale
    x = (xmap - camera.cx) * z / camera.fx
    y = (ymap - camera.cy) * z / camera.fy
    cloud = np.stack([x, y, z], axis=-1).astype(np.float32)
    return cloud if organized else cloud.reshape(-1, 3)


def transform_points(points: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """(N,3) x (3,3)|(3,4)|(4,4) -> (N,3)."""
    out = points @ transform[:3, :3].T
    if transform.shape[1] >= 4:
        out = out + transform[:3, 3]
    return out


def get_workspace_mask(
    cloud: np.ndarray,
    seg: np.ndarray,
    trans: np.ndarray | None = None,
    organized: bool = True,
    outlier: float = 0.0,
) -> np.ndarray:
    """Bounding-box workspace mask around foreground (data_utils.py:56-73)."""
    shape = cloud.shape[:-1]
    pts = cloud.reshape(-1, 3)
    s = seg.reshape(-1)
    if trans is not None:
        pts = transform_points(pts, trans)
    fg = pts[s > 0]
    lo = fg.min(axis=0) - outlier
    hi = fg.max(axis=0) + outlier
    mask = np.all((pts > lo) & (pts < hi), axis=-1)
    return mask.reshape(shape) if organized else mask


def remove_invisible_grasp_points(
    cloud: np.ndarray, grasp_points: np.ndarray, pose: np.ndarray, th: float = 0.01
) -> np.ndarray:
    """Visibility filter: a label point survives iff some observed object
    point lies within `th` of it (data_utils.py:48-53). Chunked to bound the
    (Np, Nobs) distance matrix."""
    gp = transform_points(grasp_points, pose)
    if len(cloud) == 0:
        return np.zeros(len(gp), bool)
    out = np.empty(len(gp), bool)
    chunk = 2048
    for i in range(0, len(gp), chunk):
        d = np.linalg.norm(gp[i : i + chunk, None, :] - cloud[None], axis=-1)
        out[i : i + chunk] = d.min(axis=1) < th
    return out


def sample_points(n_available: int, num_points: int, rng: np.random.Generator) -> np.ndarray:
    """Reference sampling rule (graspnet_wonoise_dataset.py:197-203): without
    replacement when enough points, else all + random repeats."""
    if n_available >= num_points:
        return rng.choice(n_available, num_points, replace=False)
    extra = rng.choice(n_available, num_points - n_available, replace=True)
    return np.concatenate([np.arange(n_available), extra])


def augment_flip_rot(
    cloud: np.ndarray, poses: np.ndarray, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """YZ-plane flip (p=0.5) + random rotation about camera X in [-30, 30]
    degrees, applied to the cloud and to every object pose
    (graspnet_wonoise_dataset.py:120-147). poses (O, 3, 4)."""
    aug = np.eye(3, dtype=np.float32)
    if rng.random() > 0.5:
        flip = np.diag([-1.0, 1.0, 1.0]).astype(np.float32)
        cloud = cloud @ flip.T
        poses = np.einsum("ij,ojk->oik", flip, poses)
        aug = aug @ flip.T
    angle = (rng.random() * np.pi / 3) - np.pi / 6
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    cloud = cloud @ rot.T
    poses = np.einsum("ij,ojk->oik", rot, poses)
    aug = aug @ rot.T
    return cloud.astype(np.float32), poses.astype(np.float32), aug
