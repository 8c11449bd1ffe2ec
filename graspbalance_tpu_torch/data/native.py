"""ctypes bindings for the repo's native host library
(native/gb_native.cpp; port of graspbalance_tpu/data/native.py).

Host code, not a device kernel: the loader's FPS precompute, depth
projection, visibility check and voxel downsample. Every function falls
back to its numpy implementation when ``native/libgb_native.so`` (at the
repo root, the path the JAX package loads) is not built; ``make -C native``
builds it.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(
        os.path.dirname(__file__), "..", "..", "native", "libgb_native.so"
    )
    path = os.path.abspath(path)
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.gb_fps.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, i32p]
    lib.gb_depth_to_cloud.argtypes = [
        u16p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, f32p,
    ]
    lib.gb_visibility_mask.argtypes = [
        f32p, ctypes.c_int64, f32p, ctypes.c_int64, f32p, ctypes.c_float, u8p
    ]
    lib.gb_voxel_downsample.argtypes = [f32p, ctypes.c_int64, ctypes.c_float, f32p]
    lib.gb_voxel_downsample.restype = ctypes.c_int64
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def host_fps(points: np.ndarray, m: int, skip_origin: bool = True) -> np.ndarray:
    """(N,3) -> (m,) int32 FPS indices, reference variant-A semantics.
    Used by the loader to precompute sa_inds so the device training step
    contains no sequential sampling."""
    lib = _load()
    pts = np.ascontiguousarray(points, np.float32)
    if lib is not None:
        out = np.empty(m, np.int32)
        lib.gb_fps(pts, pts.shape[0], m, int(skip_origin), out)
        return out
    # numpy fallback
    n = pts.shape[0]
    valid = (pts * pts).sum(-1) > 1e-3 if skip_origin else np.ones(n, bool)
    dist = np.full(n, 1e10, np.float32)
    out = np.zeros(m, np.int32)
    last = 0
    for j in range(1, m):
        d = ((pts - pts[last]) ** 2).sum(-1).astype(np.float32)
        np.minimum(dist, d, out=dist)
        last = int(np.argmax(np.where(valid, dist, -1.0)))
        out[j] = last
    return out


def depth_to_cloud(depth: np.ndarray, fx, fy, cx, cy, scale) -> np.ndarray:
    lib = _load()
    if lib is not None and depth.dtype == np.uint16:
        h, w = depth.shape
        out = np.empty((h * w, 3), np.float32)
        lib.gb_depth_to_cloud(
            np.ascontiguousarray(depth), h, w, fx, fy, cx, cy, scale, out
        )
        return out.reshape(h, w, 3)
    from graspbalance_tpu_torch.data.utils import CameraInfo, create_point_cloud_from_depth_image

    cam = CameraInfo(depth.shape[1], depth.shape[0], fx, fy, cx, cy, scale)
    return create_point_cloud_from_depth_image(depth.astype(np.float32), cam)


def visibility_mask(cloud: np.ndarray, grasp_points: np.ndarray, pose: np.ndarray, th: float = 0.01) -> np.ndarray:
    lib = _load()
    if lib is not None:
        out = np.empty(grasp_points.shape[0], np.uint8)
        lib.gb_visibility_mask(
            np.ascontiguousarray(cloud, np.float32), cloud.shape[0],
            np.ascontiguousarray(grasp_points, np.float32), grasp_points.shape[0],
            np.ascontiguousarray(pose[:3, :4], np.float32), th, out,
        )
        return out.astype(bool)
    from graspbalance_tpu_torch.data.utils import remove_invisible_grasp_points

    return remove_invisible_grasp_points(cloud, grasp_points, pose, th)


def voxel_downsample(points: np.ndarray, voxel: float = 0.005) -> np.ndarray:
    lib = _load()
    pts = np.ascontiguousarray(points, np.float32)
    if lib is not None:
        out = np.empty_like(pts)
        n = lib.gb_voxel_downsample(pts, pts.shape[0], voxel, out)
        return out[:n].copy()
    from graspbalance_tpu_torch.eval.collision import voxel_downsample as vd

    return vd(pts, voxel)
