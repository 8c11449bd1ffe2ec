"""Build the port's CUDA kernels and load them.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) and the objects are linked into one shared library with a
plain C interface, at first use, into ``_build/<hash of the sources and
flags>/`` beside this file; the library is then loaded with ``ctypes``.
Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an exception.

``launches`` counts, per kernel, the launches that the op wrappers made, so
that a run can show that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
KERNELS = (
    "fps", "multicyl", "widthmlp", "knn", "fps_masked", "collision", "scatter",
    "mlpmax", "widthmlp_rel", "select", "table_gather", "bn_apply", "bn_grad_reduce", "bn_grad_apply",
)

launches: dict[str, int] = dict.fromkeys(KERNELS, 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # name: argument types; every entry point returns a cudaError_t as int
    "gb_fps": (_P, _P, _P, _I, _I, _I, _P),
    "gb_fps_chain": (_P, _P, _P, _I, _I, _I, _P),
    "gb_fps_stream": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "gb_multicyl": (_P, _P, _P, _P, _P, ctypes.c_float, _I, _I, _P, _P, _I, _I, _I, _I, _P),
    "gb_widthmlp": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "gb_knn": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "gb_fps_masked": (_P, _P, _P, _P, _I, _I, _I, _P),
    "gb_collision": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "gb_scatter_add": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "gb_mlpmax": (_P, _P, _I, _I, _P, _P, _P, _I, _I, _P, _I, _I, _I, _P),
    "gb_widthmlp_rel": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "gb_select": (_P, _P, _I, _I, _I, _I, _I, _P),
    "gb_table_gather": (_P, _P, _P, _I, _I, _I, _P),
    "gb_bn_apply": (_P, _P, _P, _P, _L, _I, _I, _P),
    "gb_bn_grad_reduce": (_P, _P, _P, _P, _P, _P, _L, _I, _F, _I, _I, _P),
    "gb_bn_grad_apply": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _P),
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources is (or will be) built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libgb_kernels.so"


@functools.cache
def library() -> ctypes.CDLL:
    """Build the kernels if needed and load them (once per process)."""
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), os.getpid()
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = out.with_name(f"{src.stem}.{tag}.o")
            objs.append(str(obj))
            procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]))
        failed = [p.args[-1] for p in procs if p.wait() != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}")
        tmp = out.with_name(f"{out.name}.{tag}.tmp")
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs], check=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gb_scatter_add_scratch.argtypes = (_I,) * 4
    lib.gb_scatter_add_scratch.restype = ctypes.c_longlong
    lib.gb_fps_stream_slots.argtypes = (_I,)
    lib.gb_fps_stream_slots.restype = ctypes.c_longlong
    lib.gb_bn_partials.argtypes = (_L, _I)
    lib.gb_bn_partials.restype = ctypes.c_longlong
    lib.gb_error_string.argtypes = (ctypes.c_int,)
    lib.gb_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error; count it otherwise."""
    if err != 0:
        msg = library().gb_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} ({msg})")
    launches[kernel] += 1


def stream_of(t) -> int:
    """The current CUDA stream on ``t``'s device, as a pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, t, dtype, ndim: int) -> None:
    """Check what every kernel takes: a contiguous CUDA tensor of ``dtype``."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
