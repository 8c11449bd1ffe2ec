"""The gather backward: a scatter-add of cotangent rows onto their source
rows (port of graspbalance_tpu/ops/pallas/scatter_kernel.py:
scatter_add_matmul).

``scatter_add(ct, idx, n)`` launches the CUDA kernel (``csrc/scatter.cu``)
on CUDA tensors and runs ``scatter_add_plain`` on CPU tensors. Both return

  out (B, n, C), out[b, d] = sum of ct[b, r] over the rows r with
  idx[b, r] == d; rows whose index lies outside [0, n) are dropped
  (negative = padding).

The kernel sorts the rows by destination (a stable counting sort over tiles
of rows: histogram, scan, rank) and adds each destination's rows in
increasing row order, in chunks of at most 64 rows whose partial sums it
adds in chunk order, so it is deterministic: two launches on the same inputs give
bit-equal outputs. All its scratch is one allocation.
"""

from __future__ import annotations

import functools

import torch

from graspbalance_tpu_torch import _build

def _check(ct: torch.Tensor, idx: torch.Tensor, n: int) -> None:
    if ct.ndim != 3 or idx.shape != ct.shape[:2]:
        raise ValueError(f"need ct (B, R, C) and idx (B, R); got {tuple(ct.shape)}, {tuple(idx.shape)}")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")


@functools.lru_cache(maxsize=256)
def _scratch_bytes(b: int, r: int, n: int, c: int) -> int:
    """The kernel's scratch bytes for these sizes."""
    nbytes = _build.library().gb_scatter_add_scratch(b, r, n, c)
    if nbytes <= 0:
        raise ValueError(f"scatter kernel refuses (B, R, n, C) = {(b, r, n, c)}")
    return nbytes


def scatter_add_plain(ct: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version: one ``index_add_`` into a flat (B*n + 1, C)
    zero tensor whose last row takes the dropped rows. It sums in float32,
    as the kernel does, or in float64 for a float64 ``ct``; the result is
    in that dtype."""
    _check(ct, idx, n)
    b, _, c = ct.shape
    acc = torch.promote_types(ct.dtype, torch.float32)
    idx = idx.to(torch.int64)
    offs = torch.arange(b, device=idx.device, dtype=torch.int64).unsqueeze(1) * n
    rows = torch.where((idx >= 0) & (idx < n), idx + offs, b * n)
    out = torch.zeros((b * n + 1, c), dtype=acc, device=ct.device)
    out.index_add_(0, rows.reshape(-1), ct.reshape(-1, c).to(acc))
    return out[: b * n].reshape(b, n, c)


def scatter_add(ct: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """ct (B, R, C) f32, idx (B, R) int32 -> (B, n, C) f32 (see the module
    docstring)."""
    _check(ct, idx, n)
    if ct.device.type == "cpu":
        return scatter_add_plain(ct, idx, n)
    _build.require_cuda("ct", ct, torch.float32, 3)
    _build.require_cuda("idx", idx, torch.int32, 2)
    b, r, c = ct.shape
    out = torch.empty((b, n, c), dtype=torch.float32, device=ct.device)
    if out.numel() == 0:
        return out
    scratch = torch.empty(_scratch_bytes(b, r, n, c), dtype=torch.uint8, device=ct.device)
    lib = _build.library()
    with torch.cuda.device(ct.device):
        err = lib.gb_scatter_add(
            ct.data_ptr(), idx.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, r, n, c, _build.stream_of(ct)
        )
    _build.check(err, "scatter")
    return out
