"""Same-shape gather from a table: the table-gather probe (port of
tools/probe_mosaic_gather.py, whose Pallas kernel is a same-shape
``take_along_axis`` from a VMEM-resident table).

``table_gather(x, idx, dim)`` launches the CUDA kernel
(``csrc/table_gather.cu``) on CUDA tensors and runs ``table_gather_plain``
on CPU tensors. For x (M, N) float32 and idx (M, N) int32 in range:

  dim 0: out[i, j] = x[idx[i, j], j]
  dim 1: out[i, j] = x[i, idx[i, j]]

The kernel reads a dim-0 table straight from global memory, so M is free
(M * N < 2^31), and stages a dim-1 row in shared memory, so N <= 58,112
there. No path of the
model calls it: ``chip_smoke.py`` drives it on the probe's own cases,
beside ``torch.gather`` as the library yardstick.
"""

from __future__ import annotations

import torch

from graspbalance_tpu_torch import _build

SMEM_BYTES = 232448  # shared memory one block may use on the H100 (227 KB)


def _check(x: torch.Tensor, idx: torch.Tensor, dim: int) -> None:
    if x.ndim != 2 or idx.shape != x.shape:
        raise ValueError(f"need x (M, N) and idx of the same shape, got {tuple(x.shape)}, {tuple(idx.shape)}")
    if dim not in (0, 1):
        raise ValueError(f"dim must be 0 or 1, got {dim}")


def table_gather_plain(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """Plain PyTorch version, by advanced indexing."""
    _check(x, idx, dim)
    m, n = x.shape
    idx = idx.long()
    if dim == 0:
        return x[idx, torch.arange(n, device=x.device)]
    return x[torch.arange(m, device=x.device).unsqueeze(1), idx]


def table_gather(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """x (M, N) f32, idx (M, N) int32 -> (M, N) f32 (see the module docstring)."""
    _check(x, idx, dim)
    if x.device.type == "cpu":
        return table_gather_plain(x, idx, dim)
    _build.require_cuda("x", x, torch.float32, 2)
    _build.require_cuda("idx", idx, torch.int32, 2)
    m, n = x.shape
    if m * n >= 2**31:
        raise ValueError(f"the kernel indexes M * N < 2^31 elements, got {(m, n)}")
    if dim == 1 and 4 * n > SMEM_BYTES:
        raise ValueError(f"dim 1 stages a whole table row in shared memory: N={n} is too long")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.gb_table_gather(x.data_ptr(), idx.data_ptr(), out.data_ptr(), m, n, dim, _build.stream_of(x))
    _build.check(err, "table_gather")
    return out
