"""First-k-by-index selection of every cylinder combo from a class plane
(port of graspbalance_tpu/ops/pallas/select_kernel.py:multicyl_select).

``multicyl_select`` launches the CUDA kernel (``csrc/select.cu``) on CUDA
tensors and runs ``multicyl_select_plain`` on CPU tensors. Both take

  cls: (rows, N) uint8 class values ``rc * 8 + hc``, 63 for a point no
       combo takes (ops/query.py:class_plane builds them); the JAX package
       stores the same values as bfloat16;

and return (rows, n_r * n_h, nsample) int32, combos radius-major: for combo
(ri, hi) the first ``nsample`` points with ``rc <= ri and hc <= hi`` in
index order, slots past the hit count repeating the first hit, 0 where there
is none.
"""

from __future__ import annotations

import torch

from graspbalance_tpu_torch import _build
from graspbalance_tpu_torch.ops.query import first_k_by_index

MAX_COMBOS = 16  # radii x depths the kernel keeps counts for


def _check(cls: torch.Tensor, n_r: int, n_h: int, nsample: int) -> None:
    if cls.ndim != 2 or cls.dtype != torch.uint8:
        raise ValueError(f"cls must be a (rows, N) uint8 plane, got {tuple(cls.shape)} {cls.dtype}")
    if not (1 <= n_r <= 7 and 1 <= n_h <= 7):
        raise ValueError(f"the class encoding takes 1..7 radii and depths, got {n_r} x {n_h}")
    if nsample < 1:
        raise ValueError(f"nsample must be >= 1, got {nsample}")


def multicyl_select_plain(cls: torch.Tensor, n_r: int, n_h: int, nsample: int, *, chunk: int = 256) -> torch.Tensor:
    """Plain PyTorch version: decode each combo's hit mask and take its first
    ``nsample`` hits, over chunks of rows."""
    _check(cls, n_r, n_h, nsample)
    outs = []
    for lo in range(0, cls.shape[0], chunk):
        c = cls[lo : lo + chunk]
        rc, hc = c >> 3, c & 7
        outs.append(torch.stack(
            [first_k_by_index((rc <= ri) & (hc <= hi), nsample) for ri in range(n_r) for hi in range(n_h)],
            dim=1,
        ))
    return torch.cat(outs, dim=0)


def multicyl_select(cls: torch.Tensor, n_r: int, n_h: int, nsample: int) -> torch.Tensor:
    """(rows, N) uint8 class plane -> (rows, n_r * n_h, nsample) int32 (see
    the module docstring)."""
    _check(cls, n_r, n_h, nsample)
    if cls.device.type == "cpu":
        return multicyl_select_plain(cls, n_r, n_h, nsample)
    _build.require_cuda("cls", cls, torch.uint8, 2)
    if n_r * n_h > MAX_COMBOS:
        raise ValueError(f"the kernel takes up to {MAX_COMBOS} combos, got {n_r * n_h}")
    rows, n = cls.shape
    out = torch.empty((rows, n_r * n_h, nsample), dtype=torch.int32, device=cls.device)
    if rows == 0:
        return out
    if n == 0:
        return out.zero_()
    lib = _build.library()
    with torch.cuda.device(cls.device):
        err = lib.gb_select(cls.data_ptr(), out.data_ptr(), rows, n, n_r, n_h, nsample, _build.stream_of(cls))
    _build.check(err, "select")
    return out
