"""Fused per-neighbourhood MLP + reduction over K, the backbone's group + MLP
+ max in eval mode (port of graspbalance_tpu/ops/pallas/mlpmax_kernel.py:
mlp_max_fused).

``mlp_max_fused`` launches the CUDA kernel (``csrc/mlpmax.cu``) on CUDA
tensors and runs ``mlp_max_fused_plain`` on CPU tensors.

``parts`` are the (B, N, K, C_p) channel blocks whose concatenation is the
grouped input (concat semantics: the concatenation itself is never built);
``weights`` is ``((W0_parts, b0), (W1, b1), ...)`` with ``W0_parts`` one
(C_p, C_0) row block of layer 0 per part and every ``W`` laid out (in, out),
BatchNorm already folded in (eval only; the kernel has no backward). Every
layer is dense + ReLU; the result is the max, mean or sum over K,
(B, N, C_last) float32.
"""

from __future__ import annotations

import ctypes

import torch

from graspbalance_tpu_torch import _build

REDUCTIONS = ("max", "mean", "sum")
# what the kernel is built for
KERNEL_K = (8, 16, 32, 64)
KERNEL_MAX_PARTS = 2
KERNEL_MAX_LAYERS = 4
KERNEL_MAX_WIDTH = 256  # every output width a multiple of 32 up to this


def _check(parts, weights, reduction):
    if reduction not in REDUCTIONS:
        raise ValueError(f"reduction must be one of {REDUCTIONS}, got {reduction!r}")
    if not parts or any(p.ndim != 4 or p.shape[:3] != parts[0].shape[:3] for p in parts):
        raise ValueError(f"parts must share (B, N, K), got {[tuple(p.shape) for p in parts]}")
    w0_parts = weights[0][0]
    if len(w0_parts) != len(parts) or any(w.shape[0] != p.shape[-1] for w, p in zip(w0_parts, parts)):
        raise ValueError(
            f"need one layer-0 row block per part with the part's channels: parts "
            f"{[p.shape[-1] for p in parts]}, blocks {[tuple(w.shape) for w in w0_parts]}"
        )
    c_in = None  # layer 0 reads the parts, checked above
    for i, (ws, bias) in enumerate([(w0_parts, weights[0][1]), *(((w,), b) for w, b in weights[1:])]):
        c_out = ws[0].shape[1]
        if any(w.shape[1] != c_out or c_in not in (None, w.shape[0]) for w in ws) or bias.shape != (c_out,):
            raise ValueError(
                f"layer {i}: weights {[tuple(w.shape) for w in ws]} and bias {tuple(bias.shape)} "
                f"do not take {c_in or 'the parts'} channels to {c_out}"
            )
        c_in = c_out


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "max":
        return x.amax(dim=2)
    s = x.sum(dim=2)
    return s * (1.0 / x.shape[2]) if reduction == "mean" else s


def mlp_max_fused_plain(parts, weights, *, reduction: str = "max", max_rows: int = 1 << 18) -> torch.Tensor:
    """Plain PyTorch version: per chunk of points, layer 0 as the sum of the
    parts' matmuls, the other layers as matmuls, then the reduction, so that
    the (rows, C) activations stay under ``max_rows`` rows."""
    _check(parts, weights, reduction)
    (w0_parts, b0), rest = weights[0], weights[1:]
    b, n, k, _ = parts[0].shape
    chunk = max(1, max_rows // (b * k))
    outs = []
    for lo in range(0, n, chunk):
        x = None
        for p, w in zip(parts, w0_parts):
            term = p[:, lo : lo + chunk].float() @ w.float()
            x = term if x is None else x + term
        x = torch.relu(x + b0.float())
        for w, bias in rest:
            x = torch.relu(x @ w.float() + bias.float())
        outs.append(_reduce(x, reduction))
    return torch.cat(outs, dim=1)


def mlp_max_fused(parts, weights, *, reduction: str = "max") -> torch.Tensor:
    """parts: (B, N, K, C_p) tensors; weights: ((W0_parts, b0), (W1, b1),
    ...). Returns (B, N, C_last) float32 reduced over K (see the module
    docstring)."""
    _check(parts, weights, reduction)
    if parts[0].device.type == "cpu":
        return mlp_max_fused_plain(parts, weights, reduction=reduction)
    for i, p in enumerate(parts):
        _build.require_cuda(f"parts[{i}]", p, torch.float32, 4)
    b, n, k, _ = parts[0].shape
    widths = [sum(p.shape[-1] for p in parts), weights[0][0][0].shape[1]]
    widths += [w.shape[1] for w, _ in weights[1:]]
    if (
        len(parts) > KERNEL_MAX_PARTS
        or len(weights) > KERNEL_MAX_LAYERS
        or k not in KERNEL_K
        or any(c % 32 or c > KERNEL_MAX_WIDTH for c in widths[1:])
    ):
        raise ValueError(
            f"the mlp-max kernel takes up to {KERNEL_MAX_PARTS} parts, {KERNEL_MAX_LAYERS} layers, "
            f"K in {KERNEL_K} and output widths that are multiples of 32 up to {KERNEL_MAX_WIDTH}; "
            f"got {len(parts)} parts, K={k}, widths {widths}"
        )
    (w0_parts, b0), rest = weights[0], weights[1:]
    ws = [torch.cat([w.float() for w in w0_parts], dim=0).contiguous()]
    ws += [w.float().contiguous() for w, _ in rest]
    bs = [bias.float().contiguous() for bias in (b0, *(bias for _, bias in rest))]
    for t in (*ws, *bs):
        if t.device != parts[0].device:
            raise ValueError(f"weights on {t.device}, parts on {parts[0].device}")
    ws = [w if w.data_ptr() % 16 == 0 else w.clone() for w in ws]  # the kernel copies 16-byte rows
    out = torch.empty((b, n, widths[-1]), dtype=torch.float32, device=parts[0].device)
    if out.numel() == 0:
        return out
    w_arr = (ctypes.c_void_p * len(ws))(*(t.data_ptr() for t in ws))
    b_arr = (ctypes.c_void_p * len(bs))(*(t.data_ptr() for t in bs))
    width_arr = (ctypes.c_int * len(widths))(*widths)
    pb = parts[1] if len(parts) > 1 else None
    lib = _build.library()
    with torch.cuda.device(out.device):
        err = lib.gb_mlpmax(
            parts[0].data_ptr(), pb.data_ptr() if pb is not None else None,
            parts[0].shape[-1], pb.shape[-1] if pb is not None else 0,
            w_arr, b_arr, width_arr, len(ws), REDUCTIONS.index(reduction),
            out.data_ptr(), b, n, k, _build.stream_of(out),
        )
    _build.check(err, "mlpmax")
    return out
