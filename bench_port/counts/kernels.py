"""Operations and bytes of single kernels at a call's shapes: each input
byte read once and each output byte written once, whatever the kernel
reads again, and the products the algorithm needs.

``widthmlp``: the width head's fused MLPs (``ops/widthmlp.py:width_mlp_fused_rot``),
per scale 3 -> C1 -> C2 -> C3 on B x S x H x K rows and the max over K, with
the rotation and center folded into layer 0 per seed.
"""

from __future__ import annotations

F32 = 4


def widthmlp(b: int, s: int, r: int, h: int, k: int, widths=(64, 128, 256)) -> tuple[float, float]:
    """(operations, bytes) of one call on grouped (b, s, r, h, k, 3)."""
    c1, c2, c3 = widths
    rows = b * s * h * k
    ops = r * 2.0 * rows * (3 * c1 + c1 * c2 + c2 * c3)
    ops += 2.0 * b * s * 3 * 3 * r * c1 + 2.0 * b * s * 3 * r * c1  # the per-seed fold of layer 0
    weights = r * ((3 + 1) * c1 + (c1 + 1) * c2 + (c2 + 1) * c3)
    nbytes = F32 * (b * s * r * h * k * 3 + b * s * (3 + 9) + weights + b * s * h * r * c3)
    return ops, float(nbytes)


def scatter_add(b: int, r: int, c: int, n: int) -> tuple[float, float]:
    """(operations, bytes) of the gather's backward (``ops/scatter.py:scatter_add``):
    cotangents (b, r, c) float32 summed by their int32 row index into
    (b, n, c)."""
    return float(b * r * c), float(F32 * (b * r * c + b * r + b * n * c))


def roofline_ms(ops: float, nbytes: float, peak_flops: float, peak_bytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take, and whether the operations
    or the bytes bind it."""
    t_ops, t_bytes = ops / peak_flops * 1e3, nbytes / peak_bytes * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
