"""Operations and bytes of K9, the kNN kernel (``ops/knn.py``): 9
operations a query-reference pair (three differences, three products, two
sums and the comparison with the running threshold), the coordinates read
once and the distances and indices written once. K9 runs on the CUDA
cores, whose float32 peak is ``CUDA_CORE_FLOPS``, not the tensor cores'."""

from __future__ import annotations

F32 = 4
OPS_PER_PAIR = 9
CUDA_CORE_FLOPS = 67e12  # H100 SXM data sheet: 67 TFLOP/s float32 on the CUDA cores


def knn(b: int, q: int, r: int, k: int) -> tuple[float, float]:
    """(operations, bytes) of one call: ``b`` clouds of ``q`` queries among
    ``r`` references, ``k`` kept a query."""
    return float(OPS_PER_PAIR * b * q * r), float(F32 * (3 * b * (q + r) + 2 * b * q * k))
