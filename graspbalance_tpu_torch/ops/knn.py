"""k-nearest-neighbour ops (port of graspbalance_tpu/ops/knn.py): exact
``three_nn`` and exact ``knn``. Ties go to the lower index.

``knn`` at k <= 32 launches the CUDA kernel (``csrc/knn.cu``, a filtered
warp-select) on CUDA tensors and runs ``knn_plain`` on CPU tensors. At
k > 32 it runs ``knn_sorted`` on either device, as the JAX ``knn`` runs
``lax.top_k`` there and no kernel. Each ``knn`` call adds its queries x
references (B x Q x R, from the shapes) to the counter ``knn.pairs``
(``trace.py``).
"""

from __future__ import annotations

import torch

from graspbalance_tpu_torch import _build, trace

MAX_K = 32  # the kernel keeps a warp's best 32 keys, one a lane; larger k sorts


def _pairwise_d2(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(B, Q, 3), (B, R, 3) -> (B, Q, R) squared distances, written as
    ``(dx*dx + dy*dy) + dz*dz`` so that the rounding is fixed."""
    q = query.unsqueeze(2)  # (B, Q, 1, 3)
    r = ref.unsqueeze(1)  # (B, 1, R, 3)
    dx = q[..., 0] - r[..., 0]
    dy = q[..., 1] - r[..., 1]
    dz = q[..., 2] - r[..., 2]
    return dx * dx + dy * dy + dz * dz


def _argmin_passes(d2: torch.Tensor, k: int):
    """k argmin passes over (B, Q, R), each masking its winner; torch.min
    returns the first minimum, so ties resolve to the lower index."""
    idxs, vals = [], []
    cur = d2
    for _ in range(k):
        val, i = torch.min(cur, dim=-1, keepdim=True)
        idxs.append(i)
        vals.append(val)
        cur = cur.scatter(-1, i, float("inf"))
    dist = torch.sqrt(torch.clamp(torch.cat(vals, dim=-1), min=0.0))
    return dist, torch.cat(idxs, dim=-1).to(torch.int32)


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """unknown (B, N, 3), known (B, M, 3) -> dist (B, N, 3) euclidean,
    idx (B, N, 3) int32, nearest first."""
    return _argmin_passes(_pairwise_d2(unknown, known), 3)


def knn_plain(ref: torch.Tensor, query: torch.Tensor, k: int, *, chunk: int = 1024):
    """Plain PyTorch version of ``knn``: k argmin passes over chunks of
    queries (the (Q, R) distance plane of a whole cloud is not needed at
    once)."""
    outs = [
        _argmin_passes(_pairwise_d2(query[:, lo : lo + chunk], ref), k)
        for lo in range(0, query.shape[1], chunk)
    ]
    return torch.cat([o[0] for o in outs], dim=1), torch.cat([o[1] for o in outs], dim=1)


def knn_sorted(ref: torch.Tensor, query: torch.Tensor, k: int, *, chunk: int = 1024):
    """``knn`` for any k: a stable ascending sort of each query's distances,
    the first k kept (ties to the lower index, as ``lax.top_k`` keeps them),
    over chunks of queries."""
    dists, idxs = [], []
    for lo in range(0, query.shape[1], chunk):
        d2, i = torch.sort(_pairwise_d2(query[:, lo : lo + chunk], ref), dim=-1, stable=True)
        dists.append(torch.sqrt(torch.clamp(d2[..., :k], min=0.0)))
        idxs.append(i[..., :k].to(torch.int32))
    return torch.cat(dists, dim=1), torch.cat(idxs, dim=1)


def knn(ref: torch.Tensor, query: torch.Tensor, k: int, *, method: str = "exact"):
    """k nearest reference points per query: ref (B, R, 3), query (B, Q, 3)
    -> (dist (B, Q, k) euclidean ascending, idx (B, Q, k) int32).

    1 <= k <= R. k <= 32 runs the kernel on CUDA tensors; k > 32 runs
    ``knn_sorted`` on both devices. Only ``method='exact'`` is ported; the
    JAX package's TPU 'approx' mode has no counterpart here."""
    if method != "exact":
        raise ValueError(f"only method='exact' is ported, got {method!r}")
    b, r, _ = ref.shape
    if query.ndim != 3 or query.shape[0] != b or query.shape[-1] != 3 or ref.shape[-1] != 3:
        raise ValueError(f"need ref (B, R, 3), query (B, Q, 3); got {tuple(ref.shape)}, {tuple(query.shape)}")
    if not 1 <= k <= r:
        raise ValueError(f"knn takes 1 <= k <= R={r}, got k={k}")
    trace.count("knn.pairs", b * query.shape[1] * r)
    if k > MAX_K:
        return knn_sorted(ref, query, k)
    if ref.device.type == "cpu":
        return knn_plain(ref, query, k)
    return _launch(ref, query, k, None)


def _launch(ref, query, k, stats):
    _build.require_cuda("ref", ref, torch.float32, 3)
    _build.require_cuda("query", query, torch.float32, 3)
    b, r, _ = ref.shape
    q = query.shape[1]
    dist = torch.empty((b, q, k), dtype=torch.float32, device=ref.device)
    idx = torch.empty((b, q, k), dtype=torch.int32, device=ref.device)
    lib = _build.library()
    with torch.cuda.device(ref.device):
        err = lib.gb_knn(
            query.data_ptr(), ref.data_ptr(), dist.data_ptr(), idx.data_ptr(),
            0 if stats is None else stats.data_ptr(), b, q, r, k, _build.stream_of(ref),
        )
    _build.check(err, "knn")
    return dist, idx


def knn_round_stats(ref: torch.Tensor, query: torch.Tensor, k: int):
    """The kernel on CUDA tensors (1 <= k <= 32), also counting its work:
    (dist, idx) and (rounds after each query's first, rounds in which a
    candidate passed the threshold, insertions), summed over the queries."""
    if not 1 <= k <= min(MAX_K, ref.shape[1]):
        raise ValueError(f"the kNN kernel takes 1 <= k <= min(32, R), got k={k}")
    stats = torch.zeros(3, dtype=torch.int64, device=ref.device)
    out = _launch(ref, query, k, stats)
    return out, tuple(int(v) for v in stats.tolist())
