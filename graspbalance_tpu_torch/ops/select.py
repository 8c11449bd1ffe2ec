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

``combo_masks`` is the kernel's membership table (class value -> the combos
it hits) and ``select_twin`` a plain twin of the kernel's walk, step for
step in its packed-field arithmetic; the tests hold the twin to
``multicyl_select_plain``. Neither is on any path.
"""

from __future__ import annotations

import numpy as np
import torch

from graspbalance_tpu_torch import _build
from graspbalance_tpu_torch.ops.query import first_k_by_index

MAX_COMBOS = 16  # radii x depths the kernel keeps counts for
CLASSES = 64  # class values rc * 8 + hc; 63 (and any value above) hits no combo
STEP_CHUNKS = 32  # 16-byte chunks a warp step of the kernel loads, one a lane
SPARSE = 32  # a kernel step with at most this many covered points takes them one at a time


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


def combo_masks(n_r: int, n_h: int) -> np.ndarray:
    """The kernel's membership table: (64,) int64, entry v has bit c = ri *
    n_h + hi set iff class v hits combo (ri, hi), i.e. rc <= ri and hc <= hi
    for rc, hc = v >> 3, v & 7."""
    v = np.arange(CLASSES)
    rc, hc = v >> 3, v & 7
    masks = np.zeros(CLASSES, np.int64)
    for ri in range(n_r):
        for hi in range(n_h):
            masks |= ((rc <= ri) & (hc <= hi)).astype(np.int64) << (ri * n_h + hi)
    return masks


def field_word(c: int) -> int:
    """Combo c's packed count word in the kernel (csrc/select.cu:field_word)."""
    return 2 * (2 * (c >> 3) + (c & 1)) + ((c >> 1) & 1)


def field_shift(c: int) -> int:
    """Combo c's 16-bit field's shift within its word."""
    return 16 * ((c >> 2) & 1)


def _u32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint32)


def _hit_bits(w: np.ndarray, thr_r, thr_h) -> np.ndarray:
    """(..., 4) uint32 class words -> (...,) bit 4 i + b set iff byte b of
    word i hits the combo whose bytewise thresholds are thr_r, thr_h (ints,
    or arrays that broadcast against w)."""
    top = _u32(0x80808080)
    miss = ((w | top) - _u32(thr_r)) | (((w & _u32(0x07070707)) | top) - _u32(thr_h))
    hit = (~miss & top) >> _u32(7)
    nib = (hit * _u32(0x10204080)) >> _u32(28)
    return (nib << _u32(np.arange(0, 16, 4))).sum(axis=-1, dtype=np.uint32)


def select_twin(cls, n_r: int, n_h: int, nsample: int, *, lead: int = 0) -> torch.Tensor:
    """The kernel's walk over every row, in its arithmetic (csrc/select.cu:
    the cover of the open combos, the one-at-a-time path of a step with at
    most SPARSE covered points, the packed counts and their scan otherwise):
    (rows, N) uint8 -> (rows, n_r * n_h, nsample) int32, for rows that start
    ``lead`` bytes past a 16-byte boundary. The bytes around a row in its first and last
    chunks are 0, a class that hits every combo, so that a fault in their
    masking shows."""
    cls = np.asarray(cls, dtype=np.uint8)
    rows, n = cls.shape
    combos = n_r * n_h
    masks = combo_masks(n_r, n_h)
    fields = sum(((masks >> c) & 1) << (4 * c) for c in range(combos))  # 4-bit field per combo
    tab_lo, tab_hi = _u32(fields & 0xFFFFFFFF), _u32(fields >> 32)
    each = 0x01010101
    thr = [(((c // n_h) + 1) * 8 * each, ((c % n_h) + 1) * each) for c in range(combos)]
    thr_rh = [np.array([t[i] for t in thr], np.int64) for i in (0, 1)]  # (combos,) each
    n_chunks = (lead + n + 15) // 16
    steps = -(-n_chunks // STEP_CHUNKS)
    mem = np.zeros((rows, steps * STEP_CHUNKS * 16), np.uint8)
    mem[:, lead : lead + n] = cls
    words = mem.view("<u4").reshape(rows, steps, STEP_CHUNKS, 4)
    out = np.full((rows, combos, nsample), -1, np.int64)
    count = np.zeros((rows, combos), np.int64)
    first = np.zeros((rows, combos), np.int64)
    lanes = np.arange(STEP_CHUNKS)
    nib, halves = _u32(0x0F0F0F0F), _u32(0x00FF00FF)
    for step in range(steps):
        opened = count < nsample  # (rows, combos)
        if not opened.any():
            break
        base = 16 * (step * STEP_CHUNKS + lanes) - lead  # (32,) the index of each lane's first byte
        # bytes outside the row count as 63; values above 63 become 63
        b = words[:, step].copy().view(np.uint8).reshape(rows, STEP_CHUNKS, 16)
        idx = base[:, None] + np.arange(16)
        b[:, (idx < 0) | (idx >= n)] = 63
        w = b.view("<u4").reshape(rows, STEP_CHUNKS, 4).astype(np.uint32)
        big = (((w & _u32(0xC0C0C0C0)) | ((w & _u32(0x40404040)) << _u32(1))) & _u32(0x80808080)) >> _u32(7)
        w = (w & ~(big * _u32(0xFF))) | (big * _u32(63))
        # the points in the cover of the open combos (the largest open
        # radius x the largest open depth); a step with at most SPARSE of
        # them takes them one at a time, in index order
        cover = [np.where(opened, t, 0).max(axis=1)[:, None, None] for t in thr_rh]
        v = (w[..., np.arange(16) >> 2] >> _u32(8 * (np.arange(16) & 3))) & _u32(63)  # (rows, 32, 16)
        covered = (_hit_bits(w, *cover)[..., None] >> _u32(np.arange(16))) & _u32(1)
        n_cov = covered.sum(axis=(1, 2))
        for r in np.nonzero((n_cov > 0) & (n_cov <= SPARSE))[0]:
            for lane, j in zip(*np.nonzero(covered[r])):
                hit = (masks[v[r, lane, j]] >> np.arange(combos)) & 1 == 1
                for c in np.nonzero(hit & (count[r] < nsample))[0]:
                    out[r, c, count[r, c]] = base[lane] + j
                    if count[r, c] == 0:
                        first[r, c] = base[lane] + j
                    count[r, c] += 1
        dense = n_cov > SPARSE
        # 1. the lane's hits per combo, from its covered points: two 8-point
        # halves in 4-bit fields, widened to 8-bit, added, widened to 16-bit
        v = np.where(covered == 1, v, _u32(63))
        lo0, hi0 = tab_lo[v[..., :8]].sum(-1, dtype=np.uint32), tab_hi[v[..., :8]].sum(-1, dtype=np.uint32)
        lo1, hi1 = tab_lo[v[..., 8:]].sum(-1, dtype=np.uint32), tab_hi[v[..., 8:]].sum(-1, dtype=np.uint32)
        c8 = [(lo0 & nib) + (lo1 & nib), ((lo0 >> _u32(4)) & nib) + ((lo1 >> _u32(4)) & nib),
              (hi0 & nib) + (hi1 & nib), ((hi0 >> _u32(4)) & nib) + ((hi1 >> _u32(4)) & nib)]
        own = np.stack([f(x) for x in c8 for f in (lambda x: x & halves, lambda x: (x >> _u32(8)) & halves)], -1)
        # 2. the inclusive scan over lanes, as the shuffles give it
        inc = own.copy()
        off = 1
        while off < STEP_CHUNKS:
            up = inc.copy()
            up[:, off:] += inc[:, :-off]
            inc = up
            off *= 2
        tot = inc[:, -1]  # (rows, 8)
        # 3. the slots of each open combo's hits
        for c in range(combos):
            word, sh = field_word(c), _u32(field_shift(c))
            total = ((tot[:, word] >> sh) & _u32(0xFFFF)).astype(np.int64)
            active = dense & opened[:, c] & (total > 0)
            mine = ((own[..., word] >> sh) & _u32(0xFFFF)).astype(np.int64)
            slot = count[:, c, None] + ((inc[..., word] >> sh) & _u32(0xFFFF)).astype(np.int64) - mine
            walks = active[:, None] & (mine > 0) & (slot < nsample)
            hits = np.where(walks, _hit_bits(w, *thr[c]), 0).astype(np.int64)
            for j in range(16):
                hit = (hits >> j) & 1 == 1
                r, lane = np.nonzero(hit & (slot < nsample))
                out[r, c, slot[r, lane]] = base[lane] + j
                slot = slot + hit
            new = active & (count[:, c] == 0)
            r = np.nonzero(new)[0]
            src = np.argmax(mine[r] > 0, axis=1)
            low = hits[r, src]
            first[r, c] = base[src] + np.log2(low & -low).astype(np.int64)
            count[:, c] += np.where(active, total, 0)
    # padding: slots past the count repeat the first hit
    for r in range(rows):
        for c in range(combos):
            out[r, c, min(count[r, c], nsample):] = first[r, c]
    return torch.from_numpy(out.astype(np.int32))
