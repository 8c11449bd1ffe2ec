"""The class-plane selection kernel's arithmetic, through its plain twin, on
the CPU.

``ops/select.py:combo_masks`` is the kernel's membership table and
``select_twin`` its walk over a row, step for step: 16 class bytes a lane
and 512 a warp step from the 16-byte boundary below the row's start, the
bytes outside the row masked to 63 and values above 63 made 63, the points
in the cover of the open combos; a step with few of them takes them one at
a time, a step with more goes through two 8-point sums in 4-bit fields per
combo widened to 8-bit and then 16-bit fields, the inclusive scan over 32
lanes, each open combo's slots from a lane's first slot in index order and
the first hit from the lowest lane with one; then the padding. These
tests hold the table to the class rule for every radii x depths the kernel
takes, and the twin to ``multicyl_select_plain`` at row lengths around the
loads and the step, at every head offset and at k = 1, 64 and 100 (past a
warp's 32), on rows that fill every combo in the first step (the scan's
fields at their largest), rows with no hit, with fewer hits than k, with
hits only at the end, sparse (one point at a time) and dense (packed), and
with values above 63.
"""

import numpy as np
import pytest
import torch

from graspbalance_tpu_torch.ops.select import (
    CLASSES,
    MAX_COMBOS,
    combo_masks,
    field_shift,
    field_word,
    multicyl_select_plain,
    select_twin,
)
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

# every radii x depths the kernel takes
SHAPES = [(r, h) for r in range(1, 8) for h in range(1, 8) if r * h <= MAX_COMBOS]
# the shapes the twin runs at, one per head offset in turn
TWIN_SHAPES = [(4, 4), (2, 7), (7, 2), (3, 5), (1, 1)]


def test_combo_masks_follow_the_class_rule():
    v = np.arange(CLASSES)
    rc, hc = v >> 3, v & 7
    assert len(SHAPES) == 30
    for n_r, n_h in SHAPES:
        masks = combo_masks(n_r, n_h)
        assert masks.shape == (CLASSES,)
        for ri in range(n_r):
            for hi in range(n_h):
                c = ri * n_h + hi
                np.testing.assert_array_equal((masks >> c) & 1, (rc <= ri) & (hc <= hi))
        assert not np.any(masks >> (n_r * n_h))
        assert masks[63] == 0


def test_fields_cover_every_combo_once():
    assert sorted((field_word(c), field_shift(c)) for c in range(MAX_COMBOS)) == [
        (w, s) for w in range(8) for s in (0, 16)
    ]


def _rows(rng, n):
    """One row of each kind, (rows, n) uint8."""
    mixed = rng.integers(0, 5, n) * 8 + rng.integers(0, 5, n)
    mixed[rng.random(n) < 0.5] = 63
    last = np.full(n, 63)
    last[-3:] = 0
    sparse = np.full(n, 63)
    hit = rng.random(n) < 0.02
    sparse[hit] = rng.integers(0, CLASSES, int(hit.sum()))
    return np.stack([
        mixed,
        np.full(n, 63),  # no hit
        np.zeros(n, int),  # every point hits every combo
        last,  # fewer hits than k, at the end
        rng.integers(0, 256, n),  # values above 63 too
        sparse,
        np.sort(rng.integers(0, CLASSES, n))[::-1],  # the largest classes first
    ]).astype(np.uint8)


@pytest.mark.parametrize("k", [1, 64, 100])
@pytest.mark.parametrize("n", [1, 15, 17, 511, 513, 3001])
def test_twin_matches_plain(n, k):
    rng = np.random.default_rng(n * 1000 + k)
    cls = _rows(rng, n)
    for lead in range(16):
        n_r, n_h = TWIN_SHAPES[lead % len(TWIN_SHAPES)]
        got = select_twin(cls, n_r, n_h, k, lead=lead)
        want = multicyl_select_plain(torch.from_numpy(cls), n_r, n_h, k)
        assert torch.equal(got, want), f"head offset {lead}, {n_r}x{n_h}: {int((got != want).sum())} slots differ"
