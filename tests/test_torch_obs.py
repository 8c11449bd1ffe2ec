"""OBS's masked-FPS step count (graspbalance_tpu_torch.eval.obs.
max_needed_steps) against every scene's own quota, and OBS with the masked
FPS stopped at that count against the JAX package's object_balance_indices.

The masked-FPS kernel selects only the first ``max_needed`` slots of each
row and writes 0 past them; its plain version selects every slot, so a step
count that is too small shows only where the kernel's contract is emulated.
Here a stand-in with the kernel's contract (the plain selection, zeroed past
``max_needed``) takes the kernel wrapper's place on the CPU.

Tolerances: step counts and OBS indices exactly (integers).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspbalance_tpu.eval.obs import object_balance_indices as j_object_balance_indices
from graspbalance_tpu_torch.eval import obs
from graspbalance_tpu_torch.eval.obs import FPS_CAP, MAX_OBJECTS, max_needed_steps, object_balance_indices
from graspbalance_tpu_torch.ops.fps import furthest_point_sample_masked_plain
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)


def _present(counts, o=MAX_OBJECTS):
    """(B, O) bool: scene b has its first counts[b] slots present."""
    return torch.arange(o).unsqueeze(0) < torch.tensor(counts).unsqueeze(1)


def _slots_read(k: int, num_seed: int, fps_cap: int, o: int = MAX_OBJECTS) -> int:
    """The slots of one object's FPS row that a k-object scene reads: each
    object takes num_seed // k seeds and the last also the remainder, each
    seed at rank (p - start) % fps_cap; a zero-object scene reads none."""
    if k == 0:
        return 0
    quotas = [num_seed // k] * (k - 1) + [num_seed // k + num_seed % k]
    return max(min(q, fps_cap) for q in quotas)


@pytest.mark.parametrize("num_seed", [32, 64, 1024])
def test_max_needed_steps_covers_every_quota(num_seed):
    """Every batch of one or two scenes of 0..16 objects: the step count
    covers every scene's reads and is no larger than the largest of them
    (a batch of zero-object scenes only counts as k = O)."""
    for counts in itertools.chain(((k,) for k in range(MAX_OBJECTS + 1)),
                                  itertools.product(range(MAX_OBJECTS + 1), repeat=2)):
        needed = max_needed_steps(_present(counts), num_seed)
        assert needed.dtype == torch.int64 and needed.ndim == 0
        reads = [_slots_read(k, num_seed, FPS_CAP) for k in counts]
        if max(counts) == 0:
            reads = [_slots_read(MAX_OBJECTS, num_seed, FPS_CAP)]
        assert int(needed) == max(reads), (counts, int(needed), reads)


def test_max_needed_steps_is_not_the_sparsest_scenes_quota():
    """At num_seed=32 a 7-object scene's last object reads 32 // 7 + 32 % 7
    = 8 slots, more than the 6-object scene's 7."""
    assert int(max_needed_steps(_present((6, 7)), 32)) == 8
    assert int(max_needed_steps(_present((7, 6)), 32)) == 8


def _scenes(rng, counts, n=700):
    """Points (B, n, 3) and instance labels with counts[b] objects in scene
    b (plus background), every object non-empty."""
    pts = (rng.random((len(counts), n, 3)) - 0.5).astype(np.float32)
    labels = np.stack([np.arange(n) % (k + 1) for k in counts]).astype(np.int32)
    for row in labels:
        rng.shuffle(row)
    return pts, labels


@pytest.mark.parametrize("counts,num_seed", [((6, 7), 32), ((7, 6), 32), ((3, 5, 11), 64), ((0, 7), 32)])
def test_obs_with_the_kernels_step_count_matches_jax(monkeypatch, counts, num_seed):
    """OBS through a masked FPS that stops at max_needed_steps (the kernel's
    contract) gives the JAX package's indices."""
    calls = []

    def kernel_contract(xyz, valid, num_samples, *, max_needed):
        calls.append(int(max_needed))
        out = furthest_point_sample_masked_plain(xyz, valid, num_samples)
        out[:, int(max_needed):] = 0
        return out

    monkeypatch.setattr(obs, "furthest_point_sample_masked", kernel_contract)
    pts, labels = _scenes(np.random.default_rng(len(counts) + num_seed), counts)
    got = object_balance_indices(torch.from_numpy(pts), torch.from_numpy(labels), num_seed=num_seed)
    assert len(calls) == 1
    want = np.asarray(j_object_balance_indices(jnp.asarray(pts), jnp.asarray(labels), num_seed=num_seed))
    np.testing.assert_array_equal(got.numpy(), want)
    plain = object_balance_indices(torch.from_numpy(pts), torch.from_numpy(labels), num_seed=num_seed, plain=True)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
