"""Furthest point sampling (port of graspbalance_tpu/ops/fps.py).

Semantics of the reference kernel: ``idx[0] = 0``; greedy max-min over
squared distance with a running buffer initialised to 1e10; points with
``|p|^2 <= 1e-3`` (near-origin padding) are never selected; ties go to the
lowest index.

``furthest_point_sample_masked`` restricts the selection to per-row valid
subsets (OBS's per-object FPS): the seed is each row's first valid index (0
for a row with none), and invalid points are never selected.

``furthest_point_sample`` and ``furthest_point_sample_masked`` launch the
CUDA kernel (``csrc/fps.cu``, its masked mode for the latter) on a CUDA
tensor and run their plain versions on a CPU tensor. Every N takes a kernel,
picked by N: clouds of up to ``CLUSTER_MAX_POINTS`` = 65,536 points keep
their coordinates and distances in the registers of a thread-block cluster,
masked rows of up to ``MASKED_BLOCK_MAX_POINTS`` = 32,768 in one block's;
larger ones take the streaming mode (``gb_fps_stream``: running distances in
global memory, coordinates read through L2 every step, one grid-wide barrier
a step). Both give the plain versions' indices bit for bit.

``random_sample`` is the reference's other sampler: uniform draws without
replacement.
"""

from __future__ import annotations

import torch

from graspbalance_tpu_torch import _build

INIT_DIST = 1e10
ORIGIN_EPS = 1e-3
# the register-resident routes' limits on N, past which the streaming mode
# runs: the main kernel spreads a cloud over a cluster of up to 16 blocks of
# 128 threads with at most 32 points each, the masked kernel a row over one
# block of up to 1,024 threads with 32 points each
CLUSTER_MAX_POINTS = 16 * 128 * 32
MASKED_BLOCK_MAX_POINTS = 32 * 1024


def _check_xyz(xyz: torch.Tensor) -> None:
    if xyz.ndim != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be (B, N, 3), got {tuple(xyz.shape)}")


def initial_distances(xyz: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) -> (B, N) running distances before the first step: 1e10,
    or -1 for a near-origin point (-1 survives every min(dist, d >= 0), so
    such a point never wins)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return torch.where(x * x + y * y + z * z > ORIGIN_EPS, INIT_DIST, -1.0).float()


def _greedy(xyz: torch.Tensor, dist: torch.Tensor, seed: torch.Tensor, num_samples: int):
    """Greedy max-min selection from running distances ``dist`` (B, N),
    starting at ``seed`` (B, 1) int64, one tensor step per sample.

    The distance is written as ``dx*dx + dy*dy + dz*dz`` on coordinate
    planes, so its rounding is fixed and matches the kernel bit for bit."""
    b = xyz.shape[0]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    out = torch.zeros((b, num_samples), dtype=torch.int32, device=xyz.device)
    out[:, 0] = seed[:, 0].to(torch.int32)
    last = seed
    for j in range(1, num_samples):
        dx = x - x.gather(1, last)
        dy = y - y.gather(1, last)
        dz = z - z.gather(1, last)
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        last = torch.argmax(dist, dim=1, keepdim=True)  # first max: lowest index
        out[:, j] = last[:, 0].to(torch.int32)
    return out


def furthest_point_sample_plain(xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
    """(B, N, 3) -> (B, num_samples) int32, plain PyTorch version."""
    _check_xyz(xyz)
    xyz = xyz.float()
    seed = torch.zeros((xyz.shape[0], 1), dtype=torch.int64, device=xyz.device)
    return _greedy(xyz, initial_distances(xyz), seed, num_samples)


def masked_initial_distances(valid: torch.Tensor) -> torch.Tensor:
    """(S, N) bool -> (S, N) running distances before the first step: 1e10
    for a valid point, -1 for an invalid one (never selected)."""
    return torch.where(valid, INIT_DIST, -1.0).float()


def furthest_point_sample_masked_plain(xyz: torch.Tensor, valid: torch.Tensor, num_samples: int) -> torch.Tensor:
    """(S, N, 3), (S, N) bool -> (S, num_samples) int32, plain PyTorch
    version of the masked FPS. It selects every slot."""
    _check_xyz(xyz)
    seed = torch.argmax(valid.to(torch.int32), dim=1, keepdim=True)  # first valid, else 0
    return _greedy(xyz.float(), masked_initial_distances(valid), seed, num_samples)


def _check_sizes(n: int, num_samples: int) -> None:
    if n < 1 or 3 * n >= 2**31:
        raise ValueError(f"the FPS kernel takes 1 <= N < 2^31 / 3 points (int32 offsets), got {n}")
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")


def _stream(planes, dist, seed, needed, out, counter: str) -> None:
    """The streaming mode on (B, 3, N) ``planes`` and (B, N) initial
    distances ``dist`` (overwritten); ``seed`` (B,) int32 or None (index 0),
    ``needed`` a device int32 or None (every slot)."""
    b = planes.shape[0]
    lib = _build.library()
    slots = torch.empty((lib.gb_fps_stream_slots(b), 2), dtype=torch.int32, device=planes.device)
    with torch.cuda.device(planes.device):
        err = lib.gb_fps_stream(
            planes.data_ptr(), dist.data_ptr(), None if seed is None else seed.data_ptr(),
            None if needed is None else needed.data_ptr(), out.data_ptr(), slots.data_ptr(),
            b, planes.shape[2], out.shape[1], _build.stream_of(planes),
        )
    _build.check(err, counter)


def random_sample(xyz: torch.Tensor, num_samples: int, generator: torch.Generator) -> torch.Tensor:
    """Uniform random subsampling without replacement: (B, N, 3) ->
    (B, num_samples) int32, each row the first ``num_samples`` of a random
    permutation drawn from ``generator`` (a CPU generator gives the same
    indices on any device). The JAX package draws from ``jax.random``; the
    two agree in distribution, not draw for draw."""
    _check_xyz(xyz)
    b, n, _ = xyz.shape
    if not 1 <= num_samples <= n:
        raise ValueError(f"num_samples must be in 1..{n}, got {num_samples}")
    rows = [torch.randperm(n, generator=generator)[:num_samples] for _ in range(b)]
    return torch.stack(rows).to(device=xyz.device, dtype=torch.int32)


def furthest_point_sample(xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Greedy FPS, (B, N, 3) f32 -> (B, num_samples) int32 indices."""
    _check_xyz(xyz)
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, num_samples)
    _build.require_cuda("xyz", xyz, torch.float32, 3)
    b, n, _ = xyz.shape
    _check_sizes(n, num_samples)
    planes = xyz.transpose(1, 2).contiguous()  # (B, 3, N)
    dist0 = initial_distances(xyz).contiguous()
    out = torch.empty((b, num_samples), dtype=torch.int32, device=xyz.device)
    if n > CLUSTER_MAX_POINTS:
        _stream(planes, dist0, None, None, out, "fps")
        return out
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        err = lib.gb_fps(
            planes.data_ptr(), dist0.data_ptr(), out.data_ptr(), b, n, num_samples,
            _build.stream_of(xyz),
        )
    _build.check(err, "fps")
    return out


def furthest_point_sample_masked(
    xyz: torch.Tensor, valid: torch.Tensor, num_samples: int, *, max_needed=None
) -> torch.Tensor:
    """Batched greedy FPS restricted to per-row valid subsets.

    xyz (S, N, 3) f32, valid (S, N) bool -> (S, num_samples) int32; seed =
    first valid index per row (0 for a row with none). ``max_needed`` (an
    int32 scalar tensor on xyz's device, or an int): the caller reads only
    the first max_needed slots per row; the kernel stops there and writes 0
    past it, without a host sync."""
    _check_xyz(xyz)
    if valid.shape != xyz.shape[:2]:
        raise ValueError(f"valid must be (S, N) = {tuple(xyz.shape[:2])}, got {tuple(valid.shape)}")
    if xyz.device.type == "cpu":
        return furthest_point_sample_masked_plain(xyz, valid, num_samples)
    _build.require_cuda("xyz", xyz, torch.float32, 3)
    _build.require_cuda("valid", valid, torch.bool, 2)
    s, n, _ = xyz.shape
    _check_sizes(n, num_samples)
    if max_needed is None:
        max_needed = num_samples
    needed = torch.as_tensor(max_needed, dtype=torch.int32, device=xyz.device).reshape(1)
    out = torch.empty((s, num_samples), dtype=torch.int32, device=xyz.device)
    if n > MASKED_BLOCK_MAX_POINTS:
        seed = torch.argmax(valid.to(torch.int32), dim=1).to(torch.int32)  # first valid, else 0
        planes = xyz.transpose(1, 2).contiguous()
        _stream(planes, masked_initial_distances(valid).contiguous(), seed, needed, out, "fps_masked")
        return out
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        err = lib.gb_fps_masked(
            xyz.data_ptr(), valid.data_ptr(), needed.data_ptr(), out.data_ptr(),
            s, n, num_samples, _build.stream_of(xyz),
        )
    _build.check(err, "fps_masked")
    return out
