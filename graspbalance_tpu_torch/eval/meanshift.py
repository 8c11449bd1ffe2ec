"""Gaussian mean-shift clustering, fixed shape (port of
graspbalance_tpu/eval/meanshift.py), batched over a leading axis.

  1. distance-proportional seed selection among foreground points: masked
     categorical draws, ``num_seeds`` of them;
  2. Gaussian-kernel hill climbing, ``max_iters`` steps;
  3. connected components of the converged seeds under ``epsilon``; each
     seed's component is the lowest seed index in it;
  4. every foreground point takes its nearest seed's component; components
     with fewer than ``min_cluster_size`` points are dropped and the others
     are numbered 1..K in seed order. Background is 0.

Randomness: the JAX package draws ``jax.random.categorical``, which is
``argmax(gumbel + logits)``. The port takes that Gumbel noise as a tensor,
``gumbel`` (B, 1 + num_seeds, m) with m the subsampled point count: row 0
draws the first seed, row 1 + t the draw of scan step t (the last row's draw
is made and unused, as in the JAX scan). ``gumbel_noise`` draws it from a
``torch.Generator``; a test can pass the JAX package's own draws instead.
"""

from __future__ import annotations

import torch


def subsampled_count(n: int, subsample_factor: int = 5) -> int:
    """m: the number of points mean shift sees, every subsample_factor-th."""
    return len(range(0, n, subsample_factor))


def gumbel_noise(
    shape: tuple[int, ...], generator: torch.Generator, device
) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform in [tiny, 1), drawn
    from ``generator`` (which must live on ``device``)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def _norm3(d: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(d*d)) over the last axis (size 3), in the JAX order."""
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])


def mean_shift_cluster(
    points: torch.Tensor,
    fg_mask: torch.Tensor,
    gumbel: torch.Tensor,
    *,
    num_seeds: int = 50,
    max_iters: int = 10,
    epsilon: float = 0.05,
    sigma: float = 0.02,
    subsample_factor: int = 5,
    min_cluster_size: int = 10,
):
    """points (B, N, 3) predicted centers; fg_mask (B, N) bool; gumbel
    (B, 1 + num_seeds, m) noise (see the module docstring).

    Returns (labels (B, N) int32 with 0 = background / 1..K = instances,
    centers (B, num_seeds, 3) f32, center_valid (B, num_seeds) bool)."""
    b, n, _ = points.shape
    s = num_seeds
    x = points[:, ::subsample_factor]
    xm = fg_mask[:, ::subsample_factor]
    m = x.shape[1]
    if gumbel.shape != (b, 1 + s, m):
        raise ValueError(f"gumbel must be (B, 1 + num_seeds, m) = {(b, 1 + s, m)}, got {tuple(gumbel.shape)}")
    dev = points.device

    # -- 1. smart seeds (distance-proportional)
    w = torch.where(xm, 1.0, 0.0)
    i = torch.argmax(gumbel[:, 0] + torch.log(w + 1e-20), dim=1)  # (B,)
    min_d = torch.full((b, m), 1e9, device=dev)
    seed_idx = []
    for t in range(s):
        seed_idx.append(i)
        xi = x.gather(1, i.view(b, 1, 1).expand(b, 1, 3))
        min_d = torch.minimum(min_d, _norm3(x - xi))
        w = torch.where(xm, min_d, 0.0)
        i = torch.argmax(gumbel[:, 1 + t] + torch.log(w + 1e-20), dim=1)
    seed_idx = torch.stack(seed_idx, dim=1)  # (B, S)
    z = x.gather(1, seed_idx.unsqueeze(-1).expand(b, s, 3))

    # -- 2. hill climbing
    inv2s2 = 0.5 / (sigma * sigma)
    xmf = xm.to(points.dtype).unsqueeze(1)  # (B, 1, m)
    for _ in range(max_iters):
        d = z.unsqueeze(2) - x.unsqueeze(1)  # (B, S, m, 3)
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        wk = torch.exp(-inv2s2 * d2) * xmf
        q = wk / torch.clamp(wk.sum(dim=2, keepdim=True), min=1e-20)
        z = q @ x

    # -- 3. connected components over seeds: transitive closure of the
    # epsilon graph by repeated squaring (exact: the counts are small
    # integers), then each seed's lowest reachable index
    adj = _norm3(z.unsqueeze(2) - z.unsqueeze(1)) <= epsilon  # (B, S, S), reflexive
    reach = adj.to(torch.float32)
    hops = 1
    while hops < s:
        reach = ((reach @ reach) > 0).to(torch.float32)
        hops *= 2
    comp = torch.argmax(reach, dim=2)  # first reachable seed = the component's lowest index

    # -- 4. per-point labels + small-cluster filtering
    nearest = torch.argmin(_norm3(points.unsqueeze(2) - z.unsqueeze(1)), dim=2)  # (B, N)
    point_comp = comp.gather(1, nearest)
    comp_sizes = torch.zeros((b, s), dtype=torch.int64, device=dev).scatter_add_(
        1, point_comp, fg_mask.to(torch.int64)
    )
    is_rep = comp == torch.arange(s, device=dev)
    keep = is_rep & (comp_sizes >= min_cluster_size)
    new_id = torch.cumsum(keep.to(torch.int32), dim=1)
    label_of_comp = torch.where(keep, new_id, 0)
    labels = torch.where(fg_mask, label_of_comp.gather(1, point_comp), 0).to(torch.int32)

    # cluster centers: mean of the converged seeds of each component
    onehot = (comp.unsqueeze(2) == torch.arange(s, device=dev)).to(z.dtype)  # (B, seed, comp)
    sums = onehot.transpose(1, 2) @ z
    cnts = onehot.sum(dim=1)
    centers = sums / torch.clamp(cnts, min=1.0).unsqueeze(-1)
    return labels, centers, keep
