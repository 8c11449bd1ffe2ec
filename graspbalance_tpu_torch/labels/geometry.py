"""Grasp view geometry and label thresholds (port of
graspbalance_tpu/labels/geometry.py, the part the forward, decode, label
matching and loss use)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from graspbalance_tpu_torch import trace

GRASP_MAX_WIDTH = 0.1
GRASP_MAX_TOLERANCE = 0.05
THRESH_GOOD = 0.7
THRESH_BAD = 0.1


@functools.lru_cache(maxsize=None)
def _grasp_views_np(n: int) -> np.ndarray:
    phi = (np.sqrt(5.0) - 1.0) / 2.0
    i = np.arange(n, dtype=np.float64)
    zi = (2.0 * i + 1.0) / n - 1.0
    r = np.sqrt(1.0 - zi * zi)
    xi = r * np.cos(2.0 * np.pi * i * phi)
    yi = r * np.sin(2.0 * np.pi * i * phi)
    return np.stack([xi, yi, zi], axis=-1).astype(np.float32)


def generate_grasp_views(n: int = 300, device=None) -> torch.Tensor:
    """Fibonacci-sphere template view directions, (n, 3) float32 unit
    vectors: z_i = (2i+1)/n - 1, azimuth 2*pi*i*phi (golden ratio conjugate).
    Computed in float64 and rounded once, as the JAX package does. The
    upload waits for the card (``trace.host_read`` site "views")."""
    views = torch.from_numpy(_grasp_views_np(n).copy())
    return trace.host_read("views", lambda: views.to(device))


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis of size 3, summed in a fixed order."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]).unsqueeze(-1)


def batch_viewpoint_params_to_matrix(towards: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Approach direction (..., 3) + in-plane angle (...) -> rotation (..., 3, 3).

    x-axis = normalised ``towards``; y-axis from the horizontal perpendicular
    (+y when ``towards`` is vertical); z = x cross y; then an in-plane
    rotation about x by ``angle``. The fallback axis's upload waits for the
    card (``trace.host_read`` site "fallback_axis")."""
    ax = towards
    zeros = torch.zeros_like(ax[..., 0])
    ay = torch.stack([-ax[..., 1], ax[..., 0], zeros], dim=-1)
    axis = functools.partial(torch.tensor, [0.0, 1.0, 0.0], dtype=ax.dtype, device=ax.device)
    fallback = trace.host_read("fallback_axis", axis)
    ay = torch.where(_norm3(ay) == 0, fallback, ay)
    ax = ax / _norm3(ax)
    ay = ay / _norm3(ay)
    az = torch.stack(
        [
            ax[..., 1] * ay[..., 2] - ax[..., 2] * ay[..., 1],
            ax[..., 2] * ay[..., 0] - ax[..., 0] * ay[..., 2],
            ax[..., 0] * ay[..., 1] - ax[..., 1] * ay[..., 0],
        ],
        dim=-1,
    )
    sin, cos = torch.sin(angle), torch.cos(angle)
    ones = torch.ones_like(cos)
    r1 = torch.stack(
        [ones, zeros, zeros, zeros, cos, -sin, zeros, sin, cos], dim=-1
    ).reshape(angle.shape + (3, 3))
    r2 = torch.stack([ax, ay, az], dim=-1)  # columns
    # r2 @ r1 as a broadcast sum: no library matmul, so no TF32 on the card
    return (r2.unsqueeze(-1) * r1.unsqueeze(-3)).sum(dim=-2)
