"""Fused width-grouping scale MLPs, then a max over K (port of
graspbalance_tpu/ops/pallas/widthmlp_kernel.py), in two forms:

  ``width_mlp_fused_rot`` (width_mlp_fused_rot, the default eval path): raw
  neighbour coordinates, seed-major, with the gripper rotation and the
  center subtraction folded into layer 0 per seed:
  ``((p - c) @ rot) @ W0 + b0 == p @ (rot @ W0) + (b0 - c @ (rot @ W0))``;
  ``width_mlp_fused`` (width_mlp_fused, the head's ``impl='fused_pallas'``):
  coordinates already in the gripper frame, scale-major, as the cylinder
  query's ``emit_rel`` gives them.

Each launches its entry point of the CUDA kernel (``csrc/widthmlp.cu``) on
CUDA tensors and runs its ``*_plain`` version on CPU tensors. The kernel
runs layers 1 and 2 on the tensor cores in 3xTF32 (each operand split into
a TF32 high part and a TF32 residual, three products summed in f32): its
results stay within ~1e-6 of the plain f32 version, not bit-equal to it.
It takes inputs whose data pointers are 16-byte aligned, as a freshly
allocated tensor's are, and raises on others.

``weights`` is one tuple per scale of ``((W0, b0), (W1, b1), (W2, b2))``
with ``W`` laid out (in, out) and BatchNorm already folded in (eval only).
"""

from __future__ import annotations

import torch

from graspbalance_tpu_torch import _build

# the only widths the kernel is built for: K neighbours, then 3 -> C1 -> C2 -> C3
KERNEL_K, KERNEL_WIDTHS = 64, (64, 128, 256)


def fold_layer0(centers: torch.Tensor, rot: torch.Tensor, weights) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-seed layer-0 weights and biases of all scales, concatenated along
    the output axis: w0_eff (B, S, 3, R*C1) = rot @ W0_cat and
    b0_eff (B, S, R*C1) = b0_cat - c @ w0_eff. Broadcast products and sums,
    no matmul, so nothing here depends on a library's TF32 setting."""
    w0_cat = torch.cat([w[0][0] for w in weights], dim=1).float()  # (3, R*C1)
    b0_cat = torch.cat([w[0][1] for w in weights]).float()  # (R*C1,)
    w0_eff = (rot.float().unsqueeze(-1) * w0_cat).sum(dim=-2)  # (B, S, 3, R*C1)
    b0_eff = b0_cat - (centers.float().unsqueeze(-1) * w0_eff).sum(dim=-2)
    return w0_eff.contiguous(), b0_eff.contiguous()


def _check_kernel_widths(k: int, weights) -> None:
    widths = tuple(layer[0].shape[1] for layer in weights[0])
    if k != KERNEL_K or widths != KERNEL_WIDTHS or any(len(w) != 3 for w in weights):
        raise ValueError(
            f"the width-MLP kernel takes K={KERNEL_K} and widths {KERNEL_WIDTHS}, "
            f"got K={k} and widths {widths}"
        )


def _stacked_tail(weights, device):
    """Layers 1 and 2 of every scale, stacked: (w1, b1, w2, b2), each
    contiguous float32 on ``device``."""
    out = tuple(
        torch.stack([w[li][part] for w in weights]).float().contiguous()
        for li in (1, 2) for part in (0, 1)
    )
    for t in out:
        if t.device != device:
            raise ValueError(f"weights are on {t.device}, the inputs on {device}")
    return out


def _check(grouped, centers, rot, weights):
    if grouped.ndim != 6 or grouped.shape[-1] != 3:
        raise ValueError(f"grouped must be (B, S, R, H, K, 3), got {tuple(grouped.shape)}")
    b, s, r = grouped.shape[:3]
    if centers.shape != (b, s, 3) or rot.shape != (b, s, 3, 3):
        raise ValueError(
            f"need centers (B, S, 3) and rot (B, S, 3, 3) for grouped "
            f"{tuple(grouped.shape)}; got {tuple(centers.shape)}, {tuple(rot.shape)}"
        )
    if len(weights) != r:
        raise ValueError(f"need one weight list per scale ({r}), got {len(weights)}")


def width_mlp_fused_rot_plain(
    grouped: torch.Tensor,
    centers: torch.Tensor,
    rot: torch.Tensor,
    weights,
    *,
    seed_chunk: int = 128,
) -> torch.Tensor:
    """Plain PyTorch version: grouped (B, S, R, H, K, 3) raw neighbour
    coordinates -> (B, S, H, R*C_last). Runs over chunks of seeds so that
    the last layer's (rows, C_last) activations stay bounded."""
    _check(grouped, centers, rot, weights)
    w0_eff, b0_eff = fold_layer0(centers, rot, weights)
    c1 = weights[0][0][0].shape[1]
    outs = []
    for lo in range(0, grouped.shape[1], seed_chunk):
        hi = lo + seed_chunk
        per_scale = []
        for ri, layers in enumerate(weights):
            w0 = w0_eff[:, lo:hi, :, ri * c1 : (ri + 1) * c1]  # (B, s, 3, C1)
            b0 = b0_eff[:, lo:hi, ri * c1 : (ri + 1) * c1]  # (B, s, C1)
            x = grouped[:, lo:hi, ri].float()  # (B, s, H, K, 3)
            x = torch.relu(
                torch.einsum("bshkj,bsjc->bshkc", x, w0) + b0[:, :, None, None, :]
            )
            for w, bias in layers[1:]:
                x = torch.relu(x @ w.float() + bias.float())
            per_scale.append(x.amax(dim=3))  # (B, s, H, C_last)
        outs.append(torch.cat(per_scale, dim=-1))
    return torch.cat(outs, dim=1)


def width_mlp_fused_rot(grouped: torch.Tensor, centers: torch.Tensor, rot: torch.Tensor, weights) -> torch.Tensor:
    """Fused width MLPs: grouped (B, S, R, H, K, 3) raw neighbour coordinates,
    centers (B, S, 3), rot (B, S, 3, 3) -> (B, S, H, R*C_last) float32."""
    _check(grouped, centers, rot, weights)
    if grouped.device.type == "cpu":
        return width_mlp_fused_rot_plain(grouped, centers, rot, weights)
    _build.require_cuda("grouped", grouped, torch.float32, 6)
    b, s, r, h, k, _ = grouped.shape
    _check_kernel_widths(k, weights)
    w0_eff, b0_eff = fold_layer0(centers, rot, weights)
    if w0_eff.device != grouped.device:
        raise ValueError(f"w0_eff is on {w0_eff.device}, grouped on {grouped.device}")
    w1, b1, w2, b2 = _stacked_tail(weights, grouped.device)  # (R, C1, C2), (R, C2), ...
    out = torch.empty((b, s, h, r * KERNEL_WIDTHS[-1]), dtype=torch.float32, device=grouped.device)
    lib = _build.library()
    with torch.cuda.device(grouped.device):
        err = lib.gb_widthmlp(
            grouped.data_ptr(), w0_eff.data_ptr(), b0_eff.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            b, s, r, h, _build.stream_of(grouped),
        )
    _build.check(err, "widthmlp")
    return out


def _check_rel(rel, weights):
    if rel.ndim != 6 or rel.shape[-1] != 3:
        raise ValueError(f"rel must be (B, R, H, S, K, 3), got {tuple(rel.shape)}")
    if len(weights) != rel.shape[1]:
        raise ValueError(f"need one weight list per scale ({rel.shape[1]}), got {len(weights)}")


def width_mlp_fused_plain(rel: torch.Tensor, weights, *, seed_chunk: int = 128) -> torch.Tensor:
    """Plain PyTorch version: rel (B, R, H, S, K, 3) gripper-frame neighbour
    coordinates -> (B, H, S, R*C_last). Runs over chunks of seeds so that
    the last layer's (rows, C_last) activations stay bounded."""
    _check_rel(rel, weights)
    outs = []
    for lo in range(0, rel.shape[3], seed_chunk):
        per_scale = []
        for ri, layers in enumerate(weights):
            x = rel[:, ri, :, lo : lo + seed_chunk].float()  # (B, H, s, K, 3)
            for w, bias in layers:
                x = torch.relu(x @ w.float() + bias.float())
            per_scale.append(x.amax(dim=3))  # (B, H, s, C_last)
        outs.append(torch.cat(per_scale, dim=-1))
    return torch.cat(outs, dim=2)


def width_mlp_fused(rel: torch.Tensor, weights) -> torch.Tensor:
    """Fused width MLPs on gripper-frame coordinates: rel (B, R, H, S, K, 3)
    -> (B, H, S, R*C_last) float32."""
    _check_rel(rel, weights)
    if rel.device.type == "cpu":
        return width_mlp_fused_plain(rel, weights)
    _build.require_cuda("rel", rel, torch.float32, 6)
    b, r, h, s, k, _ = rel.shape
    _check_kernel_widths(k, weights)
    w0 = torch.stack([w[0][0] for w in weights]).float().contiguous()  # (R, 3, C1)
    b0 = torch.stack([w[0][1] for w in weights]).float().contiguous()
    w1, b1, w2, b2 = _stacked_tail(weights, rel.device)
    if w0.device != rel.device:
        raise ValueError(f"w0 is on {w0.device}, rel on {rel.device}")
    out = torch.empty((b, h, s, r * KERNEL_WIDTHS[-1]), dtype=torch.float32, device=rel.device)
    lib = _build.library()
    with torch.cuda.device(rel.device):
        err = lib.gb_widthmlp_rel(
            rel.data_ptr(), w0.data_ptr(), b0.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            b, s, r, h, _build.stream_of(rel),
        )
    _build.check(err, "widthmlp_rel")
    return out
