"""Fused frame preprocessing and SigLIP patch embedding.

Counterpart of `streamvln_tpu/ops/fused_patch_embed.py`. The two-stage
path (`ops/preprocess.py` then the tower's patch product) resizes the
uint8 frame to 384 with antialiased Keys cubic (a = -0.5), clips to
[0, 255], rescales, normalises (mean = std = 0.5) and patchifies. Here:

1. **The resize is two products.** Separable cubic interpolation with the
   antialias convention (the kernel stretched by the scale on downsize, as
   `jax.image.resize` and PIL do) is a [384, H] row matrix and a [384, W]
   column matrix (`resize_matrix`, numpy, a copy of the reference's), so
   `resized = R_h @ img @ R_w^T` per channel.
2. **The normalise folds into the patch weights.** `x / 127.5 - 1` is
   affine, so `(x / 127.5 - 1) @ W + b == x @ (W / 127.5) + (b - W.sum(0))`
   (`fold_normalize`): the resized pixels feed the embed product directly.

The clip of the cubic overshoot sits between the resize and the embed
product and cannot fold. Each product keeps its f32 sum
(`ops/linear.py::matmul_f32`) and rounds to the compute dtype after it,
in the reference's order: rows, round, columns, round, clip, embed.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from streamvln_tpu_torch.ops.linear import matmul_f32


def _keys_cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax <= 1, (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1,
        np.where(ax < 2,
                 a * ax ** 3 - 5 * a * ax ** 2 + 8 * a * ax - 4 * a,
                 0.0))


@functools.lru_cache(maxsize=8)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] bicubic interpolation weights (antialias on downsize)."""
    scale = in_size / out_size
    support = 2.0 * max(scale, 1.0)
    centers = (np.arange(out_size) + 0.5) * scale - 0.5
    idx = np.arange(in_size)
    dist = (idx[None, :] - centers[:, None]) / max(scale, 1.0)
    w = _keys_cubic(dist)
    w[np.abs(idx[None, :] - centers[:, None]) > support] = 0.0
    w /= w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _resize_operator(in_size: int, out_size: int, device: torch.device,
                     dtype: torch.dtype) -> torch.Tensor:
    """resize_matrix(in, out)^T [in, out] on `device` in `dtype`, made once:
    a host-to-device copy of pageable memory in every call would stall the
    host until the device drains its queue."""
    return torch.from_numpy(resize_matrix(in_size, out_size)).to(
        device, dtype).t().contiguous()


def fold_normalize(patch_w: torch.Tensor, patch_b: torch.Tensor,
                   rescale: float = 1.0 / 255.0, mean: float = 0.5,
                   std: float = 0.5):
    """Fold `x -> (x * rescale - mean) / std` into (patch_w, patch_b);
    both returned in f32."""
    scale = rescale / std
    shift = -mean / std
    wf = patch_w.float()
    return wf * scale, patch_b.float() + shift * wf.sum(dim=0)


def fused_patch_embed(frames_u8: torch.Tensor, patch_w: torch.Tensor,
                      patch_b: torch.Tensor, *, image_size: int,
                      patch_size: int,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """[N, H, W, 3] uint8 -> [N, n_patches, D] patch embeddings in
    compute_dtype: the two-stage preprocess + patch projection as three
    products on the raw bytes."""
    N, H, W, C = frames_u8.shape
    g = image_size // patch_size          # 27
    crop = g * patch_size                 # 378 (so400m's valid-conv crop)
    rh_t = _resize_operator(H, image_size, frames_u8.device, compute_dtype)
    rw_t = _resize_operator(W, image_size, frames_u8.device, compute_dtype)
    w2, b2 = fold_normalize(patch_w, patch_b)

    x = frames_u8.to(compute_dtype)
    # rows: [N, H, W, C] -> [N, out, W, C]; then columns -> [N, out, out, C]
    x = matmul_f32(x.permute(0, 2, 3, 1), rh_t).to(compute_dtype)
    x = x.permute(0, 3, 1, 2)             # [N, out, W, C]
    x = matmul_f32(x.permute(0, 1, 3, 2), rw_t).to(compute_dtype)
    x = x.permute(0, 1, 3, 2)             # [N, out, out, C]
    # the two-stage path clips the cubic overshoot to the u8 range before
    # the rescale; the clip is not affine, so it stays a separate step
    x = x.clamp(0.0, 255.0)
    # patchify, channel-major within a patch (models/siglip.patchify)
    x = x[:, :crop, :crop].reshape(N, g, patch_size, g, patch_size, C)
    x = x.permute(0, 1, 3, 5, 2, 4).reshape(N, g * g, C * patch_size ** 2)
    out = matmul_f32(x, w2.to(compute_dtype)) + b2
    return out.to(compute_dtype)
