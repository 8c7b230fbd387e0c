"""Frame preprocessing on the device: cubic resize to 384, rescale,
normalise (mean = std = 0.5), the SigLIP image processor's arithmetic.

Counterpart of `streamvln_tpu/ops/preprocess.py`: `preprocess_frames` (on
the device) and `preprocess_frames_host` (PIL bicubic on the host, the
dataset's path; PIL is imported only when it runs). The
reference resizes with `jax.image.resize(method="cubic")`, whose default
is antialiased Keys cubic with a = -0.5; PyTorch's bicubic matches it only
with `antialias=True` (without it the kernel is a = -0.75 and differs by
up to 132 on the 0-255 scale at 480x640 -> 384).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

IMAGE_MEAN = 0.5
IMAGE_STD = 0.5
TARGET_SIZE = 384


def preprocess_frames(frames_u8: torch.Tensor, size: int = TARGET_SIZE,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """[N, H, W, 3] uint8 -> [N, size, size, 3] normalised, on the frames'
    device. Frames already at size x size skip the resize."""
    x = frames_u8.float()
    if tuple(frames_u8.shape[1:3]) != (size, size):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                          mode="bicubic", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
        # clip the cubic overshoot back to the u8 range before rescale
        x = x.clamp(0.0, 255.0)
    x = x * (1.0 / 255.0)
    x = (x - IMAGE_MEAN) / IMAGE_STD
    return x.to(dtype).contiguous()


def preprocess_frames_host(frames_u8: np.ndarray,
                           size: int = TARGET_SIZE) -> np.ndarray:
    """PIL-exact host path: [N, H, W, 3] uint8 -> [N, size, size, 3] f32."""
    from PIL import Image
    out = np.empty((frames_u8.shape[0], size, size, 3), np.float32)
    for i, frame in enumerate(frames_u8):
        img = Image.fromarray(frame).convert("RGB").resize(
            (size, size), Image.BICUBIC)
        out[i] = np.asarray(img, np.float32)
    out *= 1.0 / 255.0
    out -= IMAGE_MEAN
    out /= IMAGE_STD
    return out
