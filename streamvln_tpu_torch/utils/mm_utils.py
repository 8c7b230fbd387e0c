"""Multimodal image utilities of the PyTorch port: anyres tiling and
keyword stopping.

Counterpart of `streamvln_tpu/utils/mm_utils.py` (its own copy: host
numpy and PIL, no tensors). Reference surface (llava/mm_utils.py):
select_best_resolution (:119-151), get_anyres_image_grid_shape
(:213-242), process_anyres_image (:243-295), KeywordsStoppingCriteria
(:372-395; the engine stops on token ids, this is for free-text keyword
stops).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def select_best_resolution(original_size: Tuple[int, int],
                           possible_resolutions) -> Tuple[int, int]:
    """The grid resolution (w, h) that keeps the most of the image's
    resolution, then wastes the least canvas; original_size is (w, h)."""
    ow, oh = original_size
    best, max_eff, min_waste = None, 0, float("inf")
    for w, h in possible_resolutions:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = w * h - eff
        if eff > max_eff or (eff == max_eff and waste < min_waste):
            max_eff, min_waste, best = eff, waste, (w, h)
    return best


def get_anyres_image_grid_shape(image_size: Tuple[int, int],
                                grid_pinpoints, patch_size: int
                                ) -> Tuple[int, int]:
    """(tiles across, tiles down) of the best grid resolution."""
    w, h = select_best_resolution(image_size, grid_pinpoints)
    return w // patch_size, h // patch_size


def divide_to_patches(image: np.ndarray, patch_size: int
                      ) -> List[np.ndarray]:
    """[H, W, 3] -> row-major list of [patch, patch, 3] tiles."""
    H, W = image.shape[:2]
    return [image[i: i + patch_size, j: j + patch_size]
            for i in range(0, H, patch_size)
            for j in range(0, W, patch_size)]


def process_anyres_image(image: np.ndarray, grid_pinpoints,
                         tile_size: int) -> np.ndarray:
    """AnyRes tiling: resize (PIL bicubic) into the best grid resolution
    keeping the aspect ratio, centre it on a black canvas, cut the canvas
    into tiles and put a thumbnail of the whole image first.
    Returns [n_tiles + 1, tile, tile, 3] uint8."""
    from PIL import Image
    ih, iw = image.shape[:2]
    best_w, best_h = select_best_resolution((iw, ih), grid_pinpoints)
    scale = min(best_w / iw, best_h / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    resized = np.asarray(Image.fromarray(image).resize(
        (nw, nh), Image.BICUBIC), np.uint8)
    canvas = np.zeros((best_h, best_w, 3), np.uint8)
    top, left = (best_h - nh) // 2, (best_w - nw) // 2
    canvas[top: top + nh, left: left + nw] = resized
    tiles = divide_to_patches(canvas, tile_size)
    thumb = np.asarray(Image.fromarray(image).resize(
        (tile_size, tile_size), Image.BICUBIC), np.uint8)
    return np.stack([thumb] + tiles)


class KeywordsStoppingCriteria:
    """Stop generation when any keyword appears in the decoded tail of the
    output ids."""

    def __init__(self, keywords: Sequence[str], tokenizer):
        self.keywords = list(keywords)
        self.tok = tokenizer

    def should_stop(self, output_ids: Sequence[int],
                    lookback: int = 24) -> bool:
        text = self.tok.decode(list(output_ids)[-lookback:])
        return any(k in text for k in self.keywords)
