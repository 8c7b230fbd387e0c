"""AnyRes image path of the PyTorch port: tiled encode, unpad/newline
merge and single-image generation.

Counterpart of `streamvln_tpu/models/anyres.py`. The reference's anyres
branch (llava/model/llava_arch.py:317-408, the "spatial_unpad" patch
merge) expands one <image> into a variable-length token sequence: the
global thumbnail's tokens, then the tile grid laid out spatially and
cropped back to the image's aspect ratio (unpad_image,
llava_arch.py:127-157), with the learned `image_newline` embedding after
every grid row. The token count is a function of (image size, grid
pinpoints) alone, so the host computes it and bakes it into the splice
layout (`build_splice_layout(image_token_counts=...)`). StreamVLN's video
path never uses anyres (its frames are square); this is the inherited
LLaVA single-image capability (offline VQA evaluation).

The tower runs in the weights' dtype (bf16 on the card, so the SigLIP
batch of thumbnail and tiles takes the vit kernel, K1); `generate_anyres`
recomputes the whole sequence for every generated token with no cache, as
the reference does (each step one prefill through the flash kernel, K2,
under "auto" on the card).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from streamvln_tpu_torch.configs import StreamVLNConfig
from streamvln_tpu_torch.models import projector as projector_lib
from streamvln_tpu_torch.models import qwen2, siglip, streamvln
from streamvln_tpu_torch.ops.preprocess import preprocess_frames
from streamvln_tpu_torch.utils.mm_utils import (get_anyres_image_grid_shape,
                                                process_anyres_image)

DEFAULT_GRID_PINPOINTS = ((384, 768), (768, 384), (768, 768),
                          (384, 1152), (1152, 384))


def unpad_bounds(grid_hw: Tuple[int, int], pps: int,
                 original_size: Tuple[int, int]
                 ) -> Tuple[int, int, int, int]:
    """(top, height, left, width) of the unpadded region of the
    [nph*pps, npw*pps] feature grid: the reference's unpad_image
    (llava_arch.py:138-157) on host ints. original_size is (width,
    height), as the reference calls it."""
    nph, npw = grid_hw
    H, W = nph * pps, npw * pps
    ow, oh = original_size
    if ow / oh > W / H:
        # padding was added to the height
        new_h = int(oh * (W / ow))
        pad = (H - new_h) // 2
        return pad, H - 2 * pad, 0, W
    new_w = int(ow * (H / oh))
    pad = (W - new_w) // 2
    return 0, H, pad, W - 2 * pad


def anyres_token_count(original_size: Tuple[int, int], grid_pinpoints,
                       tile_size: int, pps: int) -> int:
    """Tokens one <image> expands to: the thumbnail's pps^2, then the
    unpadded grid's rows each extended by the newline column."""
    npw, nph = get_anyres_image_grid_shape(original_size, grid_pinpoints,
                                           tile_size)
    _, h, _, w = unpad_bounds((nph, npw), pps, original_size)
    return pps * pps + h * (w + 1)


def merge_anyres_features(feats: torch.Tensor,        # [n_tiles+1, P, D]
                          image_newline: torch.Tensor,  # [D]
                          grid_hw: Tuple[int, int], pps: int,
                          original_size: Tuple[int, int]) -> torch.Tensor:
    """The spatial_unpad merge (llava_arch.py:389-400): the thumbnail's
    tokens, then the tile grid in its spatial layout, unpadded, a newline
    after each row, flattened. Returns [anyres_token_count, D]."""
    nph, npw = grid_hw
    D = feats.shape[-1]
    tiles = feats[1:].reshape(nph, npw, pps, pps, D)
    # (nph, pps, npw, pps, D) -> [nph*pps, npw*pps, D] spatial grid
    grid = tiles.permute(0, 2, 1, 3, 4).reshape(nph * pps, npw * pps, D)
    top, h, left, w = unpad_bounds(grid_hw, pps, original_size)
    region = grid[top:top + h, left:left + w]
    nl = image_newline.to(region.dtype).expand(h, 1, D)
    merged = torch.cat([region, nl], dim=1).reshape(h * (w + 1), D)
    return torch.cat([feats[0], merged], dim=0)


def encode_anyres(params, cfg: StreamVLNConfig, image_u8: np.ndarray,
                  grid_pinpoints=DEFAULT_GRID_PINPOINTS,
                  attn_impl: str = "auto") -> torch.Tensor:
    """One [H, W, 3] uint8 image -> [anyres_token_count, D_llm] features
    for splice_embeds, on the weights' device and in their dtype: the
    tiles and thumbnail (host PIL) go through one SigLIP batch, the
    projector and the merge. Needs params['image_newline']."""
    ih, iw = image_u8.shape[:2]
    tile = cfg.vision.image_size
    patch_w = params["vision"]["patch_w"]
    tiles = torch.from_numpy(process_anyres_image(
        image_u8, grid_pinpoints, tile)).to(patch_w.device)
    npw, nph = get_anyres_image_grid_shape((iw, ih), grid_pinpoints, tile)
    pixels = preprocess_frames(tiles, tile, dtype=patch_w.dtype)
    feats = siglip.forward(params["vision"], cfg.vision, pixels, attn_impl)
    feats = projector_lib.forward(params["projector"], feats)
    return merge_anyres_features(feats, params["image_newline"], (nph, npw),
                                 cfg.vision.patches_per_side, (iw, ih))


def anyres_logits(params, cfg: StreamVLNConfig, feats: torch.Tensor,
                  ids: Sequence[int], n_tok: int,
                  attn_impl: str = "auto") -> torch.Tensor:
    """One uncached step of `generate_anyres`: the splice of `ids` (one
    <image> sentinel expanding to the n_tok rows of `feats`) through the
    decoder; returns the f32 logits [V] at the last position."""
    layout = streamvln.build_splice_layout(
        np.asarray(ids, np.int32), cfg, image_token_counts=[n_tok])
    batch = streamvln.stack_layouts([layout])
    dev = feats.device

    def t(name):
        return torch.from_numpy(batch[name]).to(dev)
    embeds = streamvln.splice_embeds(params, feats[None], t("token_ids"),
                                     t("is_vision"), t("vision_index"),
                                     cfg.llm)
    pos = torch.arange(layout.length, dtype=torch.int32, device=dev)[None]
    last = torch.tensor([layout.length - 1], device=dev)
    # the logits of the last position only: the lm_head is per row, so
    # they equal the full forward's there
    logits, _ = qwen2.forward(params["llm"], cfg.llm, embeds, pos,
                              attn_impl=attn_impl, logits_positions=last)
    return logits[0, -1]


def generate_anyres(params, cfg: StreamVLNConfig, tok,
                    image_u8: np.ndarray, prompt_ids: np.ndarray,
                    max_new: int = 32, stop_ids: Sequence[int] = (),
                    grid_pinpoints=DEFAULT_GRID_PINPOINTS,
                    attn_impl: str = "auto") -> list:
    """Single-image VQA over the anyres splice: prompt_ids may hold one
    <image> sentinel (-200), which expands to the image's anyres token
    count. Greedy, with a full recompute per token (offline-eval scale;
    the streaming engine is the cached path for square video frames),
    stopping after a token of `stop_ids`."""
    ih, iw = image_u8.shape[:2]
    n_tok = anyres_token_count((iw, ih), grid_pinpoints,
                               cfg.vision.image_size,
                               cfg.vision.patches_per_side)
    with torch.no_grad():
        feats = encode_anyres(params, cfg, image_u8, grid_pinpoints,
                              attn_impl)
        ids = list(map(int, prompt_ids))
        stop = set(int(s) for s in stop_ids)
        out = []
        for _ in range(max_new):
            nxt = int(torch.argmax(anyres_logits(params, cfg, feats, ids,
                                                 n_tok, attn_impl)))
            out.append(nxt)
            ids.append(nxt)
            if nxt in stop:
                break
    return out
