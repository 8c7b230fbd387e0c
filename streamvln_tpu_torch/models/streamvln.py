"""StreamVLN multimodal stack for the PyTorch port: vision encode
(SigLIP tower -> projector -> 2x2 pool: bilinear, average or max), the
layout-driven
token splice, and the training forward with its (chunked) cross-entropy.

Counterpart of `streamvln_tpu/models/streamvln.py`. The host builds a
`SpliceLayout` (own copy of the reference's numpy code): for each output
position, text or vision and the flat index into the per-sample vision
tokens. On the device the splice is one gather and one select.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from streamvln_tpu_torch.configs import StreamVLNConfig
from streamvln_tpu_torch.models import projector as projector_lib
from streamvln_tpu_torch.models import qwen2, siglip
from streamvln_tpu_torch.utils.constants import (
    IGNORE_INDEX, IMAGE_TOKEN_INDEX, MEMORY_TOKEN_INDEX)

Params = dict


def pool_2d(feats: torch.Tensor, side: int, stride: int,
            mode: str = "bilinear") -> torch.Tensor:
    """[N, side*side, D] pooled as the reference's get_2dPool: "bilinear"
    resizes to ceil(side/stride) a side with half-pixel centres
    (F.interpolate align_corners=False, no antialias); "average" and "max"
    trim the grid to floor(side/stride) * stride and take the mean or the
    max of each stride x stride window, giving floor(side/stride)^2
    tokens (cfg.tokens_per_frame counts either)."""
    N, _, D = feats.shape
    grid = feats.reshape(N, side, side, D)
    if mode == "bilinear":
        out_side = -(-side // stride)
        pooled = F.interpolate(grid.permute(0, 3, 1, 2),
                               size=(out_side, out_side), mode="bilinear",
                               align_corners=False, antialias=False)
        pooled = pooled.permute(0, 2, 3, 1)
    elif mode in ("average", "max"):
        out_side = side // stride
        blocks = grid[:, :out_side * stride, :out_side * stride].reshape(
            N, out_side, stride, out_side, stride, D)
        pooled = blocks.mean(dim=(2, 4)) if mode == "average" \
            else blocks.amax(dim=(2, 4))
    else:
        raise ValueError(mode)
    return pooled.reshape(N, out_side * out_side, D)


def encode_frames(params: Params, cfg: StreamVLNConfig,
                  images: torch.Tensor, attn_impl: str = "auto",
                  remat: bool = False) -> torch.Tensor:
    """[B, V, H, W, 3] -> [B, V * tokens_per_frame, llm_hidden]: tower ->
    projector -> 2x2 pool, the same for memory and current frames."""
    B, V = images.shape[:2]
    flat = images.reshape((B * V,) + tuple(images.shape[2:]))
    feats = siglip.forward(params["vision"], cfg.vision, flat, attn_impl,
                           remat=remat)
    return project_pool(params, cfg, feats).reshape(
        B, V * cfg.tokens_per_frame, -1)


def project_pool(params: Params, cfg: StreamVLNConfig,
                 feats: torch.Tensor) -> torch.Tensor:
    """Tower features [N, patches, vision_hidden] -> [N, tokens_per_frame,
    llm_hidden]: projector -> 2x2 pool."""
    feats = projector_lib.forward(params["projector"], feats)
    return pool_2d(feats, cfg.vision.patches_per_side,
                   cfg.spatial_pool_stride, cfg.spatial_pool_mode)


@dataclasses.dataclass
class SpliceLayout:
    """Expanded-sequence layout for one sample (host numpy).

    All arrays have length `padded_len`. Vision positions read
    `vision_flat[vision_index]`; text positions read `embed[token_ids]`.
    """
    token_ids: np.ndarray      # int32; pad positions = 0
    is_vision: np.ndarray      # bool
    vision_index: np.ndarray   # int32 into [V * tokens_per_frame]
    labels: np.ndarray         # int32; IGNORE_INDEX on vision/pad/user
    valid: np.ndarray          # bool; real (non-pad) positions
    length: int                # number of real positions


def build_splice_layout(
    input_ids: np.ndarray,
    cfg: StreamVLNConfig,
    labels: Optional[np.ndarray] = None,
    pad_to: Optional[int] = None,
    frame_offset: int = 0,
    max_frames: Optional[int] = None,
    image_token_counts: Optional[list] = None,
) -> SpliceLayout:
    """Expand sentinel ids into per-position layout.

    <image> (-200) expands to tokens_per_frame positions; <memory> (-300)
    expands to num_history * tokens_per_frame. Vision tokens are consumed
    in sentinel order: each sentinel takes the next frames from the flat
    per-sample vision array (memory first iff <memory> precedes the first
    <image>, which matches prompt construction). `frame_offset` shifts
    vision_index by whole frames (used by the streaming engine when the
    current call's image batch is only a suffix of the episode's frames).

    `image_token_counts`: per-<image> custom expansion widths, in
    sentinel order — the anyres path, where each image contributes a
    host-computed variable token count (thumbnail + unpadded tile grid
    + newline column; models/anyres.py; reference:
    llava/model/llava_arch.py:317-408).
    """
    input_ids = np.asarray(input_ids, np.int32)
    if labels is None:
        labels = np.full_like(input_ids, IGNORE_INDEX)
    tpf = cfg.tokens_per_frame
    mem_tokens = cfg.num_history * tpf

    out_ids, out_vis, out_vidx, out_labels = [], [], [], []
    vis_cursor = frame_offset * tpf
    img_i = 0
    for tok, lab in zip(input_ids.tolist(), labels.tolist()):
        if tok == IMAGE_TOKEN_INDEX:
            if image_token_counts is not None:
                n = int(image_token_counts[img_i])
                img_i += 1
            else:
                n = tpf
        elif tok == MEMORY_TOKEN_INDEX:
            n = mem_tokens
        else:
            out_ids.append(tok)
            out_vis.append(False)
            out_vidx.append(0)
            out_labels.append(lab)
            continue
        out_ids.extend([0] * n)
        out_vis.extend([True] * n)
        out_vidx.extend(range(vis_cursor, vis_cursor + n))
        out_labels.extend([IGNORE_INDEX] * n)
        vis_cursor += n

    if max_frames is not None and vis_cursor > max_frames * tpf:
        raise ValueError(
            f"layout consumes {vis_cursor // tpf} frames of vision tokens "
            f"but only {max_frames} frames are supplied (a mismatched "
            f"<image>/<memory> count would silently gather wrong features)")

    length = len(out_ids)
    if pad_to is None:
        pad_to = length
    if length > pad_to:
        raise ValueError(
            f"expanded sequence length {length} exceeds pad_to={pad_to}; "
            f"raise the padding bucket")
    pad = pad_to - length

    return SpliceLayout(
        token_ids=np.asarray(out_ids + [0] * pad, np.int32),
        is_vision=np.asarray(out_vis + [False] * pad, bool),
        vision_index=np.asarray(out_vidx + [0] * pad, np.int32),
        labels=np.asarray(out_labels + [IGNORE_INDEX] * pad, np.int32),
        valid=np.asarray([True] * length + [False] * pad, bool),
        length=length,
    )


def stack_layouts(layouts) -> dict:
    """List[SpliceLayout] -> dict of batched numpy arrays."""
    return {
        "token_ids": np.stack([l.token_ids for l in layouts]),
        "is_vision": np.stack([l.is_vision for l in layouts]),
        "vision_index": np.stack([l.vision_index for l in layouts]),
        "labels": np.stack([l.labels for l in layouts]),
        "valid": np.stack([l.valid for l in layouts]),
        "lengths": np.asarray([l.length for l in layouts], np.int32),
    }


def splice_embeds(params: Params, vision_flat: torch.Tensor,
                  token_ids: torch.Tensor, is_vision: torch.Tensor,
                  vision_index: torch.Tensor, llm_cfg=None) -> torch.Tensor:
    """Gather + select: [B, T] layout -> [B, T, llm_hidden]; `llm_cfg`
    scales the text embeddings where its family does (Gemma)."""
    text = qwen2.embed_tokens(params["llm"], token_ids, llm_cfg)
    vis = torch.gather(vision_flat, 1, vision_index.long()[:, :, None]
                       .expand(-1, -1, vision_flat.shape[-1]))
    return torch.where(is_vision[:, :, None], vis.to(text.dtype), text)


def forward_train(
    params: Params,
    cfg: StreamVLNConfig,
    images: torch.Tensor,            # [B, V, H, W, 3]
    layout: dict,                    # tensors from stack_layouts
    attn_impl: str = "auto",
    remat: bool = False,
    loss_chunk_size: Optional[int] = None,
    remat_chunk: Optional[int] = None,
    mlp_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Training forward. Returns (loss, f32 logits), or (loss, None) with
    loss_chunk_size: the cross-entropy is then taken over sequence chunks
    of the final hidden states, so the [B, T, vocab] logits never exist
    at once; with remat each chunk's logits are recomputed in the
    backward."""
    vision_flat = encode_frames(params, cfg, images, attn_impl, remat=remat)
    embeds = splice_embeds(params, vision_flat, layout["token_ids"],
                           layout["is_vision"], layout["vision_index"],
                           cfg.llm)
    valid = layout["valid"]
    B, T = valid.shape
    positions = torch.where(valid, torch.cumsum(valid.int(), dim=1) - 1,
                            0).to(torch.int32)
    labels = layout["labels"].long()
    kw = dict(valid=valid, attn_impl=attn_impl, remat=remat,
              remat_chunk=remat_chunk, mlp_chunk=mlp_chunk)

    if loss_chunk_size is None:
        logits, _ = qwen2.forward(params["llm"], cfg.llm, embeds, positions,
                                  **kw)
        return _ce_loss(logits[:, :-1], labels[:, 1:]), logits

    hidden, _ = qwen2.forward(params["llm"], cfg.llm, embeds, positions,
                              return_hidden=True, **kw)
    C = loss_chunk_size
    if T % C:
        raise ValueError(f"sequence length {T} is not a multiple of "
                         f"loss_chunk_size {C}")
    # hidden[t] predicts labels[t + 1]; the last position predicts nothing
    shifted = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1],
                                                        IGNORE_INDEX)], 1)

    def chunk_loss(h, lab):
        logits = qwen2.lm_head_logits(params["llm"], h)
        mask = lab != IGNORE_INDEX
        logp = torch.log_softmax(logits.float(), dim=-1)
        tok = torch.gather(logp, -1, lab.clamp(min=0)[..., None])[..., 0]
        return -(tok * mask).sum(), mask.sum().float()

    loss_sum = torch.zeros((), device=hidden.device)
    count = torch.zeros((), device=hidden.device)
    for h, lab in zip(hidden.split(C, dim=1), shifted.split(C, dim=1)):
        s, n = checkpoint(chunk_loss, h, lab, use_reentrant=False) \
            if remat else chunk_loss(h, lab)
        loss_sum = loss_sum + s
        count = count + n
    return loss_sum / count.clamp(min=1), None


def _ce_loss(shift_logits: torch.Tensor,
             shift_labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy over labels != IGNORE_INDEX."""
    mask = shift_labels != IGNORE_INDEX
    logp = torch.log_softmax(shift_logits.float(), dim=-1)
    tok = torch.gather(logp, -1, shift_labels.clamp(min=0)[..., None])[..., 0]
    return -(tok * mask).sum() / mask.sum().clamp(min=1)
