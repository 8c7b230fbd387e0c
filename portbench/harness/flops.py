"""The yardstick's arithmetic: the H100's peaks, and the operations and
bytes that the traffic's useful work needs, counted from shapes (frames
encoded, prompt tokens prefilled at their offsets, tokens emitted), never
from the program's launches. A multiply-add is 2 operations. Rejected
speculative drafts and padded or idle batch rows are not useful work and
are not counted.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core rate and HBM3
# bandwidth, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

QUANT_TARGETS = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")


def vision_frame(cfg: dict) -> float:
    """One frame through the patch embed, the tower, the projector (the
    pool's interpolation is not counted)."""
    vc, Dm = cfg["vision"], cfg["llm"]["hidden_size"]
    P, D, F, L = (vc["patch_size"], vc["hidden_size"],
                  vc["intermediate_size"], vc["num_layers"])
    N = (vc["image_size"] // P) ** 2
    layer = 2 * N * (4 * D * D + 2 * D * F) + 4 * N * N * D
    return 2 * N * 3 * P * P * D + L * layer + 2 * N * (D * Dm + Dm * Dm)


def _llm_linear(lc: dict) -> float:
    """Operations of one token through one decoder layer's projections."""
    D, F = lc["hidden_size"], lc["intermediate_size"]
    Hq, Hkv, Dh = lc["num_heads"], lc["num_kv_heads"], lc["head_dim"]
    return 2 * (D * (Hq + 2 * Hkv) * Dh + Hq * Dh * D + 3 * D * F)


def _attention(lc: dict, offset: int, n: int) -> float:
    """Causal attention of n queries at positions offset..offset+n-1, each
    over the keys at its position and before, in every layer."""
    keys = n * offset + n * (n + 1) // 2
    return lc["num_layers"] * 4 * lc["num_heads"] * lc["head_dim"] * keys


def head(lc: dict) -> float:
    return 2 * lc["hidden_size"] * lc["vocab_size"]


def prefill(lc: dict, offset: int, n: int) -> float:
    """A prompt of n tokens written at `offset`, logits at its last."""
    return lc["num_layers"] * n * _llm_linear(lc) + \
        _attention(lc, offset, n) + head(lc)


def decode(lc: dict, offset: int, n: int) -> float:
    """n tokens fed one after another from `offset`, logits at each."""
    return n * (lc["num_layers"] * _llm_linear(lc) + head(lc)) + \
        _attention(lc, offset, n)


def call(cfg: dict, rec: dict) -> float:
    """A model call's useful operations: its frame, its prompt at the
    row's offset, and its served tokens but the last (fed to the cache;
    the first comes from the prefill's logits)."""
    lc = cfg["llm"]
    n_fed = max(len(rec["served"]) - 1, 0)
    start = rec["kv_before"] + rec["prefill_len"]
    return vision_frame(cfg) + prefill(lc, rec["kv_before"],
                                       rec["prefill_len"]) + \
        decode(lc, start, n_fed)


def int4_bytes(din: int, dout: int, group: int) -> int:
    """Packed int4 weight and f32 group scales of one [din, dout] matrix."""
    return din * dout // 2 + (din // group) * dout * 4


def int4_decode_pass_bytes(lc: dict, group: int) -> int:
    """Bytes one decode forward's int4 products need at one row: every
    layer's projections (q/k/v fused and gate/up fused read as one each)
    and the head, weights and scales once, the bf16 row in and the f32
    row out of each product."""
    D, F = lc["hidden_size"], lc["intermediate_size"]
    Hq, Hkv, Dh = lc["num_heads"], lc["num_kv_heads"], lc["head_dim"]
    products = [(D, (Hq + 2 * Hkv) * Dh), (Hq * Dh, D), (D, 2 * F), (F, D)]
    layer = sum(int4_bytes(i, o, group) + 2 * i + 4 * o
                for i, o in products)
    return lc["num_layers"] * layer + head_int4_bytes(lc, group)


def head_int4_bytes(lc: dict, group: int) -> int:
    D, V = lc["hidden_size"], lc["vocab_size"]
    return int4_bytes(D, V, group) + 2 * D + 4 * V
