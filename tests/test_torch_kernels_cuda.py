"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These need an NVIDIA GPU with nvcc (sm_90a); without one they skip.
Run them on the card with `python -m pytest tests/test_torch_kernels_cuda.py -q`.

Tolerance: bf16 inputs and outputs; the kernels round P to bf16 relative
to the running (online) row max while the plain versions round it
relative to the final max, so both differ by bf16 rounding of P plus the
bf16 output rounding. Elementwise, |out - ref| <= 1e-3 + 2^-6 * |ref|
(two bf16 ulps of the output) + 2^-8 * sum_k p_k |v_k| (each side's P off
by at most 2^-9 relative, not averaged out on rows that see few keys);
the last term is the plain version run on |v|.
"""
import numpy as np
import pytest
import torch

from streamvln_tpu_torch.ops import flash_attention as fa
from streamvln_tpu_torch.ops import vit_attention as va

pytestmark = pytest.mark.cuda
ATOL, RTOL = 1e-3, 2.0 ** -6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _assert_close(out, ref, ref_abs_v):
    """ref_abs_v: the plain version on |v|, i.e. sum_k p_k |v_k|."""
    err = (out.float() - ref.float()).abs()
    tol = ATOL + RTOL * ref.float().abs() + 2.0 ** -8 * ref_abs_v.float()
    assert bool((err <= tol).all()), (err - tol).max().item()


def _rand(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dev, torch.bfloat16)


# the query tiles' ragged edges (64- and 128-row tiles), the serving
# batches (1 and 9 frames) and the training tower batch (2 windows x 16
# frames), at both kernel head dims
@pytest.mark.parametrize("B,S,H,D", [
    (1, 729, 16, 72), (2, 50, 4, 64), (1, 16, 2, 72),
    (1, 65, 4, 64), (1, 65, 4, 72), (1, 129, 4, 64), (1, 129, 4, 72),
    (1, 191, 4, 64), (1, 191, 4, 72), (1, 729, 16, 64),
    (9, 729, 16, 72), (9, 191, 16, 64), (32, 729, 16, 72)])
def test_vit_kernel_matches_plain(dev, B, S, H, D):
    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, (B, S, H, D), dev) for _ in range(3))
    n0, nb0 = va.launches, va.launches_by_batch.get(B, 0)
    out = va.vit_attention(q, k, v)
    torch.cuda.synchronize()
    assert va.launches == n0 + 1
    assert va.launches_by_batch[B] == nb0 + 1
    _assert_close(out, va.vit_attention_plain(q, k, v),
                  va.vit_attention_plain(q, k, v.abs()))


# the encoder zoo's shapes: EVA01-CLIP-g (D=88, S=257; padded to 96 in
# the kernel), CLIP/MLCD-bigG (D=104 at S=257 and 577; padded to 112),
# CLIP-L and EVA02 (D=64 at S=577 and 197; S2's 1, 4 and 9 crops),
# anyres's SigLIP batches of thumbnail and tiles (D=72, B=3, 4, 5), and
# ragged tiles at the zoo's head dims at batch 1 and 2, where the plan
# splits the keys of 64-row tiles between the warpgroups (a tile of one
# row, a single key tile, odd and even key-tile counts); a second call
# bit-equal
@pytest.mark.parametrize("B,S,H,D", [
    (1, 257, 16, 88), (1, 257, 16, 104), (1, 577, 16, 104),
    (1, 577, 16, 64), (4, 577, 16, 64), (9, 577, 16, 64), (1, 197, 12, 64),
    (3, 729, 16, 72), (4, 729, 16, 72), (5, 729, 16, 72),
    (2, 65, 4, 88), (1, 129, 4, 104), (3, 191, 2, 88),
    (1, 65, 4, 104), (2, 129, 4, 88), (1, 191, 4, 104), (2, 197, 4, 64),
    (1, 257, 4, 64), (2, 577, 4, 104), (1, 577, 4, 88), (1, 33, 2, 64),
    (2, 63, 3, 104), (1, 1, 2, 88)])
def test_vit_kernel_at_the_zoo_shapes(dev, B, S, H, D):
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, (B, S, H, D), dev) for _ in range(3))
    n0 = va.launches_by_shape.get((B, S, H, D), 0)
    out = va.vit_attention(q, k, v)
    again = va.vit_attention(q, k, v)
    torch.cuda.synchronize()
    assert va.launches_by_shape[(B, S, H, D)] == n0 + 2
    assert torch.equal(out, again)
    _assert_close(out, va.vit_attention_plain(q, k, v),
                  va.vit_attention_plain(q, k, v.abs()))


def test_vit_kernel_refuses_head_dims_not_a_multiple_of_8(dev):
    x = torch.zeros((1, 16, 2, 100), dtype=torch.bfloat16, device=dev)
    n0 = va.launches
    with pytest.raises(ValueError, match="not a multiple of 8"):
        va.vit_attention(x, x, x)
    assert va.launches == n0


@pytest.mark.parametrize("Sq,cap,off,kv_major,soft_cap", [
    (256, 1024, 100, True, None),
    (100, 300, 37, False, None),
    (64, 512, 0, True, 30.0),
])
def test_flash_kernel_matches_plain(dev, Sq, cap, off, kv_major, soft_cap):
    rng = np.random.default_rng(1)
    B, Hq, Hkv, D = 2, 14, 2, 128
    q = _rand(rng, (B, Sq, Hq, D), dev)
    kshape = (B, Hkv, cap, D) if kv_major else (B, cap, Hkv, D)
    k, v = _rand(rng, kshape, dev), _rand(rng, kshape, dev)
    q_pos = (off + torch.arange(Sq, device=dev, dtype=torch.int32))[None] \
        .repeat(B, 1)
    q_pos[1, 3] = -1                      # a row that sees no key
    k_pos = torch.arange(cap, device=dev, dtype=torch.int32)[None] \
        .repeat(B, 1)
    k_pos[:, -16:] = fa.INVALID_POS
    out = fa.flash_attention(q, k, v, q_pos, k_pos, kv_major=kv_major,
                             logits_soft_cap=soft_cap)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q, k, v, q_pos, k_pos, kv_major=kv_major,
                                   logits_soft_cap=soft_cap)
    assert torch.all(out[1, 3] == 0)
    _assert_close(out, ref, fa.flash_attention_plain(
        q, k, v.abs(), q_pos, k_pos, kv_major=kv_major,
        logits_soft_cap=soft_cap))


@pytest.mark.parametrize("off", [0, 300])
@pytest.mark.parametrize("kv_major,soft_cap,fused_q", [
    (True, None, True), (False, None, True), (True, 30.0, False),
    (False, 50.0, True)])
def test_flash_kernel_tiling_edges(dev, off, kv_major, soft_cap, fused_q):
    """Qwen2's GQA (28/4 heads) at Sq=700 (a ragged last query tile):
    key tiles wholly below the diagonal (no per-element mask), straddling
    it, holding the padded tail (INVALID_POS) and wholly above it
    (skipped); q sliced out of a fused qkv projection (row stride
    (Hq + 2 Hkv) D); a row that sees no key."""
    rng = np.random.default_rng(11)
    B, Sq, Hq, Hkv, D, cap = 1, 700, 28, 4, 128, 1500
    if fused_q:
        q = _rand(rng, (B, Sq, Hq + 2 * Hkv, D), dev)[:, :, :Hq]
        assert q.stride(1) == (Hq + 2 * Hkv) * D
    else:
        q = _rand(rng, (B, Sq, Hq, D), dev)
    kshape = (B, Hkv, cap, D) if kv_major else (B, cap, Hkv, D)
    k, v = _rand(rng, kshape, dev), _rand(rng, kshape, dev)
    q_pos = (off + torch.arange(Sq, device=dev, dtype=torch.int32))[None]
    q_pos[0, 5] = -1                      # a row that sees no key
    k_pos = torch.arange(cap, device=dev, dtype=torch.int32)[None]
    k_pos[:, off + Sq + 40:] = fa.INVALID_POS
    n0 = fa.launches
    out = fa.flash_attention(q, k, v, q_pos, k_pos, kv_major=kv_major,
                             logits_soft_cap=soft_cap)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 1
    ref = fa.flash_attention_plain(q, k, v, q_pos, k_pos, kv_major=kv_major,
                                   logits_soft_cap=soft_cap)
    assert torch.all(out[0, 5] == 0)
    _assert_close(out, ref, fa.flash_attention_plain(
        q, k, v.abs(), q_pos, k_pos, kv_major=kv_major,
        logits_soft_cap=soft_cap))


def _d128_case(case, dev):
    """q, k, v (kv_major or not), q_pos, k_pos of a head-dim-128 case at
    the forward's plan edges (Qwen2-7B's 28/4 heads)."""
    rng = np.random.default_rng(21)
    Hq, Hkv, D = 28, 4, 128
    ar = np.arange
    kv_major = case in ("ragged", "wave", "sk_small")
    if case == "ragged":
        # Sq = 700 from position 300 over 1500 slots (neither a multiple of
        # 64), keys from 1040 on INVALID_POS, row 5 sees no key
        q_pos = (300 + ar(700))[None]
        q_pos[0, 5] = -1
        k_pos = ar(1500)[None].copy()
        k_pos[:, 1040:] = fa.INVALID_POS
    elif case == "unsorted":
        # shuffled positions on both sides, some keys INVALID_POS, queries
        # from -5 (no key) past the largest key
        k_pos = np.stack([rng.permutation(1000) for _ in range(2)])
        k_pos[:, rng.choice(1000, 60, replace=False)] = fa.INVALID_POS
        q_pos = rng.integers(-5, 1200, (2, 333))
    elif case == "wave":
        # a batched wave over the 4096-slot cache: rows at their offsets,
        # a row whose keys from slot 1000 on are INVALID_POS, an idle row
        # (no query sees a key)
        q_pos = np.asarray([0, 765, 3000, 0])[:, None] + ar(768)[None]
        q_pos[0, 7] = -1
        q_pos[-1] = -1
        k_pos = np.tile(ar(4096), (4, 1))
        k_pos[-2, 1000:] = fa.INVALID_POS
    elif case == "train":
        # the training layout at 1,000 valid of 1,100, row 3 of batch 1
        # sees no key
        q_pos, k_pos = (x.cpu().numpy() for x in _train_positions(
            2, 1100, 1100, 1000, "cpu"))
    elif case == "nokey":
        # every query before every key
        q_pos = np.full((1, 200), -1)
        k_pos = ar(300)[None]
    else:
        # one whole and one ragged key tile (Sk = 190), 130 queries
        q_pos = (60 + ar(130))[None]
        k_pos = ar(190)[None]
    B, Sq, Sk = q_pos.shape[0], q_pos.shape[1], k_pos.shape[1]
    q = _rand(rng, (B, Sq, Hq, D), dev)
    kshape = (B, Hkv, Sk, D) if kv_major else (B, Sk, Hkv, D)
    k, v = _rand(rng, kshape, dev), _rand(rng, kshape, dev)
    q_pos, k_pos = (torch.from_numpy(np.ascontiguousarray(x, np.int32))
                    .to(dev) for x in (q_pos, k_pos))
    return q, k, v, q_pos, k_pos, kv_major


# K2 and K3 at head dim 128 (K2 on 64-key tiles, K3 on 128-key tiles,
# both with the producer warpgroup and the visited- and full-tile masks)
# at the plan's edges: ragged Sq and
# Sk, unsorted positions, INVALID_POS keys, rows and a whole batch row
# that see no key, a query tile none of whose rows sees a key, one whole
# and one ragged key tile. Each within the tolerance of its plain version
# (K3's LSE within 1e-4 + 1e-5 |ref|, -1e30 exactly where no key is
# seen), a second call bit-equal, one kernel enqueued per call and
# replays of a captured graph bit-equal to the eager call.
@pytest.mark.parametrize("lse", [False, True], ids=["K2", "K3"])
@pytest.mark.parametrize("case", ["ragged", "unsorted", "wave", "train",
                                  "nokey", "sk_small"])
def test_flash_kernel_d128_edges(dev, case, lse):
    import chip_smoke as cs
    q, k, v, q_pos, k_pos, kv_major = _d128_case(case, dev)

    def call():
        if lse:
            return fa.flash_attention_lse(q, k, v, q_pos, k_pos,
                                          kv_major=kv_major)
        return fa.flash_attention(q, k, v, q_pos, k_pos, kv_major=kv_major)
    n0 = fa.lse_launches if lse else fa.launches
    first, again = call(), call()
    torch.cuda.synchronize()
    assert (fa.lse_launches if lse else fa.launches) == n0 + 2
    first = first if lse else (first,)
    again = again if lse else (again,)
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    out = first[0]
    ref = fa.flash_attention_plain(q, k, v, q_pos, k_pos, kv_major=kv_major)
    _assert_close(out, ref, fa.flash_attention_plain(
        q, k, v.abs(), q_pos, k_pos, kv_major=kv_major))
    seen = (k_pos[:, None, :] <= q_pos[:, :, None]).any(-1)    # [B, Sq]
    assert torch.all(out[~seen] == 0)
    if lse:
        _, ref_lse = fa.flash_attention_lse_plain(q, k, v, q_pos, k_pos,
                                                  kv_major=kv_major)
        got = first[1]
        unseen = ref_lse == fa.NEG_INF
        assert torch.equal(got == fa.NEG_INF, unseen)
        assert torch.equal(unseen, ~seen[:, None, :].expand_as(unseen))
        err = (got - ref_lse).abs()[~unseen]
        assert bool((err <= 1e-4 + 1e-5 * ref_lse.abs()[~unseen]).all())
    assert cs.launches_per_call(torch, call) == ["kernel"]
    assert cs.replay_equals_eager(torch, call, first if lse else out)


# One key-tile width for K2 and K3 at a shape (attention_plan.cuh::
# fwd_keys128): on the same head-dim-128 inputs the forward without grad
# (K2), K3 and the forward under grad (K3 through the autograd Function)
# give the same bits, at a shape of each width (the 7B's prefill buckets
# 768 (168 query-tile items: 64-key tiles) and 2560 (560 items: 128) from
# position 300 of a 4096-slot cache, the tail past the live prefix
# INVALID_POS, a row that sees no key), in the KV-head-major cache layout
# and in [B, S, Hkv, D].
@pytest.mark.parametrize("kv_major", [True, False])
@pytest.mark.parametrize("Sq,width", [(768, 64), (2560, 128)])
def test_flash_forwards_agree_bit_for_bit(dev, Sq, width, kv_major):
    rng = np.random.default_rng(31)
    Hq, Hkv, D, cap = 28, 4, 128, 4096
    q = _rand(rng, (1, Sq, Hq, D), dev)
    kshape = (1, Hkv, cap, D) if kv_major else (1, cap, Hkv, D)
    k, v = _rand(rng, kshape, dev), _rand(rng, kshape, dev)
    q_pos = (300 + torch.arange(Sq, device=dev, dtype=torch.int32))[None]
    q_pos[0, 9] = -1
    k_pos = torch.arange(cap, device=dev, dtype=torch.int32)[None]
    k_pos[:, 300 + Sq:] = fa.INVALID_POS
    assert fa.key_tile(1, Sq, cap, Hq, D) == width
    out2 = fa.flash_attention(q, k, v, q_pos, k_pos, kv_major=kv_major)
    out3, _ = fa.flash_attention_lse(q, k, v, q_pos, k_pos,
                                     kv_major=kv_major)
    qg = q.clone().requires_grad_()
    with torch.enable_grad():
        outg = fa.flash_attention(qg, k, v, q_pos, k_pos, kv_major=kv_major)
    torch.cuda.synchronize()
    assert torch.equal(out2, out3)
    assert torch.equal(out2, outg.detach())
    _assert_close(out2, fa.flash_attention_plain(
        q, k, v, q_pos, k_pos, kv_major=kv_major), fa.flash_attention_plain(
        q, k, v.abs(), q_pos, k_pos, kv_major=kv_major))


def test_non_bf16_cuda_calls_raise(dev):
    """The kernels take bf16 only: f32 CUDA tensors raise, both at the
    wrappers and through the dispatchers that pick them by shape."""
    import dataclasses

    from streamvln_tpu_torch.configs import tiny_llm
    from streamvln_tpu_torch.models import qwen2
    from streamvln_tpu_torch.ops.attention import mha_attention

    x = torch.zeros((1, 16, 2, 72), device=dev)
    for fn in (va.vit_attention, mha_attention):
        with pytest.raises(ValueError, match="bf16"):
            fn(x, x, x)
    cfg = dataclasses.replace(tiny_llm(), head_dim=128)
    q = torch.zeros((1, 64, 2, 128), device=dev)
    kv = torch.zeros((1, 1, 128, 128), device=dev)
    qp = torch.zeros((1, 64), dtype=torch.int32, device=dev)
    kp = torch.zeros((1, 128), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_attention(q, kv, kv, qp, kp, kv_major=True)
    with pytest.raises(ValueError, match="bf16"):
        qwen2._attend(cfg, "auto", q, kv, kv, qp, kp, kv_major=True)
    # head dims the kernels were not built for raise too
    y = torch.zeros((1, 16, 2, 32), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        va.vit_attention(y, y, y)


def _small_wide_cfg():
    """Two-layer stack at the real head dims (vision D=72, decoder D=128,
    GQA), so both kernels run inside the engine."""
    from streamvln_tpu_torch.configs import (Qwen2Config, SigLIPConfig,
                                             StreamVLNConfig)
    return StreamVLNConfig(
        vision=SigLIPConfig(hidden_size=144, intermediate_size=288,
                            num_layers=2, num_heads=2, image_size=56),
        llm=Qwen2Config(vocab_size=512, hidden_size=256,
                        intermediate_size=512, num_layers=2, num_heads=4,
                        num_kv_heads=2, head_dim=128, rope_theta=1e4),
        num_frames=8, num_future_steps=2, num_history=2)


def test_engine_on_card_kernels_vs_dense_path(dev):
    """The agent on the card through the kernels against the same agent
    through the dense attention path: every call's prefill logits agree
    (cosine > 0.999, bf16), and each call launched K1 and K2 once per
    layer."""
    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    from streamvln_tpu_torch.weights import init

    cfg = _small_wide_cfg()
    params = init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tok = ByteTokenizer()
    frames = np.random.default_rng(2).integers(0, 256, (9, 48, 64, 3),
                                               np.uint8)
    logits = {}
    for impl in ("auto", "dense"):
        eng = StreamingEngine(params, cfg, cache_capacity=2048,
                              max_new_tokens=4, stop_ids=(tok.im_end_id,),
                              buckets=(256, 512, 1024), attn_impl=impl)
        agent = VLNAgent(eng, tok)
        n_vit, n_fa = va.launches, fa.launches
        logits[impl] = []
        for frame in frames:
            agent.step(0, frame, "go to the door", run_model=True)
            logits[impl].append(eng.last_logits.float())
            assert int(eng.cache.length[0]) == eng.envs[0].kv_length
        calls = len(frames)
        if impl == "auto":
            assert va.launches - n_vit == cfg.vision.num_layers * calls
            assert fa.launches - n_fa == cfg.llm.num_layers * calls
        else:
            assert (va.launches, fa.launches) == (n_vit, n_fa)
    for a, b in zip(logits["auto"], logits["dense"]):
        cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min()
        assert cos.item() > 0.999, cos.item()


def test_f32_engine_on_card_matches_cpu(dev):
    """f32 on the card through the dense attention path (the kernels are
    bf16 and raise on f32) gives the CPU engine's tokens."""
    from streamvln_tpu_torch.configs import tiny_streamvln
    from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.weights import init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_streamvln()
    params = init(cfg, torch.Generator().manual_seed(0), "cpu",
                  torch.float32)
    tok = ByteTokenizer()
    frames = np.random.default_rng(3).integers(0, 256, (9, 48, 64, 3),
                                               np.uint8)
    texts = {}
    for d in ("cpu", "cuda"):
        eng = StreamingEngine(_to(params, d), cfg, cache_capacity=2048,
                              max_new_tokens=4, stop_ids=(tok.im_end_id,),
                              buckets=(128, 512, 1024), attn_impl="dense",
                              compute_dtype=torch.float32, device=d)
        agent = VLNAgent(eng, tok)
        texts[d] = [agent.step(0, f, "go", run_model=True)[2]
                    for f in frames]
    assert texts["cpu"] == texts["cuda"]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# Training kernels: K3 (forward + LSE), K4 (dQ), K5 (dK/dV)
#
# Tolerances. K3's output as above. LSE (f32): |err| <= 1e-4 + 1e-5 |ref|
# (f32 sums in another order and the fast exp; scores are O(1)), and rows
# that see no key are exactly -1e30 on both sides. The plain versions of
# K4/K5 round P and dS to bf16 as the kernels do, so what is left is the
# two sides' output rounding and the one-ulp flips of a rounded dS (or P,
# for dV) whose f32 values differ by a few ulps (amplified where dP - Dsum
# cancels, on rows that see few keys); elementwise |err| <= 2^-6 |ref| +
# 2^-7 * sum|terms of the product with the rounded factor| + 1e-5.
# ---------------------------------------------------------------------------

def _rounding_terms(q, k, v, dout, lse, dsum, q_pos, k_pos, kv_major):
    """scale*sum|dS||K|, scale*sum|dS||Q|, sum P|dO| per element of dQ,
    dK, dV (dK/dV in k's layout)."""
    B, S, Hq, D = q.shape
    scale = D ** -0.5
    p, ds, qf, kf, dof = fa._bwd_core(q, k, v, dout, lse, dsum, q_pos,
                                      k_pos, scale, kv_major)
    t_dq = torch.einsum("bhgqk,bhkd->bqhgd", ds.abs(), kf.abs()) \
        .reshape(B, S, Hq, D) * scale
    t_dk = torch.einsum("bhgqk,bqhgd->bhkd", ds.abs(), qf.abs()) * scale
    t_dv = torch.einsum("bhgqk,bqhgd->bhkd", p, dof.abs())
    if not kv_major:
        t_dk, t_dv = t_dk.transpose(1, 2), t_dv.transpose(1, 2)
    return t_dq, t_dk, t_dv


def _assert_grad_close(out, ref, term, what):
    ref = ref.float()
    err = (out.float() - ref).abs()
    tol = 2.0 ** -6 * ref.abs() + 2.0 ** -7 * term + 1e-5
    assert bool((err <= tol).all()), (what, (err / tol).max().item())


def _train_positions(B, Sq, Sk, n_valid, dev, blind=None):
    """Training layout (as forward_train): valid tokens at positions
    0..n-1, padded queries at position 0, padded keys at INVALID_POS; one
    query row of batch 1 sees no key, and so do the rows `blind` (a
    slice) of batch 0."""
    pos = torch.arange(Sq, device=dev, dtype=torch.int32)
    q_pos = torch.where(pos < n_valid, pos, 0)[None].repeat(B, 1)
    kp = torch.arange(Sk, device=dev, dtype=torch.int32)
    k_pos = torch.where(kp < n_valid, kp, fa.INVALID_POS)[None].repeat(B, 1)
    q_pos[1, 3] = -1
    if blind is not None:
        q_pos[0, blind] = -1
    return q_pos.contiguous(), k_pos.contiguous()


# The backward's tiling edges: K4 takes 128-row query tiles against 64-key
# stages, K5 128-key tiles against 64-row query stages (64-row and 64-key
# tiles at D = 256, where rows 64..127 of batch 0 are a whole blind tile;
# there K5 splits the 8 q heads of a KV head over 8, 4 (S = 2560: 80
# pairs, 160 padding keys) or 2 (G = 2) blocks and sums their partials, and
# takes one block per pair at 144 pairs (S = 1100, 4 KV heads)).
# S not a multiple of 128 (130, 200) or of 64 (130, 200, 300); G = 1, 2, 4,
# 7 and 8; both k/v layouts; D = 64, 128 and 256; whole key tiles of padding (300 keys, 150
# valid: K5's third 128-key tile and K4's last two 64-key tiles hold none);
# a whole 128-row query tile that sees no key (rows 128..255 of batch 0:
# no key stage reaches K4's block, K5 skips both 64-row tiles).
@pytest.mark.parametrize("S,n_valid,Hq,Hkv,kv_major,D,blind", [
    (200, 170, 14, 2, False, 128, None),
    (256, 256, 4, 4, True, 128, None),
    (130, 100, 7, 1, False, 128, None),
    (130, 130, 4, 2, True, 64, None),
    (200, 190, 8, 1, False, 64, None),
    (300, 150, 8, 2, False, 128, None),
    (384, 384, 4, 1, True, 128, slice(128, 256)),
    (200, 170, 8, 1, False, 256, None),
    (130, 100, 4, 2, True, 256, None),
    (384, 384, 8, 1, False, 256, slice(64, 128)),
    (2560, 2400, 8, 1, False, 256, slice(64, 128)),
    (1100, 1000, 8, 4, True, 256, None),
])
def test_flash_training_kernels_match_plain(dev, S, n_valid, Hq, Hkv,
                                            kv_major, D, blind):
    rng = np.random.default_rng(5)
    B = 2
    q = _rand(rng, (B, S, Hq, D), dev)
    kshape = (B, Hkv, S, D) if kv_major else (B, S, Hkv, D)
    k, v = _rand(rng, kshape, dev), _rand(rng, kshape, dev)
    dout = _rand(rng, (B, S, Hq, D), dev)
    q_pos, k_pos = _train_positions(B, S, S, n_valid, dev, blind)
    n3, n4, n5 = fa.lse_launches, fa.dq_launches, fa.dkv_launches
    out, lse = fa.flash_attention_lse(q, k, v, q_pos, k_pos,
                                      kv_major=kv_major)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_lse_plain(q, k, v, q_pos, k_pos,
                                                    kv_major=kv_major)
    assert torch.all(out[1, 3] == 0)
    _assert_close(out, ref_out, fa.flash_attention_plain(
        q, k, v.abs(), q_pos, k_pos, kv_major=kv_major))
    unseen = ref_lse == fa.NEG_INF
    assert torch.equal(lse == fa.NEG_INF, unseen)
    assert bool(unseen[1, :, 3].all())
    err = (lse - ref_lse).abs()[~unseen]
    assert bool((err <= 1e-4 + 1e-5 * ref_lse.abs()[~unseen]).all())

    dsum = fa._dsum(dout, out)
    args = (q, k, v, dout, lse, dsum, q_pos, k_pos)
    dq = fa.flash_bwd_dq(*args, kv_major=kv_major)
    dk, dv = fa.flash_bwd_dkv(*args, kv_major=kv_major)
    torch.cuda.synchronize()
    assert (fa.lse_launches - n3, fa.dq_launches - n4,
            fa.dkv_launches - n5) == (1, 1, 1)
    assert torch.all(dq[1, 3] == 0)
    if blind is not None:
        assert torch.all(dq[0, blind] == 0)
    t_dq, t_dk, t_dv = _rounding_terms(*args, kv_major)
    _assert_grad_close(dq, fa.flash_bwd_dq_plain(*args, kv_major=kv_major),
                       t_dq, "dq")
    rdk, rdv = fa.flash_bwd_dkv_plain(*args, kv_major=kv_major)
    _assert_grad_close(dk, rdk, t_dk, "dk")
    _assert_grad_close(dv, rdv, t_dv, "dv")
    # no atomics and a fixed order: a second call is bit-equal
    dk2, dv2 = fa.flash_bwd_dkv(*args, kv_major=kv_major)
    assert torch.equal(fa.flash_bwd_dq(*args, kv_major=kv_major), dq)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


# K4 and K5 at head dim 128 at the backward's edges, on the forward's
# head-dim-128 cases (_d128_case: ragged Sq and Sk, neither a multiple of
# 64; unsorted positions; INVALID_POS keys; rows, an idle batch row and a
# query tile that see no key; the KV-head-major cache; Sq != Sk) and at
# S = 8192 (the training layout, 8,000 valid; one KV head of G = 7): each
# within the tolerances above, rows that see no key exactly zero in dQ, a
# second call bit-equal, one kernel enqueued per call and replays of a
# captured graph bit-equal to the eager call.
@pytest.mark.parametrize("case", ["ragged", "unsorted", "wave", "train",
                                  "nokey", "sk_small", "s8192"])
def test_flash_backward_d128_edges(dev, case):
    import chip_smoke as cs
    if case == "s8192":
        rng = np.random.default_rng(22)
        S, Hq, Hkv, D = 8192, 7, 1, 128
        q = _rand(rng, (1, S, Hq, D), dev)
        k, v = _rand(rng, (1, S, Hkv, D), dev), _rand(rng, (1, S, Hkv, D),
                                                      dev)
        pos = torch.arange(S, device=dev, dtype=torch.int32)
        q_pos = torch.where(pos < 8000, pos, 0)[None].contiguous()
        k_pos = torch.where(pos < 8000, pos, fa.INVALID_POS)[None] \
            .contiguous()
        q_pos[0, 3] = -1
        kv_major = False
    else:
        q, k, v, q_pos, k_pos, kv_major = _d128_case(case, dev)
        rng = np.random.default_rng(23)
    dout = _rand(rng, tuple(q.shape), dev)
    out, lse = fa.flash_attention_lse(q, k, v, q_pos, k_pos,
                                      kv_major=kv_major)
    dsum = fa._dsum(dout, out)
    args = (q, k, v, dout, lse, dsum, q_pos, k_pos)

    def dq_call():
        return fa.flash_bwd_dq(*args, kv_major=kv_major)

    def dkv_call():
        return fa.flash_bwd_dkv(*args, kv_major=kv_major)
    n4, n5 = fa.dq_launches, fa.dkv_launches
    dq, (dk, dv) = dq_call(), dkv_call()
    dq2, (dk2, dv2) = dq_call(), dkv_call()
    torch.cuda.synchronize()
    assert (fa.dq_launches - n4, fa.dkv_launches - n5) == (2, 2)
    assert torch.equal(dq2, dq) and torch.equal(dk2, dk) \
        and torch.equal(dv2, dv)
    seen = (k_pos[:, None, :] <= q_pos[:, :, None]).any(-1)    # [B, Sq]
    assert torch.all(dq[~seen] == 0)
    t_dq, t_dk, t_dv = _rounding_terms(*args, kv_major)
    _assert_grad_close(dq, fa.flash_bwd_dq_plain(*args, kv_major=kv_major),
                       t_dq, "dq")
    del t_dq
    rdk, rdv = fa.flash_bwd_dkv_plain(*args, kv_major=kv_major)
    _assert_grad_close(dk, rdk, t_dk, "dk")
    _assert_grad_close(dv, rdv, t_dv, "dv")
    del rdk, rdv, t_dk, t_dv
    assert cs.launches_per_call(torch, dq_call) == ["kernel"]
    assert cs.launches_per_call(torch, dkv_call) == ["kernel"]
    assert cs.replay_equals_eager(torch, dq_call, dq)
    assert cs.replay_equals_eager(torch, dkv_call, (dk, dv))


@pytest.mark.parametrize("B,S,Hq,Hkv,D,want", [
    (2, 4096, 8, 1, 256, 4),    # Gemma's training shape: 128 pairs
    (2, 2560, 8, 1, 256, 4),
    (2, 200, 8, 1, 256, 8),
    (2, 130, 4, 2, 256, 2),
    (2, 1100, 8, 4, 256, 1),    # 144 pairs: a wave or more
    (2, 4096, 28, 4, 128, 1),   # streamvln_7b keeps one block per pair
])
def test_dkv_head_split_on_the_card(dev, B, S, Hq, Hkv, D, want):
    assert fa.dkv_splits(B, S, Hq, Hkv, D) == want


def test_cuda_grads_flow_through_both_wrappers(dev):
    """A loss through K1 and through the flash wrapper gives q/k/v grads on
    the card: K1's are autograd of the dense reference (its backward), the
    flash grads are K4/K5's and agree with the plain backward; K2 is not
    launched on the grad path."""
    rng = np.random.default_rng(6)
    x = [_rand(rng, (2, 50, 4, 72), dev).requires_grad_() for _ in range(3)]
    g = _rand(rng, (2, 50, 4, 72), dev)
    (va.vit_attention(*x).float() * g.float()).sum().backward()
    ref = [t.detach().clone().requires_grad_() for t in x]
    (va.vit_attention_reference(*ref, 72 ** -0.5).float()
     * g.float()).sum().backward()
    for a, b in zip(x, ref):
        assert a.grad is not None and a.grad.abs().max() > 0
        torch.testing.assert_close(a.grad, b.grad, atol=0, rtol=0)

    B, S, Hq, Hkv, D = 2, 96, 4, 2, 128
    q = _rand(rng, (B, S, Hq, D), dev).requires_grad_()
    k = _rand(rng, (B, S, Hkv, D), dev).requires_grad_()
    v = _rand(rng, (B, S, Hkv, D), dev).requires_grad_()
    dout = _rand(rng, (B, S, Hq, D), dev)
    q_pos, k_pos = _train_positions(B, S, S, 80, dev)
    n2 = fa.launches
    out = fa.flash_attention(q, k, v, q_pos, k_pos)
    out.backward(dout)
    assert fa.launches == n2
    with torch.no_grad():
        _, lse = fa.flash_attention_lse(q, k, v, q_pos, k_pos)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                            q_pos, k_pos)
        terms = _rounding_terms(q, k, v, dout, lse, fa._dsum(dout, out),
                                q_pos, k_pos, False)
    for t, w, term, name in zip((q, k, v), want, terms, "qkv"):
        assert t.grad is not None and t.grad.abs().max() > 0
        _assert_grad_close(t.grad, w, term, "d" + name)


# ---------------------------------------------------------------------------
# int4 kernels K6 (dequant-matmul) and K7 (unpack), decode kernel K8
#
# K6 vs its plain version: the same weights rounded once to x's type on
# both sides and f32 out, so only the f32 summation order differs:
# |err| <= 1e-5 * sum_k |x_k w_k| + 1e-6. K7: bit-equal. K8 vs its plain
# version run in f32 on the same inputs: |err| <= 2^-8 |ref| + 1e-5 (half
# a bf16 ulp of the kernel's output, f32 summation order).
# ---------------------------------------------------------------------------

def _int4_weight(din, dout, dev, seed, L=2):
    from streamvln_tpu_torch.models import quant
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((L, din, dout), generator=g, device=dev) * din ** -0.5
    return quant.quantize_weight_int4(w)


# K6 at the main path's o (3584->3584) and down (18944->3584) decode
# shapes, both n-tile variants of the bf16 kernel (rows 1-8 and 9-128,
# ragged), one cluster and none (splits), and the f32 kernel; every case
# also checks that a second call is bit-equal (the splits merge in a fixed
# order)
@pytest.mark.parametrize("M,din,dout,dtype", [
    (1, 1024, 1536, torch.bfloat16), (5, 512, 2048, torch.bfloat16),
    (128, 1024, 512, torch.bfloat16), (3, 512, 512, torch.float32),
    (1, 3584, 4608, torch.bfloat16), (1, 3584, 3584, torch.bfloat16),
    (1, 18944, 3584, torch.bfloat16), (2, 3584, 3584, torch.bfloat16),
    (8, 3584, 3584, torch.bfloat16), (20, 1024, 1536, torch.bfloat16),
    (40, 512, 37888, torch.bfloat16), (128, 3584, 3584, torch.bfloat16),
    (1, 1024, 1536, torch.float32), (11, 512, 1024, torch.float32)])
def test_int4_kernels_match_plain(dev, M, din, dout, dtype):
    from streamvln_tpu_torch.ops import int4_matmul as i4
    wp, s = _int4_weight(din, dout, dev, M)
    x = torch.randn((M, din), device=dev).to(dtype)
    n6, n7 = i4.launches, i4.dequant_launches
    for layer in (0, 1):
        out = i4.int4_matmul(x, wp, s, layer)
        again = i4.int4_matmul(x, wp, s, layer)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        ref = i4.int4_matmul_plain(x, wp, s, layer)
        lo, hi = i4._scaled_halves(wp[layer], s[layer], dtype)
        term = x[:, 0::2].float().abs() @ lo.float().abs() \
            + x[:, 1::2].float().abs() @ hi.float().abs()
        assert out.dtype == torch.float32 and out.shape == (M, dout)
        assert bool(((out - ref).abs() <= 1e-5 * term + 1e-6).all())
        split = i4.int4_dequant_split(wp, s, layer, dtype)
        torch.cuda.synchronize()
        assert torch.equal(split, i4.int4_dequant_split_plain(wp, s, layer,
                                                              dtype))
    assert (i4.launches - n6, i4.dequant_launches - n7) == (4, 2)


# K7 at its plan's edges (csrc/kernel_plan.cuh, unpack_*) and in each of
# its three unit sizes: the smallest shape (2-row units: 128 blocks of one
# warp), a ragged grid of 8-row units whose blocks' runs end inside rows
# (672 units over 132 blocks of 6 warps), k/v's width (one 512-column
# tile, 2-row units over 132 blocks of 7 warps, some idle) and lm_head's
# (297 tiles; whole-group units, 9 warps of 2), in bf16 and f32, at both
# layers of a stack; every byte value and scales over eight octaves:
# bit-equal to the plain version, a second call bit-equal, and the launch
# counter one up per call
@pytest.mark.parametrize("din,dout", [(512, 512), (3584, 1536),
                                      (3584, 512), (512, 152064)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int4_unpack_at_the_plan_edges(dev, din, dout, dtype):
    from streamvln_tpu_torch.ops import int4_matmul as i4
    g = torch.Generator(device=dev).manual_seed(din + dout)
    wp = torch.randint(0, 256, (2, din // 2, dout), generator=g,
                       device=dev, dtype=torch.uint8)
    s = torch.exp2(torch.rand((2, din // 64, dout), generator=g,
                              device=dev) * 8 - 12)
    for layer in (0, 1):
        n = i4.dequant_launches
        out = i4.int4_dequant_split(wp, s, layer, dtype)
        assert i4.dequant_launches - n == 1
        again = i4.int4_dequant_split(wp, s, layer, dtype)
        assert i4.dequant_launches - n == 2
        torch.cuda.synchronize()
        assert out.shape == (2, din // 2, dout) and out.dtype == dtype
        assert torch.equal(out, i4.int4_dequant_split_plain(wp, s, layer,
                                                            dtype))
        assert torch.equal(out, again)


def test_int4_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from streamvln_tpu_torch.ops import int4_matmul as i4
    wp, s = _int4_weight(512, 512, dev, 0)
    x = torch.zeros((2, 512), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16 or f32"):
        i4.int4_matmul(x, wp, s, 0)
    with pytest.raises(ValueError, match="eligible"):
        i4.int4_matmul(x.float(), wp[:, :, :384].contiguous(),
                       s[:, :, :384].contiguous(), 0)
    # a gradient is taken now (QLoRA), where the wrapper refused one before
    # the quantized tail: dx equals the plain backward's on the CPU
    xg = torch.randn((2, 512), device=dev).requires_grad_()
    (dx,) = torch.autograd.grad(i4.int4_matmul(xg, wp, s, 0).sum(), xg)
    xc = xg.detach().cpu().requires_grad_()
    (want,) = torch.autograd.grad(
        i4.int4_matmul(xc, wp.cpu(), s.cpu(), 0).sum(), xc)
    torch.testing.assert_close(dx.cpu(), want, rtol=1e-5, atol=1e-5)


# the int4 products' autograd Functions (QLoRA): K6's route at 1 and 7
# rows of the main path's o projection (its backward is the f32 dequant
# and one f32 product), K7's at 4096 rows of a 1024 x 1024 layer (K7 in
# the forward and again in the backward, then one bf16 product; the layer
# is narrower so that the CPU side stays quick); output, dx and launch
# counts against the same Functions on CPU copies (the plain versions).
# dx is bf16 on both sides, each rounded once from f32 sums taken in
# another order: within one bf16 ulp (2^-7 |ref|) plus the f32 sums'
# difference (K6's f32 backward 1e-5, K7's bf16 product 2^-16, of
# sum |g||w|)
@pytest.mark.parametrize("M", [1, 7, 4096])
def test_int4_autograd_on_card_matches_plain(dev, M):
    from streamvln_tpu_torch.ops import int4_matmul as i4
    d = 3584 if M <= 128 else 1024
    wp, s = _int4_weight(d, d, dev, 3)
    g = torch.Generator(device=dev).manual_seed(M)
    x = torch.randn((M, d), generator=g, device=dev).bfloat16()
    go = torch.randn((M, d), generator=g, device=dev)
    fn = i4.int4_matmul if M <= i4.KERNEL_MAX_ROWS else \
        i4.int4_prefill_matmul
    outs = {}
    for where in ("cuda", "cpu"):
        xw = x.to(where).requires_grad_()
        n6, n7 = i4.launches, i4.dequant_launches
        out = fn(xw, wp.to(where), s.to(where), 1)
        (dx,) = torch.autograd.grad(out, xw, go.to(where))
        outs[where] = (out.detach().float().cpu(), dx.float().cpu(),
                       (i4.launches - n6, i4.dequant_launches - n7))
    (out, dx, n), (ref, dref, n_cpu) = outs["cuda"], outs["cpu"]
    assert n == ((1, 0) if M <= i4.KERNEL_MAX_ROWS else (0, 2))
    assert n_cpu == (0, 0)
    from streamvln_tpu_torch.models.quant import dequant_int4
    w = dequant_int4(wp[1].cpu(), s[1].cpu(), torch.float32)
    term_x = x.float().cpu().abs() @ w.abs()
    assert bool(((out - ref).abs() <= 1e-5 * term_x + 1e-5).all())
    term_g = go.cpu().abs() @ w.abs().t()
    bound = 2.0 ** -7 * dref.abs() + (
        1e-5 if M <= i4.KERNEL_MAX_ROWS else 2.0 ** -16) * term_g
    assert bool(((dx - dref).abs() <= bound + 1e-6).all())


_LENGTHS = (0, 1, 31, 129, 511, 513, 1024, 2000)


# K8 at ragged lengths of a small cache (16-key chunks, 64-key tiles,
# shares, a row of length 0, a length past the capacity), and at B = 1 of
# the main path's 4096-slot cache with 300, 4095 and 4096 live keys and a
# batch whose length-0 row sits beside full rows, and f32 rows of Gemma's
# single-KV-head shape at head dim 128; every case also checks that a
# second call is bit-equal
@pytest.mark.parametrize("Hq,Hkv,dtype,lengths,cap", [
    (28, 4, torch.bfloat16, _LENGTHS, 1024),
    (8, 8, torch.float32, _LENGTHS, 1024),
    (16, 1, torch.bfloat16, _LENGTHS, 1024),
    (28, 4, torch.bfloat16, (300,), 4096),
    (28, 4, torch.bfloat16, (4095,), 4096),
    (28, 4, torch.bfloat16, (4096,), 4096),
    (28, 4, torch.bfloat16, (4096, 0, 4096), 4096),
    (28, 4, torch.float32, (4096, 0, 300), 4096),
    (8, 1, torch.float32, (4096, 3000), 4096)])
def test_decode_kernel_matches_plain(dev, Hq, Hkv, dtype, lengths, cap):
    from streamvln_tpu_torch.ops import decode_attention as da
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    B, D = lengths.numel(), 128
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((B, 1, Hq, D))
                         .astype(np.float32)).to(dev, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, cap, D))
                             .astype(np.float32)).to(dev, dtype)
            for _ in range(2))
    n0 = da.launches
    out = da.decode_attention(q, k, v, lengths)
    again = da.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert da.launches == n0 + 2 and out.dtype == dtype
    assert torch.equal(out, again)
    ref = da.decode_attention_plain(q.float(), k.float(), v.float(), lengths)
    assert torch.all(out[lengths == 0] == 0)
    err = (out.float() - ref).abs()
    assert bool((err <= 2.0 ** -8 * ref.abs() + 1e-5).all()), err.max()


def test_int4_engine_on_card_matches_dequantized_dense(dev):
    """int4 weights on the card through K6/K7 (fused by the engine)
    against the same weights dequantized to bf16 on the dense path:
    prefill logits agree (cosine > 0.99) on every call, and the launch
    counts follow the path: per call K7 for the 4 fused projections of
    each layer (prefill), K6 for the prefill's lm_head and 4 per layer + 1
    per decode forward: one per fed token, replayed from the decode graph,
    and the no-op warm-up forward before the graph's capture. Under
    decode_kernel, K8 runs once per layer per decode forward."""
    from streamvln_tpu_torch.data import chatml
    from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
    from streamvln_tpu_torch.models import quant
    from streamvln_tpu_torch.ops import decode_attention as da
    from streamvln_tpu_torch.ops import int4_matmul as i4
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    from streamvln_tpu_torch.weights import init

    import dataclasses
    wide = _small_wide_cfg()      # hidden 512: every din, dout % 512 == 0
    cfg = dataclasses.replace(wide, llm=dataclasses.replace(
        wide.llm, hidden_size=512))
    L = cfg.llm.num_layers
    params = init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    q4 = quant.quantize_llm(params, bits=4)
    tok = ByteTokenizer()
    frames = np.random.default_rng(4).integers(0, 256, (4, 48, 64, 3),
                                               np.uint8)
    logits = {}
    for name, tree, impl in (("int4", q4, "auto"),
                             ("dense", quant.dequantize_llm(
                                 q4, torch.bfloat16), "dense"),
                             ("decode_kernel", q4, "decode_kernel")):
        eng = StreamingEngine(tree, cfg, cache_capacity=2048,
                              max_new_tokens=4, stop_ids=(tok.im_end_id,),
                              buckets=(256, 512, 1024), attn_impl=impl)
        n6, n7, n8 = i4.launches, i4.dequant_launches, da.launches
        logits[name], fed = [], 0
        for call, frame in enumerate(frames):
            ids, _ = chatml.tokenize_dialogue(
                tok, [("user", chatml.observation_prompt(None, "go"))],
                add_system=call == 0, with_labels=False)
            ids = np.concatenate([ids, np.asarray(
                chatml.generation_prompt(tok), np.int32)])
            out = eng.generate(0, frame, ids, step_id=call)
            fed += len(out) - 1
            logits[name].append(eng.last_logits.float())
        n, forwards = len(frames), fed + len(eng.graphs)
        if name == "int4":
            assert i4.dequant_launches - n7 == 4 * L * n
            assert i4.launches - n6 == n + (4 * L + 1) * forwards
        if name == "decode_kernel":
            assert da.launches - n8 == L * forwards
            assert i4.dequant_launches - n7 == 4 * L * n
    for a, b in zip(logits["int4"], logits["dense"]):
        cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min()
        assert cos.item() > 0.99, cos.item()


_FRESH_CAPTURE = r"""
import dataclasses, gc, sys
import numpy as np
import torch
sys.path.insert(0, "tests")
from test_torch_kernels_cuda import _small_wide_cfg
from streamvln_tpu_torch.data import chatml
from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
from streamvln_tpu_torch.models import quant
from streamvln_tpu_torch.ops import int4_matmul as i4
from streamvln_tpu_torch.streaming.engine import StreamingEngine
from streamvln_tpu_torch.weights import init

dev = torch.device("cuda")
# a CUDA graph with memory in its pool, which each decode capture drops
# into a fresh reference cycle right after it begins, while the collector
# runs on every allocation until the capture ends
x = torch.ones(1 << 20, device=dev)
held = [torch.cuda.CUDAGraph()]
with torch.cuda.graph(held[0]):
    y = x * 2
begin, end = torch.cuda.CUDAGraph.capture_begin, \
    torch.cuda.CUDAGraph.capture_end
dropped = []


def capture_begin(self, *a, **k):
    begin(self, *a, **k)
    if held:
        cycle = [held.pop(), y]
        cycle.append(cycle)
        dropped.append(1)
    gc.set_threshold(1, 1, 1)


def capture_end(self, *a, **k):
    gc.set_threshold(700, 10, 10)
    end(self, *a, **k)


torch.cuda.CUDAGraph.capture_begin = capture_begin
torch.cuda.CUDAGraph.capture_end = capture_end
wide = _small_wide_cfg()
cfg = dataclasses.replace(wide, llm=dataclasses.replace(wide.llm,
                                                        hidden_size=512))
params = init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
q4 = quant.quantize_llm(params, bits=4)
tok = ByteTokenizer()
frame = np.random.default_rng(4).integers(0, 256, (48, 64, 3), np.uint8)
ids, _ = chatml.tokenize_dialogue(
    tok, [("user", chatml.observation_prompt(None, "go"))],
    add_system=True, with_labels=False)
ids = np.concatenate([ids, np.asarray(chatml.generation_prompt(tok),
                                      np.int32)])
assert i4.launches == 0
out = {}
for graphs in (True, False):
    eng = StreamingEngine(q4, cfg, cache_capacity=2048, max_new_tokens=4,
                          stop_ids=(tok.im_end_id,), buckets=(256, 512, 1024),
                          cuda_graphs=graphs)
    out[graphs] = [int(t) for t in eng.generate(0, frame, ids, step_id=0)]
    if graphs:
        assert eng.graphs and dropped == [1], (eng.graphs, dropped)
        assert sum(g.replays for g in eng.graphs.values()) >= 1
assert out[True] == out[False], out
print("captured", len(out[True]))
"""


def test_int4_decode_capture_in_a_fresh_process(dev):
    """An int4 engine's decode graph captured in a fresh process (K6's
    first launches there: the prefill's lm_head, then the step's warm-up
    and capture) while a dropped CUDA graph sits in a reference cycle and
    the garbage collector runs on every allocation: the capture holds (no
    collection frees the dropped graph inside it), and its replays give
    the eager loop's tokens."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _FRESH_CAPTURE], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "captured" in r.stdout


# K6 at the speculative verify's 7 rows (spec_lookup 6 + the fed token) at
# the four layer projections of the main path: fused qkv, o, fused gate/up
# and down; the tolerance, bit-equality and one launch per call as above
@pytest.mark.parametrize("din,dout", [(3584, 4608), (3584, 3584),
                                      (3584, 37888), (18944, 3584)])
def test_int4_kernel_at_the_spec_verify_rows(dev, din, dout):
    from streamvln_tpu_torch.ops import int4_matmul as i4
    wp, s = _int4_weight(din, dout, dev, 7, L=1)
    x = torch.randn((7, din), device=dev).to(torch.bfloat16)
    n6 = i4.launches
    out = i4.int4_matmul(x, wp, s, 0)
    again = i4.int4_matmul(x, wp, s, 0)
    torch.cuda.synchronize()
    assert i4.launches == n6 + 2 and torch.equal(out, again)
    ref = i4.int4_matmul_plain(x, wp, s, 0)
    lo, hi = i4._scaled_halves(wp[0], s[0], torch.bfloat16)
    term = x[:, 0::2].float().abs() @ lo.float().abs() \
        + x[:, 1::2].float().abs() @ hi.float().abs()
    assert bool(((out - ref).abs() <= 1e-5 * term + 1e-6).all())


def test_spec_engine_call_on_card_matches_greedy(dev):
    """Speculative calls (spec_lookup=6) against the greedy calls of the
    same weights and inputs, bf16 through the kernels on a small stack at
    the real head dims, over 9 agent steps (5 calls, a window reset with
    <memory>): chip_smoke.spec_vs_greedy holds every call equal, or, where
    bf16 rounding of the 7-query verify forward and the 1-query step part
    them, the first differing token the greedy runner-up at a greedy gap
    within SPEC_FLIP_BOUND x the largest logit difference of the two paths
    at the positions where they agree; the logits point the same way up
    to there."""
    import chip_smoke as cs
    from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
    from streamvln_tpu_torch.weights import init

    cfg = _small_wide_cfg()
    params = init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    frames = np.random.default_rng(5).integers(0, 256, (9, 48, 64, 3),
                                               np.uint8)
    r = cs.spec_vs_greedy(torch, np, params, cfg, ByteTokenizer(), frames,
                          "go to the door", steps=9, capacity=2048,
                          buckets=(256, 512, 1024))
    assert r["compared_calls"] == 5
    assert r["spec_forwards"] >= 1
    assert r["agreeing_positions"] >= 1


# the bf16 cache, whose rebound length makes the next replay raise, and the
# int8 cache (kv_int8), whose rebound k_scale does
@pytest.mark.parametrize("kv_int8,rebound", [(False, "length"),
                                             (True, "k_scale")],
                         ids=["bf16_cache", "kv_int8"])
def test_decode_graphs_replay_the_eager_loop(dev, kv_int8, rebound):
    """A small bf16 stack's engine on the card, greedy and speculative
    (spec_lookup=6): over 9 agent steps with a model call at each (across
    the window reset and its <memory> call), every decode forward is one
    replay of the graph captured for its loop, the tokens and the whole
    cache (values, lengths and, for kv_int8, scales) equal those of the
    same engine running its steps eagerly (cuda_graphs off), and a cache
    tensor rebound to a new tensor after capture makes the next replay
    raise."""
    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    from streamvln_tpu_torch.weights import init

    cfg = _small_wide_cfg()
    params = init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tok = ByteTokenizer()
    frames = np.random.default_rng(7 if kv_int8 else 6).integers(
        0, 256, (9, 48, 64, 3), np.uint8)
    names = ("k", "v", "length") + (("k_scale", "v_scale") if kv_int8
                                    else ())
    for spec in (0, 6):
        texts, engines = {}, {}
        for graphs in (True, False):
            eng = StreamingEngine(params, cfg, cache_capacity=2048,
                                  max_new_tokens=8, spec_lookup=spec,
                                  stop_ids=(tok.im_end_id,),
                                  buckets=(256, 512, 1024),
                                  cuda_graphs=graphs, kv_int8=kv_int8)
            agent = VLNAgent(eng, tok)
            texts[graphs] = [agent.step(0, f, "go to the door",
                                        run_model=True)[2] for f in frames]
            engines[graphs] = eng
        eng, eager = engines[True], engines[False]
        assert eng.cache.quantized == kv_int8
        assert texts[True] == texts[False], spec
        for name in names:
            assert torch.equal(getattr(eng.cache, name),
                               getattr(eager.cache, name)), (spec, name)
        assert not eager.graphs
        assert eng.decode_forwards == eager.decode_forwards > 0
        assert sum(g.replays for g in eng.graphs.values()) \
            == eng.decode_forwards
        graph = next(iter(eng.graphs.values()))
        setattr(eng.cache, rebound, getattr(eng.cache, rebound).clone())
        with pytest.raises(RuntimeError, match=f"{rebound}.*no longer hold"):
            graph.replay()


def test_a_step_that_reads_back_fails_its_capture(dev):
    """A step that reads a tensor back to the host runs in its eager
    warm-up but cannot be captured: building its graph raises."""
    from streamvln_tpu_torch.streaming import decode_graph

    def reads_back(st):
        st["more"].copy_(~st["done"].all())
        return {"logits": st["more"].float() * float(st["more"].item())}
    state = {"done": torch.zeros(2, dtype=torch.bool, device=dev),
             "more": torch.ones((), dtype=torch.bool, device=dev)}
    with pytest.raises(RuntimeError):
        decode_graph.StepGraph(reads_back, state, dict)


def test_training_kernels_match_chunked_attention_at_long_s(dev):
    """K3's output and K4/K5's dQ, dK, dV at B=1, S=8192 (8000 valid, the
    rest padding as forward_train lays it out). Query 7 sees no key: the
    kernels give 0, chunked_attention the reference's mean of v, so its
    output is skipped and its dO is 0. K3 against chunked_attention in f32
    on the same bf16 values; K4/K5 against their plain versions on the
    kernels' own LSE and Dsum, and against chunked_attention's autograd
    moved by the Dsum source: the kernels take Dsum = sum_d dO O from their
    bf16 output, autograd from the f32 one, and with eps the difference
    per row dS moves by -P eps, so dQ by -scale eps sum_k P_k K_k and dK by
    -scale sum_q P eps Q. Both at the kernels' gradient tolerance against
    their plain versions."""
    from streamvln_tpu_torch.ops.attention import chunked_attention
    rng = np.random.default_rng(9)
    B, S, n_valid, Hq, Hkv, D = 1, 8192, 8000, 8, 2, 128
    G, scale = Hq // Hkv, D ** -0.5
    q, dout = _rand(rng, (B, S, Hq, D), dev), _rand(rng, (B, S, Hq, D), dev)
    k, v = _rand(rng, (B, S, Hkv, D), dev), _rand(rng, (B, S, Hkv, D), dev)
    pos = torch.arange(S, device=dev, dtype=torch.int32)
    q_pos = torch.where(pos < n_valid, pos, 0)[None].contiguous()
    k_pos = torch.where(pos < n_valid, pos, fa.INVALID_POS)[None].contiguous()
    q_pos[0, 7] = -1
    dout[:, 7] = 0
    out, lse = fa.flash_attention_lse(q, k, v, q_pos, k_pos)
    dsum = fa._dsum(dout, out)
    args = (q, k, v, dout, lse, dsum, q_pos, k_pos)
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    assert torch.all(out[0, 7] == 0) and torch.all(dq[0, 7] == 0)

    qf, kf, vf = (x.float().requires_grad_() for x in (q, k, v))
    ref = chunked_attention(qf, kf, vf, q_pos, k_pos, q_block=1024)
    rdq, rdk, rdv = torch.autograd.grad(ref, (qf, kf, vf), dout.float())
    with torch.no_grad():
        few = chunked_attention(qf, kf, vf.abs(), q_pos, k_pos)
    seen = torch.ones(S, dtype=torch.bool, device=dev)
    seen[7] = False
    _assert_close(out[:, seen], ref.detach()[:, seen], few[:, seen])
    eps = dsum - (dout.float() * ref.detach()).sum(-1).transpose(1, 2)

    p, ds, qg, kg, dog = fa._bwd_core(q, k, v, dout, lse, dsum, q_pos, k_pos,
                                      scale, False)
    pe = p * eps.reshape(B, Hkv, G, S)[..., None]
    s_dq = torch.einsum("bhgqk,bhkd->bqhgd", pe, kg).reshape(B, S, Hq, D) \
        * scale
    s_dk = (torch.einsum("bhgqk,bqhgd->bhkd", pe, qg) * scale).transpose(1, 2)
    ds = ds.abs()
    t_dq = (torch.einsum("bhgqk,bhkd->bqhgd", ds, kg.abs())
            .reshape(B, S, Hq, D) * scale)
    t_dk = (torch.einsum("bhgqk,bqhgd->bhkd", ds, qg.abs()) * scale) \
        .transpose(1, 2)
    t_dv = torch.einsum("bhgqk,bqhgd->bhkd", p, dog.abs()).transpose(1, 2)
    del p, ds, pe
    _assert_grad_close(dq, fa.flash_bwd_dq_plain(*args), t_dq, "dq plain")
    pdk, pdv = fa.flash_bwd_dkv_plain(*args)
    _assert_grad_close(dk, pdk, t_dk, "dk plain")
    _assert_grad_close(dv, pdv, t_dv, "dv plain")
    _assert_grad_close(dq, rdq - s_dq, t_dq, "dq chunked")
    _assert_grad_close(dk, rdk - s_dk, t_dk, "dk chunked")
    _assert_grad_close(dv, rdv, t_dv, "dv chunked")


def test_prefetcher_uploads_on_a_side_stream_in_order(dev):
    """The worker copies each batch on a side stream while the consumer's
    stream is busy; get() makes the consumer's stream wait, so every batch
    read there is the batch made (a race would read a stale or partly
    copied buffer: wrong values, no error). Twenty batches of 64 MB, each
    read right after a long product on the consumer's stream."""
    from streamvln_tpu_torch.data.prefetch import BatchPrefetcher

    def make(idx):
        return {"x": np.full((16, 1 << 20), idx[0], np.float32)}
    # a generator of its own: a failed capture earlier in the process may
    # leave the default one mid-capture
    busy = torch.randn(4096, 4096, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    with BatchPrefetcher([[i] for i in range(20)], make, depth=3,
                         device=dev) as pf:
        for i in range(20):
            busy = busy @ busy
            busy /= busy.norm()
            x = pf.get()["x"]
            assert x.device.type == "cuda"
            assert x.min().item() == x.max().item() == float(i)


# The LLM families' shapes: K2/K3 at Gemma's head dim 256 (8 query heads
# on one KV head, and 6/2 and 3/3; the WIDE instance: both warpgroups on
# one 64-row tile),
# K2 at group sizes 1 (Llama-2, Qwen2-MoE: 32/32) and 5 (Qwen2-14B: 40/8),
# on the KV-major 4096-slot cache at a prefill's offset, ragged query
# tiles and prefills of one tile (64 rows, and 65: a second tile of one
# row) included; a second call bit-equal
@pytest.mark.parametrize("Sq,off,Hq,Hkv,D", [
    (768, 300, 8, 1, 256), (2560, 0, 8, 1, 256), (130, 1900, 8, 1, 256),
    (64, 300, 8, 1, 256), (65, 0, 8, 1, 256), (64, 4000, 8, 1, 256),
    (130, 700, 6, 2, 256), (700, 0, 3, 3, 256),
    (768, 300, 32, 32, 128), (700, 1000, 40, 8, 128)])
def test_flash_kernel_at_the_family_shapes(dev, Sq, off, Hq, Hkv, D):
    rng = np.random.default_rng(13)
    B, cap = 1, 4096
    q = _rand(rng, (B, Sq, Hq, D), dev)
    k, v = (_rand(rng, (B, Hkv, cap, D), dev) for _ in range(2))
    q_pos = (off + torch.arange(Sq, device=dev, dtype=torch.int32))[None]
    q_pos[0, 5] = -1                      # a row that sees no key
    k_pos = torch.arange(cap, device=dev, dtype=torch.int32)[None]
    n0 = fa.launches
    out = fa.flash_attention(q, k, v, q_pos, k_pos, kv_major=True)
    again = fa.flash_attention(q, k, v, q_pos, k_pos, kv_major=True)
    torch.cuda.synchronize()
    assert fa.launches == n0 + 2
    assert torch.equal(out, again)
    assert torch.all(out[0, 5] == 0)
    _assert_close(out, fa.flash_attention_plain(q, k, v, q_pos, k_pos,
                                                kv_major=True),
                  fa.flash_attention_plain(q, k, v.abs(), q_pos, k_pos,
                                           kv_major=True))


@pytest.mark.parametrize("S,n_valid,kv_major", [
    (200, 170, False), (384, 384, True), (4096, 3900, False), (64, 64, True),
    (65, 60, False)])
def test_flash_lse_kernel_at_head_dim_256(dev, S, n_valid, kv_major):
    """K3 at D = 256 (the same instance as K2) against its plain version,
    at Gemma-2B's training shape (S = 4096, 3,900 valid) and at one query
    tile (64 and 65 rows), a second call bit-equal, and K4 on its output
    (Gemma's training backward). Row 3 of batch 1 sees no key."""
    rng = np.random.default_rng(14)
    B, Hq, Hkv, D = 2, 8, 1, 256
    q = _rand(rng, (B, S, Hq, D), dev)
    kshape = (B, Hkv, S, D) if kv_major else (B, S, Hkv, D)
    k, v = _rand(rng, kshape, dev), _rand(rng, kshape, dev)
    q_pos, k_pos = _train_positions(B, S, S, n_valid, dev, None)
    n3 = fa.lse_launches
    out, lse = fa.flash_attention_lse(q, k, v, q_pos, k_pos,
                                      kv_major=kv_major)
    out2, lse2 = fa.flash_attention_lse(q, k, v, q_pos, k_pos,
                                        kv_major=kv_major)
    torch.cuda.synchronize()
    assert fa.lse_launches == n3 + 2
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert torch.all(out[1, 3] == 0) and torch.all(lse[1, :, 3] == fa.NEG_INF)
    ref_out, ref_lse = fa.flash_attention_lse_plain(q, k, v, q_pos, k_pos,
                                                    kv_major=kv_major)
    _assert_close(out, ref_out, fa.flash_attention_plain(
        q, k, v.abs(), q_pos, k_pos, kv_major=kv_major))
    unseen = ref_lse == fa.NEG_INF
    assert torch.equal(lse == fa.NEG_INF, unseen)
    err = (lse - ref_lse).abs()[~unseen]
    assert bool((err <= 1e-4 + 1e-5 * ref_lse.abs()[~unseen]).all())
    dout = _rand(rng, (B, S, Hq, D), dev)
    args = (q, k, v, dout, lse, fa._dsum(dout, out), q_pos, k_pos)
    dq = fa.flash_bwd_dq(*args, kv_major=kv_major)
    torch.cuda.synchronize()
    t_dq = _rounding_terms(*args, kv_major)[0]
    _assert_grad_close(dq, fa.flash_bwd_dq_plain(*args, kv_major=kv_major),
                       t_dq, "dq")


# K2 and K3 at head dim 256 captured into a CUDA graph (as the engine's
# prefill and the training step may run them) and replayed twice, each
# replay bit-equal to the eager call
@pytest.mark.parametrize("lse", [False, True])
def test_flash_kernel_d256_graph_replays_equal_eager(dev, lse):
    rng = np.random.default_rng(18)
    B, S, Hq, Hkv, D = 2, 1000, 8, 1, 256
    q = _rand(rng, (B, S, Hq, D), dev)
    k, v = (_rand(rng, (B, S, Hkv, D), dev) for _ in range(2))
    q_pos, k_pos = _train_positions(B, S, S, 900, dev, None)

    def call():
        if lse:
            return fa.flash_attention_lse(q, k, v, q_pos, k_pos)
        return (fa.flash_attention(q, k, v, q_pos, k_pos),)
    eager = call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = call()
    for _ in range(2):
        for x in outs:
            x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(outs, eager))


# K8 at the families' shapes: Gemma's head dim 256 with G = 8 (ragged
# lengths and the 4096-slot cache), G = 1 (32/32) and G = 5 (40/8) at 128;
# batches whose rows are ragged (0, 1, 63, 64, 65, 2049, 4096 live keys,
# past the capacity too) at G = 1, 5 and 8 on caches of 1024 and 4096
# slots, and long shares (Gemma's past 3584 keys at B <= 3, a 16000-key row
# at head dim 128); a second call bit-equal; f32 and G > 8 at head dim 256
# raise
_RAGGED = (0, 1, 63, 64, 65, 2049, 4096)


@pytest.mark.parametrize("Hq,Hkv,D,lengths,cap", [
    (8, 1, 256, _LENGTHS, 1024),
    (8, 1, 256, (300, 1900, 2049, 4096), 4096),
    (32, 32, 128, (300, 4096), 4096),
    (40, 8, 128, (1900, 2049), 4096),
    (8, 1, 256, _RAGGED, 1024), (8, 1, 256, _RAGGED, 4096),
    (40, 8, 128, _RAGGED, 1024), (40, 8, 128, _RAGGED, 4096),
    (32, 32, 128, _RAGGED, 1024), (32, 32, 128, _RAGGED, 4096),
    (8, 1, 256, (4096, 65), 4096), (8, 1, 256, (0, 2049), 4096),
    (8, 1, 256, (4096,), 4096), (8, 1, 256, (3585, 4096, 3600), 4096),
    (16, 1, 128, (16000,), 16384),
    (40, 8, 128, (63, 4096), 4096), (28, 4, 128, (2049, 64), 4096)])
def test_decode_kernel_at_the_family_shapes(dev, Hq, Hkv, D, lengths, cap):
    from streamvln_tpu_torch.ops import decode_attention as da
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    B = lengths.numel()
    rng = np.random.default_rng(15)
    q = _rand(rng, (B, 1, Hq, D), dev)
    k, v = (_rand(rng, (B, Hkv, cap, D), dev) for _ in range(2))
    n0 = da.launches
    out = da.decode_attention(q, k, v, lengths)
    again = da.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert da.launches == n0 + 2 and torch.equal(out, again)
    ref = da.decode_attention_plain(q.float(), k.float(), v.float(), lengths)
    assert torch.all(out[lengths == 0] == 0)
    err = (out.float() - ref).abs()
    assert bool((err <= 2.0 ** -8 * ref.abs() + 1e-5).all()), err.max()
    if D == 256:
        with pytest.raises(TypeError, match="256"):
            da.decode_attention(q.float(), k.float(), v.float(), lengths)
        wide = _rand(rng, (B, 1, 16, D), dev)
        with pytest.raises(ValueError, match="head dim"):
            da.decode_attention(wide, k, v, lengths)


# the launch plan on this card: every cluster of a launch resident in one
# wave (the card's own count of resident clusters), one block per SM as the
# card reports it, and clusters of a power of two blocks, 16 where one per
# KV head fits a wave
@pytest.mark.parametrize("B,Hq,Hkv,D,dtype,cluster", [
    (1, 8, 1, 256, torch.bfloat16, 16),
    (1, 40, 8, 128, torch.bfloat16, None),
    (1, 28, 4, 128, torch.bfloat16, 16),
    (1, 32, 32, 128, torch.bfloat16, None),
    (2, 8, 1, 256, torch.bfloat16, 16),
    (1, 16, 1, 128, torch.bfloat16, 16),
    (1, 8, 8, 128, torch.float32, None),
    (64, 28, 4, 128, torch.bfloat16, None)])
def test_decode_plan_fits_one_wave(dev, B, Hq, Hkv, D, dtype, cluster):
    from streamvln_tpu_torch.ops import decode_attention as da
    plan = da.plan(B, Hq, Hkv, 4096, D, dtype)
    rows = B * Hkv
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert 1 <= plan["cluster"] <= 16
    assert plan["cluster"] & (plan["cluster"] - 1) == 0   # a power of two
    if cluster is not None:
        assert plan["cluster"] == cluster, plan
    if rows > plan["resident_clusters"]:
        # more rows than single blocks in a wave: one block each
        assert plan["cluster"] == 1, plan
        assert plan["resident_clusters"] == sms
    assert plan["blocks_per_sm"] == 1


# K8 captured into a CUDA graph (as the decode forwards are) and replayed
# twice, each replay bit-equal to the eager call, and a replay reads the
# length as it is then
@pytest.mark.parametrize("Hq,Hkv,D,n", [(8, 1, 256, 4096), (40, 8, 128, 2049),
                                        (28, 4, 128, 300)])
def test_decode_kernel_graph_replays_equal_eager(dev, Hq, Hkv, D, n):
    from streamvln_tpu_torch.ops import decode_attention as da
    rng = np.random.default_rng(16)
    q = _rand(rng, (1, 1, Hq, D), dev)
    k, v = (_rand(rng, (1, Hkv, 4096, D), dev) for _ in range(2))
    lengths = torch.full((1,), n, dtype=torch.int32, device=dev)
    eager = da.decode_attention(q, k, v, lengths)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.decode_attention(q, k, v, lengths)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    lengths.fill_(n // 2 + 1)          # the length is read on the device
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, da.decode_attention(q, k, v, lengths))


# two streams launching K8 at once (a launch keeps no state in device
# memory): every output bit-equal to the same call alone
def test_decode_kernel_on_two_streams(dev):
    from streamvln_tpu_torch.ops import decode_attention as da
    rng = np.random.default_rng(17)
    args = []
    for n in (4096, 3000):
        q = _rand(rng, (1, 1, 8, 256), dev)
        k, v = (_rand(rng, (1, 1, 4096, 256), dev) for _ in range(2))
        args.append((q, k, v, torch.full((1,), n, dtype=torch.int32,
                                         device=dev)))
    alone = [da.decode_attention(*a) for a in args]
    streams = [torch.cuda.Stream(dev) for _ in args]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    outs = [[], []]
    for _ in range(50):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(da.decode_attention(*args[i]))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(o, alone[i]) for o in outs[i])
