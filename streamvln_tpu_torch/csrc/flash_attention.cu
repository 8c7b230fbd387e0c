// K2: causal-by-position GQA flash attention for the decoder prefill, and
// K3: the same forward that also writes each row's logsumexp (training).
//
// K2 replaces streamvln_tpu/ops/flash_attention.py::_flash_kernel, K3
// replaces ::_flash_kernel_lse. Key j is visible to query i iff
// k_pos[j] <= q_pos[i], the KV head is h // group, and a key tile whose
// smallest position exceeds the block's largest query position is skipped.
// The engine passes k_pos = arange(capacity) over the whole cache, so the
// skip keeps a prefill's cost proportional to the live prefix, not to the
// 4096-slot capacity; in training the same skip drops the tiles above the
// causal diagonal and the padded key tail. Rows with no visible key are
// written as exact zeros (and, for K3, an LSE of -1e30); an optional tanh
// soft cap is applied before the mask (K2 only: the training path refuses
// it, as the TPU backward does).
//
// Bound on the H100: the work is 4*Sq*Sk_visible*D*Hq FLOPs against
// q + visible k/v + o bytes; at the main path's prefill (Sq >= 256,
// D=128, GQA 28/4; Gemma's D=256, 8/1) and in training (S=4096) that is
// hundreds to thousands of FLOPs per byte, so the tensor cores bound it.
// Head dims 64, 128 and 256. The design (attention_fwd.cuh): wgmma on
// TMA-loaded, swizzled K/V tiles that one warp keeps in flight behind
// mbarriers (loads overlap the products, V is read transposed by the
// tensor cores), 128-row blocks of two consumer warpgroups that share
// each K/V tile, masks of the key tiles a block visits and of the full
// ones written before its walk by the consumers' eight warps (no position
// of a skipped or full tile is loaded on the way, and the walk ends at
// the last visited tile), no per-element mask on full tiles, and the
// query tiles that see the most keys started first, so the short tiles
// fill the last wave. At D = 128 the shape picks 128-key tiles (3
// stages) or 64-key ones (4), for K2 and K3 alike
// (attention_plan.cuh::fwd_keys128), so both give the same output on the
// same inputs. At D = 256 (Gemma)
// a 64-row O is 128 f32 registers a thread, and a 384-thread block caps a
// thread at 168: WIDE takes 64-row tiles on which both warpgroups compute
// the whole S and softmax and each holds half of O's columns.
//
// C interface (ctypes): q/o are [B, Sq, Hq, D]; k/v are [B, Hkv, Sk, D]
// (kv_major, the cache layout) or [B, Sk, Hkv, D], described by strides
// in elements (multiples of 8); q_pos [B, Sq], k_pos [B, Sk] int32; lse
// [B, Hq, Sq] f32. Sk is at most the instance's FwdShape::MAX_KEYS (the
// tile masks beside the ring: at D = 128 208,896 on 128-key tiles, past
// which the 64-key instance takes the call; 301,056 at 256); more returns
// cudaErrorInvalidValue.
#include "attention_fwd.cuh"

static int flash_forward(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const void* q_pos, const void* k_pos,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int B, int Sq, int Sk, int Hq, int Hkv, int D,
    float scale, float soft_cap, void* stream) {
  svt::FwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = lse;
  a.q_pos = static_cast<const int*>(q_pos);
  a.k_pos = static_cast<const int*>(k_pos);
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv; a.D = D;
  a.scale = scale;
  a.soft_cap = soft_cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64: return svt::attention_forward<64>(a, st);
    case 128: return svt::attention_forward<128>(a, st);
    case 256: return svt::attention_forward<256>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int svt_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    const void* q_pos, const void* k_pos,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int B, int Sq, int Sk, int Hq, int Hkv, int D,
    float scale, float soft_cap, void* stream) {
  return flash_forward(q, k, v, o, nullptr, q_pos, k_pos, q_sb, q_ss, q_sh,
                       k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                       B, Sq, Sk, Hq, Hkv, D, scale, soft_cap, stream);
}

// K3: as K2 without the soft cap, plus lse [B, Hq, Sq] f32 (contiguous).
extern "C" int svt_flash_attention_lse(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_pos, const void* k_pos,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int B, int Sq, int Sk, int Hq, int Hkv, int D,
    float scale, void* stream) {
  return flash_forward(q, k, v, o, static_cast<float*>(lse), q_pos, k_pos,
                       q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                       o_sb, o_ss, o_sh, B, Sq, Sk, Hq, Hkv, D, scale, 0.f,
                       stream);
}

// The key-tile width K2 and K3 take at this shape (keys a tile; -1 for a
// head dim they do not take).
extern "C" int svt_flash_key_tile(int B, int Sq, int Sk, int Hq, int D,
                                  int pos) {
  switch (D) {
    case 64: return svt::FwdShape<64>::BN;
    case 128: return svt::fwd_keys128(Sq, Sk, Hq * B, pos != 0)
                         ? svt::FwdShape<128, true>::BN
                         : svt::FwdShape<128>::BN;
    case 256: return svt::FwdShape<256>::BN;
    default: return -1;
  }
}
