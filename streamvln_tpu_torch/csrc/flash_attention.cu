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
// D=128, GQA 28/4) and in training (S=4096) that is hundreds to thousands
// of FLOPs per byte, so the tensor cores bound it. The design
// (attention_fwd.cuh): wgmma on TMA-loaded, swizzled K/V tiles that a
// producer warp keeps in flight behind mbarriers (loads overlap the
// products, V is read transposed by the tensor cores), 128-row blocks of
// two consumer warpgroups that share each K/V tile, no per-element mask on
// tiles wholly below the diagonal, and the query tiles that see the most
// keys started first, so the short tiles fill the last wave.
//
// C interface (ctypes): q/o are [B, Sq, Hq, D]; k/v are [B, Hkv, Sk, D]
// (kv_major, the cache layout) or [B, Sk, Hkv, D], described by strides
// in elements (multiples of 8); q_pos [B, Sq], k_pos [B, Sk] int32; lse
// [B, Hq, Sq] f32.
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
