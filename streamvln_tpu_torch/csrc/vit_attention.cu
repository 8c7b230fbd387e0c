// K1: whole-sequence bidirectional attention for the vision tower.
//
// Replaces streamvln_tpu/ops/vit_attention.py::_kernel (the Pallas kernel
// that keeps one (batch, head)'s whole score matrix in VMEM). On the H100
// that matrix does not fit a block's shared memory (729 x 729 f32 is
// 2.1 MB against 227 KB), so the port streams 64-key tiles through shared
// memory with an online softmax and never writes scores to device memory.
//
// Bound on the H100: at SigLIP shapes (S=729, H=16, D=72) one frame-layer
// does 4*S^2*D*H = 2.4 GFLOP against 4*S*H*D*2 = 6.7 MB of q/k/v/o
// traffic, ~360 FLOP/byte: above the card's ~295 bf16 ridge, so the
// tensor-core rate bounds it. The design (attention_fwd.cuh) feeds the
// tensor cores through wgmma from TMA-loaded, swizzled tiles that a
// producer warp keeps in flight behind mbarriers, so loads overlap the
// products; tiles with no ragged tail take no per-element mask. D=72 is
// padded to 80 (a 64-column and a 16-column chunk; the padding is 11% of
// the products). Blocks take 128-row query tiles (two consumer
// warpgroups sharing each K/V tile) at every batch; at batch 1 that is
// 6 x 16 = 96 blocks for the card's 132 SMs.
//
// C interface (ctypes): q/k/v/o are [B, S, H, D] bf16 with the head dim
// contiguous; strides are in elements and multiples of 8 (TMA needs
// 16-byte strides). D is 72 (SigLIP, padded to 80) or 64 (CLIP); any other
// D, or a layout the tensor maps refuse, returns cudaErrorInvalidValue.
#include "attention_fwd.cuh"

extern "C" int svt_vit_attention(
    const void* q, const void* k, const void* v, void* o,
    long long sb, long long ss, long long sh,
    long long o_sb, long long o_ss, long long o_sh,
    int B, int S, int H, int D, float scale, void* stream) {
  svt::FwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = nullptr;
  a.q_pos = nullptr;
  a.k_pos = nullptr;
  a.q_sb = a.k_sb = a.v_sb = sb;
  a.q_ss = a.k_ss = a.v_ss = ss;
  a.q_sh = a.k_sh = a.v_sh = sh;
  a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.B = B; a.Sq = S; a.Sk = S; a.Hq = H; a.Hkv = H; a.D = D;
  a.scale = scale;
  a.soft_cap = 0.f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return svt::attention_forward<64>(a, st);
    case 72: return svt::attention_forward<80>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
