// K1: whole-sequence bidirectional attention for the vision tower.
//
// Replaces streamvln_tpu/ops/vit_attention.py::_kernel (the Pallas kernel
// that keeps one (batch, head)'s whole score matrix in VMEM). On the H100
// that matrix does not fit a block's shared memory (729 x 729 f32 is
// 2.1 MB against 227 KB), so the port streams 64-key tiles through shared
// memory with an online softmax (attention_tile.cuh) and never writes
// scores to device memory.
//
// Bound on the H100: at SigLIP shapes (S=729, H=16, D=72) one frame-layer
// does 4*S^2*D*H = 2.4 GFLOP against 4*S*H*D*2 = 6.7 MB of q/k/v/o
// traffic, ~360 FLOP/byte: above the card's ~295 bf16 ridge, so the
// tensor-core rate bounds it. The simple design uses mma.sync (not wgmma)
// and pads D=72 to 80, so it runs well below that peak.
//
// C interface (ctypes): q/k/v/o are [B, S, H, D] bf16 with the head dim
// contiguous; strides are in elements. D is 72 (SigLIP, padded to 80) or
// 64 (CLIP); any other D returns cudaErrorInvalidValue.
#include "attention_tile.cuh"

extern "C" int svt_vit_attention(
    const void* q, const void* k, const void* v, void* o,
    long long sb, long long ss, long long sh,
    long long o_sb, long long o_ss, long long o_sh,
    int B, int S, int H, int D, float scale, void* stream) {
  svt::AttnArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.q_pos = nullptr;
  a.k_pos = nullptr;
  a.q_sb = a.k_sb = a.v_sb = sb;
  a.q_ss = a.k_ss = a.v_ss = ss;
  a.q_sh = a.k_sh = a.v_sh = sh;
  a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.Sq = S; a.Sk = S; a.D = D; a.group = 1;
  a.scale = scale;
  a.soft_cap = 0.f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return svt::launch_attention<64>(a, B, H, st);
    case 72: return svt::launch_attention<80>(a, B, H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
