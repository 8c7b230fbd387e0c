// Shared tile machinery of the port's two attention kernels
// (vit_attention.cu, flash_attention.cu).
//
// One thread block of 4 warps owns a 64-row query tile of one
// (batch, query head). Each warp owns 16 query rows and keeps them, the
// running row max / row sum and the f32 output accumulator in registers.
// The block walks the keys in 64-key tiles: K is staged row-major and V
// transposed in shared memory, S = Q K^T and O += P V run on the tensor
// cores through mma.sync.m16n8k16 (bf16 operands, f32 accumulation), and
// the softmax is the online (running-max) form, so the score matrix never
// leaves registers whatever the sequence length.
//
// Numerics: scores are scaled in f32 after the bf16 product; P is rounded
// to bf16 before the PV product (f32 accumulation); the output is scaled
// by 1/rowsum once at the end (deferred normalisation). Masked scores are
// set to -1e30, and a row whose running max never rose above -5e29 (no
// visible key) is written as exact zeros. When `lse` is set (K3, the
// training forward) each row's logsumexp m + log(l) of the scaled scores
// is written too, -1e30 for a row with no visible key.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace svt {

constexpr int kBQ = 64;            // query rows per block (4 warps x 16)
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr int kInvalidPos = 1 << 30;

struct AttnArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse = nullptr;  // [B, Hq, Sq] f32 or null (no logsumexp)
  const int* q_pos;   // [B, Sq] or null (full attention)
  const int* k_pos;   // [B, Sk] or null
  // element strides; the head dim is contiguous
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int Sq, Sk, D, group;  // group = Hq / Hkv
  float scale;
  float soft_cap;        // <= 0: none
};

__device__ __forceinline__ void mma_bf16_16816(float* c, uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// DP: head dim padded to a multiple of 16 (zero columns are exact: they
// add nothing to q.k and give output columns that are never stored).
template <int DP>
__global__ void __launch_bounds__(kThreads)
attention_tile_kernel(AttnArgs a) {
  constexpr int KC = DP / 16;      // k-chunks of the QK^T product
  constexpr int ND = DP / 8;       // n-tiles of the output
  constexpr int NS = kBK / 8;      // n-tiles of the score tile
  constexpr int KS = DP + 8;       // smem row pitch of K (bank spread)
  constexpr int VS = kBK + 8;      // smem row pitch of V^T

  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * KS];
  __shared__ __align__(16) __nv_bfloat16 Vt[DP * VS];
  __shared__ int kpos_s[kBK];
  __shared__ int red_s[4];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const int D = a.D;

  const __nv_bfloat16* qb = a.q + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kb = a.k + b * a.k_sb + hk * a.k_sh;
  const __nv_bfloat16* vb = a.v + b * a.v_sb + hk * a.v_sh;

  // this lane's two query rows
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < a.Sq, ok1 = r1 < a.Sq;

  // Q fragments straight from global memory, once
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int d0 = kc * 16 + t * 2, d1 = d0 + 8;
    qf[kc][0] = (ok0 && d0 < D) ? ld_pair(qb + r0 * a.q_ss + d0) : 0u;
    qf[kc][1] = (ok1 && d0 < D) ? ld_pair(qb + r1 * a.q_ss + d0) : 0u;
    qf[kc][2] = (ok0 && d1 < D) ? ld_pair(qb + r0 * a.q_ss + d1) : 0u;
    qf[kc][3] = (ok1 && d1 < D) ? ld_pair(qb + r1 * a.q_ss + d1) : 0u;
  }

  const bool use_pos = a.q_pos != nullptr;
  int qp0 = 0, qp1 = 0, qmax = 0;
  if (use_pos) {
    const int* qpb = a.q_pos + (long long)b * a.Sq;
    qp0 = ok0 ? qpb[r0] : 0;
    qp1 = ok1 ? qpb[r1] : 0;
    // max query position over the block's real rows
    int m = INT_MIN;
    if (tid < kBQ && q0 + tid < a.Sq) m = qpb[q0 + tid];
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) red_s[warp] = m;
    __syncthreads();
    qmax = max(max(red_s[0], red_s[1]), max(red_s[2], red_s[3]));
    __syncthreads();
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int n_tiles = (a.Sk + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    if (use_pos) {
      // per-tile early exit: skip a tile none of whose keys is visible
      // to any query of the block (keeps prefill over a large cache
      // proportional to the live prefix)
      int kp = kInvalidPos;
      if (tid < kBK && k0 + tid < a.Sk)
        kp = a.k_pos[(long long)b * a.Sk + k0 + tid];
      if (tid < kBK) kpos_s[tid] = kp;
      int mn = __reduce_min_sync(0xffffffffu, kp);
      if (lane == 0) red_s[warp] = mn;
      __syncthreads();
      const int kmin = min(red_s[0], red_s[1]);  // warps 0,1 hold keys
      if (kmin > qmax) {
        __syncthreads();
        continue;
      }
    }

    // stage K (row-major) and V (transposed), 16-byte loads, zero tail
    constexpr int CH = DP / 8;   // 8-element chunks per row
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < a.Sk && c < D) {
        kv = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * a.k_ss + c);
        vv = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * a.v_ss + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r * KS + c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * VS + r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const __nv_bfloat16* kr = &Ks[(n * 8 + g) * KS + kc * 16 + t * 2];
        mma_bf16_16816(s[n], qf[kc][0], qf[kc][1], qf[kc][2], qf[kc][3],
                       ld_pair(kr), ld_pair(kr + 8));
      }
    }

    // scale, soft cap, mask; tile row max
    float tm0 = kNegInf, tm1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + t * 2 + (e & 1);
        float x = s[n][e] * a.scale;
        if (a.soft_cap > 0.f) x = tanhf(x / a.soft_cap) * a.soft_cap;
        bool vis;
        if (use_pos) {
          vis = kpos_s[key] <= (e < 2 ? qp0 : qp1);
        } else {
          vis = k0 + key < a.Sk;
        }
        x = vis ? x : kNegInf;
        s[n][e] = x;
        if (e < 2) tm0 = fmaxf(tm0, x); else tm1 = fmaxf(tm1, x);
      }
    }
    tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, 1));
    tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, 2));
    tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, 1));
    tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, 2));
    const float mn0 = fmaxf(m0, tm0), mn1 = fmaxf(m1, tm1);
    const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = __expf(s[n][0] - mn0);
      s[n][1] = __expf(s[n][1] - mn0);
      s[n][2] = __expf(s[n][2] - mn1);
      s[n][3] = __expf(s[n][3] - mn1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * al0 + ps0;   // per-lane partial; reduced over t at the end
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= al0; acc[n][1] *= al0;
      acc[n][2] *= al1; acc[n][3] *= al1;
    }

    // O += P V: the score accumulators of two adjacent key n-tiles are
    // exactly the A fragment of one 16-key chunk
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t p0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t p1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t p2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t p3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vr = &Vt[(n * 8 + g) * VS + kk * 16 + t * 2];
        mma_bf16_16816(acc[n], p0, p1, p2, p3, ld_pair(vr), ld_pair(vr + 8));
      }
    }
    __syncthreads();
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const bool v0 = m0 > kNegInf * 0.5f, v1 = m1 > kNegInf * 0.5f;
  const float inv0 = (v0 && l0 > 0.f) ? 1.f / l0 : 0.f;
  const float inv1 = (v1 && l1 > 0.f) ? 1.f / l1 : 0.f;

  if (a.lse != nullptr && t == 0) {
    float* lb = a.lse + ((long long)b * gridDim.y + h) * a.Sq;
    if (ok0) lb[r0] = (v0 && l0 > 0.f) ? m0 + logf(l0) : kNegInf;
    if (ok1) lb[r1] = (v1 && l1 > 0.f) ? m1 + logf(l1) : kNegInf;
  }

  __nv_bfloat16* ob = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = n * 8 + t * 2;
    if (d < D) {
      if (ok0)
        *reinterpret_cast<uint32_t*>(ob + r0 * a.o_ss + d) =
            pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
      if (ok1)
        *reinterpret_cast<uint32_t*>(ob + r1 * a.o_ss + d) =
            pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
    }
  }
}

template <int DP>
inline cudaError_t launch_attention(const AttnArgs& a, int B, int Hq,
                                    cudaStream_t stream) {
  dim3 grid((a.Sq + kBQ - 1) / kBQ, Hq, B);
  attention_tile_kernel<DP><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace svt
