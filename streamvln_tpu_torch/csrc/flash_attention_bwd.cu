// K4 and K5: the backward of the position-masked GQA flash attention
// (the training path's attention; the forward with its logsumexp is K3 in
// flash_attention.cu).
//
// K4 svt_flash_bwd_dq replaces streamvln_tpu/ops/flash_attention.py::
// _flash_bwd_dq_kernel, K5 svt_flash_bwd_dkv replaces ::_flash_bwd_dkv_kernel
// together with the sum over the G query heads of a KV head that the TPU
// wrapper does afterwards (_flash_core_bwd :474-475). Both recompute the
// scores S = Q K^T * scale tile by tile and take P = exp(S - LSE) from the
// forward's per-row logsumexp, applied only under the mask k_pos <= q_pos,
// so masked keys, padded rows and rows with no visible key (LSE = -1e30)
// give exactly P = 0. With Dsum = rowsum(dO * O) (one torch reduction in
// the wrapper, as JAX computes it outside its kernels):
//   dP = dO V^T,  dS = P * (dP - Dsum),
//   dQ = dS K * scale,  dK = dS^T Q * scale,  dV = P^T dO.
//
// K4: one block of 4 warps per (batch, q head, 64-row q tile); each warp
// keeps its 16 rows of Q and dO as mma.sync A fragments and its dQ rows in
// f32 registers, and walks the 64-key tiles (K and V staged row-major in
// shared memory), skipping a tile whose smallest key position exceeds the
// block's largest query position (the forward's early exit).
// K5: one block per (batch, KV head, 64-key tile); each warp owns 16 keys
// and keeps their dK and dV rows in f32 registers while it loops over the
// G query heads of the KV head and over their 64-row q tiles (Q and dO
// staged row-major in dynamic shared memory; same skip). dK/dV are written
// once, straight into the [B, Sk, Hkv, D] (or KV-head-major) layout: no
// per-q-head buffer and no atomics, so the result is deterministic.
//
// Operands are bf16 on mma.sync.m16n8k16 with f32 accumulation; P and dS
// are rounded to bf16 before their products (the TPU kernels upcast to
// f32). The products whose B operand is stored [k][n] (dS K, P^T dO,
// dS^T Q) read it transposed with ldmatrix.trans.
//
// Bound on the H100: per visible (query, key) pair and head the backward
// does 5 products of depth D (Q K^T, dO V^T, dS K, P^T dO, dS^T Q), i.e.
// 10*D FLOPs, against q, k, v, o, dO, dq, dk, dv and the row statistics
// in bytes; at the training shapes (S=4096, D=128, 28/4 heads) that is
// thousands of FLOPs per byte, so the tensor cores bound it. This simple
// design (mma.sync, no TMA, no pipelining, no wgmma) runs well below it.
//
// C interface (ctypes): q/dO/dQ [B, Sq, Hq, D], k/v/dK/dV [B, Sk, Hkv, D]
// or KV-head-major, all described by (batch, seq, head) strides in
// elements with a contiguous head dim; lse/dsum [B, Hq, Sq] f32
// contiguous; q_pos [B, Sq], k_pos [B, Sk] int32.
#include "attention_tile.cuh"

namespace svt {

typedef __nv_bfloat16 bf16;

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // [B, Hq, Sq]
  const float* dsum;   // [B, Hq, Sq]
  bf16* dq;
  bf16* dk;
  bf16* dv;
  const int* q_pos;    // [B, Sq]
  const int* k_pos;    // [B, Sk]
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int Sq, Sk, Hq, D, group;
  float scale;
};

// Four 8x8 bf16 matrices, each thread's fragment taken column-wise: the B
// operand of m16n8k16 for a matrix stored row-major as [k][n].
__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3,
                                              const bf16* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// Copy rows [r0, r0 + 64) of a [rows, D] tile (row stride in elements) to
// shared memory with pitch DP + 8, zero-filling rows >= n_rows and the
// padded head-dim columns.
template <int DP>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long row_stride, int r0,
                                           int n_rows, int D) {
  constexpr int CH = DP / 8, P = DP + 8;
  for (int i = threadIdx.x; i < 64 * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n_rows && c < D)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) *
                                            row_stride + c);
    *reinterpret_cast<uint4*>(&dst[r * P + c]) = val;
  }
}

// acc[n], acc[n+1] += A (16 x 16, four packed registers) times the 16 rows
// [row0, row0 + 16) of the row-major smem matrix M ([k][n], pitch P),
// columns of n-tiles n and n + 1.
template <int P>
__device__ __forceinline__ void mma_a_rowsT(float (*acc)[4], int n,
                                            const uint32_t* af,
                                            const bf16* M, int row0,
                                            int lane) {
  const int mat = lane >> 3, r = lane & 7;
  uint32_t b0, b1, b2, b3;
  ldsm_x4_trans(b0, b1, b2, b3,
                &M[(row0 + (mat & 1) * 8 + r) * P + (n + (mat >> 1)) * 8]);
  mma_bf16_16816(acc[n], af[0], af[1], af[2], af[3], b0, b1);
  mma_bf16_16816(acc[n + 1], af[0], af[1], af[2], af[3], b2, b3);
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int KC = DP / 16;   // k-chunks over the head dim
  constexpr int ND = DP / 8;    // n-tiles of dQ
  constexpr int P = DP + 8;     // smem row pitch

  __shared__ __align__(16) bf16 Ks[kBK * P];
  __shared__ __align__(16) bf16 Vs[kBK * P];
  __shared__ int kpos_s[kBK];
  __shared__ int red_s[4];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const int D = a.D;

  const bf16* qb = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* db = a.dout + b * a.do_sb + h * a.do_sh;
  const bf16* kb = a.k + b * a.k_sb + hk * a.k_sh;
  const bf16* vb = a.v + b * a.v_sb + hk * a.v_sh;

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < a.Sq, ok1 = r1 < a.Sq;

  uint32_t qf[KC][4], df[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int d0 = kc * 16 + t * 2, d1 = d0 + 8;
    qf[kc][0] = (ok0 && d0 < D) ? ld_pair(qb + r0 * a.q_ss + d0) : 0u;
    qf[kc][1] = (ok1 && d0 < D) ? ld_pair(qb + r1 * a.q_ss + d0) : 0u;
    qf[kc][2] = (ok0 && d1 < D) ? ld_pair(qb + r0 * a.q_ss + d1) : 0u;
    qf[kc][3] = (ok1 && d1 < D) ? ld_pair(qb + r1 * a.q_ss + d1) : 0u;
    df[kc][0] = (ok0 && d0 < D) ? ld_pair(db + r0 * a.do_ss + d0) : 0u;
    df[kc][1] = (ok1 && d0 < D) ? ld_pair(db + r1 * a.do_ss + d0) : 0u;
    df[kc][2] = (ok0 && d1 < D) ? ld_pair(db + r0 * a.do_ss + d1) : 0u;
    df[kc][3] = (ok1 && d1 < D) ? ld_pair(db + r1 * a.do_ss + d1) : 0u;
  }
  const long long rb = ((long long)b * a.Hq + h) * a.Sq;
  const float lse0 = ok0 ? a.lse[rb + r0] : 0.f;
  const float lse1 = ok1 ? a.lse[rb + r1] : 0.f;
  const float ds0 = ok0 ? a.dsum[rb + r0] : 0.f;
  const float ds1 = ok1 ? a.dsum[rb + r1] : 0.f;

  const int* qpb = a.q_pos + (long long)b * a.Sq;
  const int qp0 = ok0 ? qpb[r0] : 0, qp1 = ok1 ? qpb[r1] : 0;
  int qmax;
  {
    int m = INT_MIN;
    if (tid < kBQ && q0 + tid < a.Sq) m = qpb[q0 + tid];
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) red_s[warp] = m;
    __syncthreads();
    qmax = max(red_s[0], red_s[1]);   // warps 0,1 hold the rows
    __syncthreads();
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_tiles = (a.Sk + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    int kp = kInvalidPos;
    if (tid < kBK && k0 + tid < a.Sk)
      kp = a.k_pos[(long long)b * a.Sk + k0 + tid];
    if (tid < kBK) kpos_s[tid] = kp;
    const int mn = __reduce_min_sync(0xffffffffu, kp);
    if (lane == 0) red_s[warp] = mn;
    __syncthreads();
    if (min(red_s[0], red_s[1]) > qmax) {   // no key visible to the block
      __syncthreads();
      continue;
    }
    stage_rows<DP>(Ks, kb, a.k_ss, k0, a.Sk, D);
    stage_rows<DP>(Vs, vb, a.v_ss, k0, a.Sk, D);
    __syncthreads();

#pragma unroll
    for (int half = 0; half < 2; ++half) {   // 32 keys at a time
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = half * 4 + j;
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          const bf16* kr = &Ks[(n * 8 + g) * P + kc * 16 + t * 2];
          mma_bf16_16816(s[j], qf[kc][0], qf[kc][1], qf[kc][2], qf[kc][3],
                         ld_pair(kr), ld_pair(kr + 8));
          const bf16* vr = &Vs[(n * 8 + g) * P + kc * 16 + t * 2];
          mma_bf16_16816(dp[j], df[kc][0], df[kc][1], df[kc][2], df[kc][3],
                         ld_pair(vr), ld_pair(vr + 8));
        }
      }
      // P = exp(S - LSE) under the mask only; dS = P (dP - Dsum)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = (half * 4 + j) * 8 + t * 2 + (e & 1);
          const bool vis = e < 2 ? (ok0 && kpos_s[key] <= qp0)
                                 : (ok1 && kpos_s[key] <= qp1);
          const float p =
              vis ? __expf(s[j][e] * a.scale - (e < 2 ? lse0 : lse1)) : 0.f;
          s[j][e] = p * (dp[j][e] - (e < 2 ? ds0 : ds1));
        }
      }
      // dQ += dS K over this half's two 16-key chunks
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t af[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < ND; n += 2)
          mma_a_rowsT<P>(acc, n, af, Ks, half * 32 + kk * 16, lane);
      }
    }
    __syncthreads();
  }

  bf16* ob = a.dq + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = n * 8 + t * 2;
    if (d < D) {
      if (ok0)
        *reinterpret_cast<uint32_t*>(ob + r0 * a.dq_ss + d) =
            pack_bf16(acc[n][0] * a.scale, acc[n][1] * a.scale);
      if (ok1)
        *reinterpret_cast<uint32_t*>(ob + r1 * a.dq_ss + d) =
            pack_bf16(acc[n][2] * a.scale, acc[n][3] * a.scale);
    }
  }
}

template <int DP>
constexpr int dkv_smem_bytes() {
  return 4 * 64 * (DP + 8) * static_cast<int>(sizeof(bf16));
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdArgs a) {
  constexpr int KC = DP / 16;
  constexpr int ND = DP / 8;
  constexpr int P = DP + 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [64 keys][P]
  bf16* Vs = Ks + kBK * P;
  bf16* Qs = Vs + kBK * P;                         // [64 queries][P]
  bf16* Ds = Qs + kBQ * P;                         // dO
  __shared__ int qpos_s[kBQ];
  __shared__ float lse_s[kBQ];
  __shared__ float dsum_s[kBQ];
  __shared__ int red_s[4];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int D = a.D;

  // this lane's two key rows (local to the tile)
  const int kr0 = warp * 16 + g, kr1 = kr0 + 8;
  const bool kok0 = k0 + kr0 < a.Sk, kok1 = k0 + kr1 < a.Sk;
  const int* kpb = a.k_pos + (long long)b * a.Sk;
  const int kp0 = kok0 ? kpb[k0 + kr0] : kInvalidPos;
  const int kp1 = kok1 ? kpb[k0 + kr1] : kInvalidPos;

  stage_rows<DP>(Ks, a.k + b * a.k_sb + hk * a.k_sh, a.k_ss, k0, a.Sk, D);
  stage_rows<DP>(Vs, a.v + b * a.v_sb + hk * a.v_sh, a.v_ss, k0, a.Sk, D);
  int kmin;
  {
    int kp = kInvalidPos;
    if (tid < kBK && k0 + tid < a.Sk) kp = kpb[k0 + tid];
    kp = __reduce_min_sync(0xffffffffu, kp);
    if (lane == 0) red_s[warp] = kp;
    __syncthreads();
    kmin = min(red_s[0], red_s[1]);
    __syncthreads();
  }

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  const int n_qt = (a.Sq + kBQ - 1) / kBQ;
  for (int j = 0; j < a.group; ++j) {
    const int h = hk * a.group + j;
    const bf16* qb = a.q + b * a.q_sb + h * a.q_sh;
    const bf16* db = a.dout + b * a.do_sb + h * a.do_sh;
    const long long rb = ((long long)b * a.Hq + h) * a.Sq;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      int qp = INT_MIN;
      if (tid < kBQ) {
        const bool ok = q0 + tid < a.Sq;
        if (ok) qp = a.q_pos[(long long)b * a.Sq + q0 + tid];
        qpos_s[tid] = qp;
        lse_s[tid] = ok ? a.lse[rb + q0 + tid] : 0.f;
        dsum_s[tid] = ok ? a.dsum[rb + q0 + tid] : 0.f;
      }
      qp = __reduce_max_sync(0xffffffffu, qp);
      if (lane == 0) red_s[warp] = qp;
      __syncthreads();
      if (kmin > max(red_s[0], red_s[1])) {   // no key of the tile is seen
        __syncthreads();
        continue;
      }
      stage_rows<DP>(Qs, qb, a.q_ss, q0, a.Sq, D);
      stage_rows<DP>(Ds, db, a.do_ss, q0, a.Sq, D);
      __syncthreads();

#pragma unroll
      for (int half = 0; half < 2; ++half) {   // 32 queries at a time
        float st[4][4], dpt[4][4];   // S^T, dP^T: [this warp's 16 keys, 32 q]
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          st[jn][0] = st[jn][1] = st[jn][2] = st[jn][3] = 0.f;
          dpt[jn][0] = dpt[jn][1] = dpt[jn][2] = dpt[jn][3] = 0.f;
        }
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          const int c = kc * 16 + t * 2;
          const uint32_t ka0 = ld_pair(&Ks[kr0 * P + c]);
          const uint32_t ka1 = ld_pair(&Ks[kr1 * P + c]);
          const uint32_t ka2 = ld_pair(&Ks[kr0 * P + c + 8]);
          const uint32_t ka3 = ld_pair(&Ks[kr1 * P + c + 8]);
          const uint32_t va0 = ld_pair(&Vs[kr0 * P + c]);
          const uint32_t va1 = ld_pair(&Vs[kr1 * P + c]);
          const uint32_t va2 = ld_pair(&Vs[kr0 * P + c + 8]);
          const uint32_t va3 = ld_pair(&Vs[kr1 * P + c + 8]);
#pragma unroll
          for (int jn = 0; jn < 4; ++jn) {
            const int qrow = (half * 4 + jn) * 8 + g;
            const bf16* qr = &Qs[qrow * P + c];
            mma_bf16_16816(st[jn], ka0, ka1, ka2, ka3, ld_pair(qr),
                           ld_pair(qr + 8));
            const bf16* dr = &Ds[qrow * P + c];
            mma_bf16_16816(dpt[jn], va0, va1, va2, va3, ld_pair(dr),
                           ld_pair(dr + 8));
          }
        }
        // P^T under the mask only; dS^T = P^T (dP^T - Dsum)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ql = (half * 4 + jn) * 8 + t * 2 + (e & 1);
            const int qpos = qpos_s[ql];
            const bool vis = q0 + ql < a.Sq &&
                             (e < 2 ? kp0 : kp1) <= qpos;
            const float p =
                vis ? __expf(st[jn][e] * a.scale - lse_s[ql]) : 0.f;
            st[jn][e] = p;
            dpt[jn][e] = p * (dpt[jn][e] - dsum_s[ql]);
          }
        }
        // dV += P^T dO, dK += dS^T Q over this half's two 16-query chunks
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint32_t pa[4] = {
              pack_bf16(st[2 * kk][0], st[2 * kk][1]),
              pack_bf16(st[2 * kk][2], st[2 * kk][3]),
              pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
              pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
          const uint32_t sa[4] = {
              pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
              pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
              pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
              pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
          const int row0 = half * 32 + kk * 16;
#pragma unroll
          for (int n = 0; n < ND; n += 2) {
            mma_a_rowsT<P>(dv, n, pa, Ds, row0, lane);
            mma_a_rowsT<P>(dk, n, sa, Qs, row0, lane);
          }
        }
      }
      __syncthreads();
    }
  }

  bf16* kout = a.dk + b * a.dk_sb + hk * a.dk_sh;
  bf16* vout = a.dv + b * a.dv_sb + hk * a.dv_sh;
  const long long gk0 = k0 + kr0, gk1 = k0 + kr1;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = n * 8 + t * 2;
    if (d < D) {
      if (kok0) {
        *reinterpret_cast<uint32_t*>(kout + gk0 * a.dk_ss + d) =
            pack_bf16(dk[n][0] * a.scale, dk[n][1] * a.scale);
        *reinterpret_cast<uint32_t*>(vout + gk0 * a.dv_ss + d) =
            pack_bf16(dv[n][0], dv[n][1]);
      }
      if (kok1) {
        *reinterpret_cast<uint32_t*>(kout + gk1 * a.dk_ss + d) =
            pack_bf16(dk[n][2] * a.scale, dk[n][3] * a.scale);
        *reinterpret_cast<uint32_t*>(vout + gk1 * a.dv_ss + d) =
            pack_bf16(dv[n][2], dv[n][3]);
      }
    }
  }
}

template <int DP>
cudaError_t launch_bwd(const BwdArgs& a, int B, int Hkv, bool dkv,
                       cudaStream_t stream) {
  if (!dkv) {
    dim3 grid((a.Sq + kBQ - 1) / kBQ, a.Hq, B);
    flash_bwd_dq_kernel<DP><<<grid, kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  constexpr int smem = dkv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sk + kBK - 1) / kBK, Hkv, B);
  flash_bwd_dkv_kernel<DP><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace svt

static int flash_backward(bool dkv, const void* q, const void* k,
                          const void* v, const void* dout, const void* lse,
                          const void* dsum, void* dq, void* dk, void* dv,
                          const void* q_pos, const void* k_pos,
                          const long long* st, int B, int Sq, int Sk, int Hq,
                          int Hkv, int D, float scale, void* stream) {
  using svt::bf16;
  svt::BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<const float*>(dsum);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.q_pos = static_cast<const int*>(q_pos);
  a.k_pos = static_cast<const int*>(k_pos);
  long long* f[] = {&a.q_sb, &a.q_ss, &a.q_sh, &a.k_sb, &a.k_ss, &a.k_sh,
                    &a.v_sb, &a.v_ss, &a.v_sh, &a.do_sb, &a.do_ss, &a.do_sh,
                    &a.dq_sb, &a.dq_ss, &a.dq_sh, &a.dk_sb, &a.dk_ss,
                    &a.dk_sh, &a.dv_sb, &a.dv_ss, &a.dv_sh};
  for (int i = 0; i < 21; ++i) *f[i] = st[i];
  a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.D = D; a.group = Hq / Hkv;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 64: return svt::launch_bwd<64>(a, B, Hkv, dkv, s);
    case 128: return svt::launch_bwd<128>(a, B, Hkv, dkv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K4. strides: 21 (batch, seq, head) triples in the order q, k, v, dO, dQ,
// dK, dV (the dK/dV triples are unused here).
extern "C" int svt_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* dq,
    const void* q_pos, const void* k_pos, const long long* strides,
    int B, int Sq, int Sk, int Hq, int Hkv, int D, float scale,
    void* stream) {
  return flash_backward(false, q, k, v, dout, lse, dsum, dq, nullptr,
                        nullptr, q_pos, k_pos, strides, B, Sq, Sk, Hq, Hkv,
                        D, scale, stream);
}

// K5. strides as for K4 (the dQ triple is unused here).
extern "C" int svt_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* dk, void* dv,
    const void* q_pos, const void* k_pos, const long long* strides,
    int B, int Sq, int Sk, int Hq, int Hkv, int D, float scale,
    void* stream) {
  return flash_backward(true, q, k, v, dout, lse, dsum, nullptr, dk, dv,
                        q_pos, k_pos, strides, B, Sq, Sk, Hq, Hkv, D, scale,
                        stream);
}
