// K6 and K7: products with packed-int4 weights, for Hopper (sm_90a).
//
// K6 (svt_int4_matmul) replaces streamvln_tpu/ops/int4_matmul.py::_kernel:
// out[M, dout] (f32) = x[M, din] @ dequant(W), with W packed uint8
// [din/2, dout] (byte r: row 2r in the low nibble, row 2r+1 in the high
// one, both signed) and f32 scales [din/64, dout]. Each weight is
// nibble * scale in f32, rounded once to x's type (bf16 or f32), then
// multiplied into an f32 sum, as the TPU kernel does.
//
// Bound on the H100: at decode (M = 1) every packed byte is read once for
// two multiply-adds, far below the card's ridge: device memory bounds it
// (3.35 TB/s), provided enough bytes are in flight on every SM and the
// dequant arithmetic per byte stays under the memory time. Up to M = 128
// the bytes still bound it, if each weight is dequantized once for all
// rows.
//
// Design (bf16 x):
// - A block owns 128 output columns and a run of 64-row scale groups. The
//   split of one column tile's groups over blocks (kernel_plan.cuh) gives
//   at least four blocks per SM at one row (two above) at every main-path
//   shape. The producer warp streams each group's 32 packed rows (128
//   bytes each), its 128 scales and x's 64 columns of every row into a ring
//   of stages in shared memory with 16-byte asynchronous copies (cp.async,
//   LDGSTS; no tensor map to encode on the host), each stage completing on
//   an mbarrier when every producer lane's copies have landed; the
//   consumer warps release it on a second mbarrier. (1-D bulk copies, one
//   per 128-byte row, ran at ~0.75 TB/s: about 50 cycles per copy per SM.)
// - The product runs on the tensor cores (mma.sync m16n8k16): the weights
//   are the A operand (output columns as rows, the contraction as depth),
//   x the B operand (its rows as the 8 columns of an n-tile). A packed byte
//   holds the two adjacent depths of one A register, so a byte dequantizes
//   into one register: each nibble becomes an exact float in one LOP3 and
//   one FADD (nibble_at), then two f32 multiplies by the scale and one
//   cvt.rn.bf16x2.f32. A consumer warp owns 16 MT columns (MT m-tiles): one
//   shared load of 2 MT bytes of a packed row gives rows g and g + 8 of
//   each m-tile, and packed rows are padded to 160 bytes so that a warp's
//   loads fall on distinct banks.
// - x stays in shared memory (ldmatrix), so each weight is dequantized once
//   for all M <= 128 rows: one n-tile of 8 rows at M <= 8 (decode), sixteen
//   above.
// - The splits of one column tile form a thread-block cluster. Block z
//   owns slice z of the tile's M x 128 outputs; every block sends its f32
//   partial of each slice from registers into the owner's receive area with
//   st.async (distributed shared memory), which completes on the owner's
//   own mbarrier, and each owner sums its slice over the splits in split
//   order. No cluster barrier at the end (the one barrier, split, orders
//   the mbarrier inits before the first send). One launch, a fixed order
//   (two calls are bit-equal), and no buffer but the output.
// f32 x (tests) takes a plain CUDA-core kernel: one output column per
// thread over the whole contraction in order.
//
// K7 (svt_int4_dequant_split) replaces _dequant_kernel: one layer to
// [2, din/2, dout] in x's type, low-nibble rows then high-nibble rows,
// each value nibble * scale (f32) rounded once. A pure streaming pass
// (0.5 B + scales read, 2 x 2 B written per byte in bf16): one thread per
// 16 packed bytes, 16-byte loads and stores.
//
// C interface (ctypes): pointers are to one layer's slice; the wrapper
// checks shapes (din, dout multiples of 512; M <= 128 for bf16), types,
// contiguity and 16-byte alignment, and allocates `out`. Entries return
// the CUDA error of their launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_plan.cuh"
#include "pipeline.cuh"

namespace svt {
// Internal linkage: the library exports its C entry points only, so no
// instantiation or static local of the shared headers' templates is merged
// with another loaded library's (decode_attention.cu includes them too).
namespace {

constexpr int GROUP_ROWS = kI4GroupRows;   // packed rows per scale group
constexpr int K6_MAX_ROWS = 128;

// signed nibble (u in 0..15, two's complement) as an exact float:
// (u ^ 8) - 8 == q, and 0x4B000000 | k is the float 2^23 + k
__device__ __forceinline__ float nibble_to_f(uint32_t u) {
  return __int_as_float(0x4B000000u | (u ^ 8u)) - 8388616.0f;
}

__device__ __forceinline__ void load_scales16(const float* p, float* sc) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 f = __ldg(p4 + i);
    sc[4 * i] = f.x; sc[4 * i + 1] = f.y;
    sc[4 * i + 2] = f.z; sc[4 * i + 3] = f.w;
  }
}

// The signed nibble at bit p (p + 3 <= 22) of w as an exact float, in one
// LOP3 and one FADD: under the exponent of 2^(23 - p) the nibble's bits are
// mantissa bits of weight 1, so (w & 0xF << p) ^ (2^(23 - p) | 8 << p) is
// the float 2^(23 - p) + q + 8 (the XOR turns two's complement q into
// q + 8), and subtracting 2^(23 - p) + 8 leaves q.
__device__ __forceinline__ float nibble_at(uint32_t w, int p) {
  const uint32_t e = (150u - p) << 23;         // the bits of 2^(23 - p)
  return __uint_as_float((w & (0xFu << p)) ^ (e | (8u << p)))
      - (__uint_as_float(e) + 8.f);
}

// The 2 MT bytes of one packed row that a thread holds (MT = 1: the low 16
// bits of w) with their scales sc[0..2 MT - 1]: d[b] = (low nibble, high
// nibble) * sc[b] in f32, rounded once to bf16, the low nibble (the even
// depth) in the low half. Nibbles at bits 20, 24 and 28 come from w >> 20.
template <int MT>
__device__ __forceinline__ void dequant(uint32_t w, const float* sc,
                                        uint32_t* d) {
  float q[4 * MT];
  q[0] = nibble_at(w, 0);
  q[1] = nibble_at(w, 4);
  q[2] = nibble_at(w, 8);
  q[3] = nibble_at(w, 12);
  if constexpr (MT == 2) {
    const uint32_t v = w >> 20;
    q[4] = nibble_at(w, 16);
    q[5] = nibble_at(v, 0);
    q[6] = nibble_at(v, 4);
    q[7] = nibble_at(v, 8);
  }
#pragma unroll
  for (int b = 0; b < 2 * MT; ++b)
    d[b] = pack_bf16x2(q[2 * b] * sc[b], q[2 * b + 1] * sc[b]);
}

// The bf16 kernel with NT n-tiles (8 x rows each; NT = 1 at M <= 8, else
// 16): its consumer warps own MT m-tiles (16 MT columns) each, one m-tile
// at NT = 1 (eight warps, so that more of them hide the dequant's latency),
// two at NT = 16 (four warps, each x fragment feeding two tiles); the
// producer is the last warp.
template <int NT>
struct I4Shape {
  static_assert(NT == 1 || NT == 16, "one n-tile, or the kernel's 128 rows");
  static constexpr int MT = NT == 16 ? 2 : 1;
  static constexpr int CW = 8 / MT;                        // consumer warps
  static constexpr int THREADS = 32 * (CW + 1);
  static constexpr int W_ROW = 160;        // a packed row's 128 B, padded
  static constexpr int X_ROW = 144;        // an x row's 64 bf16, padded
  static constexpr int S_OFF = GROUP_ROWS * W_ROW;
  static constexpr int X_OFF = S_OFF + kI4Cols * 4;
  static constexpr int STAGE = X_OFF + NT * 8 * X_ROW;
  static constexpr int ST = NT == 1 ? 8 : 4;                // stages
  static constexpr int BAR_OFF = ST * STAGE;   // full, empty, receive
  static constexpr int RECV_OFF = BAR_OFF + 16 * ST + 16;
  // with splits: the receive area, splits x slot_floats(M, splits) floats
  static constexpr int SMEM_MAX =
      RECV_OFF + 4 * (NT * 8 * kI4Cols + 2 * kI4Cluster);
  static_assert(STAGE % 16 == 0, "stages on 16-byte boundaries");
};

// Slice z of a tile's M x 128 outputs (in pairs of columns, so that a
// thread's two adjacent columns go to one owner): [2 floor(E2 z / ks),
// 2 floor(E2 (z + 1) / ks)) with E2 = 64 M pairs; the receive area keeps
// one slot of slot_floats per split.
__host__ __device__ __forceinline__ int slot_floats(int M, int ks) {
  return 2 * ((M * kI4Cols / 2 + ks - 1) / ks);
}

template <int NT>
__global__ void __launch_bounds__(I4Shape<NT>::THREADS)
int4_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ w, const float* __restrict__ s,
                float* __restrict__ out, int M, int din, int dout,
                int splits) {
  using S = I4Shape<NT>;
  constexpr int MT = S::MT, CW = S::CW, WC = 16 * MT;   // WC: warp columns
  extern __shared__ __align__(128) unsigned char sm[];
  const uint32_t base = smem_u32(sm);
  const uint32_t full0 = base + S::BAR_OFF, empty0 = full0 + 8 * S::ST;
  const uint32_t recv = empty0 + 8 * S::ST;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int c0 = blockIdx.y * kI4Cols;
  // a consumer thread's columns: wcol + b for its 2 MT bytes b of a packed
  // row, byte b being row gq + 8 (b & 1) of m-tile b / 2
  const int wcol = warp * WC + 2 * MT * gq;
  const Range gr = int4_groups(din / (2 * GROUP_ROWS), splits, blockIdx.x);
  const int n = gr.end - gr.begin;              // stages: one group each

  if (threadIdx.x == 0) {
    for (int i = 0; i < S::ST; ++i) {
      mbar_init(full0 + 8 * i, 32);            // the producer's lanes
      mbar_init(empty0 + 8 * i, CW);           // the consumer warps
    }
    mbar_init(recv, 1);                        // + the slice's bytes
    mbar_init_fence();
  }
  __syncthreads();
  if (splits > 1) cluster_arrive();  // the receive barrier is initialised

  float acc[MT][NT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][t][e] = 0.f;

  if (warp == CW) {
    // ---- producer: 16-byte chunks of the group's packed rows (8 lanes a
    // row), its scales (a chunk a lane) and x's rows (8 lanes a row) ----
    for (int t = 0; t < n; ++t) {
      const int st = t % S::ST;
      if (t >= S::ST) mbar_wait(empty0 + 8 * st, (t / S::ST - 1) & 1);
      const uint32_t dst = base + st * S::STAGE;
      const int g = gr.begin + t;
      const uint8_t* wg = w + static_cast<size_t>(g) * GROUP_ROWS * dout + c0;
#pragma unroll
      for (int i = lane; i < GROUP_ROWS * 8; i += 32)
        cp_async16(dst + (i >> 3) * S::W_ROW + (i & 7) * 16,
                   wg + static_cast<size_t>(i >> 3) * dout + (i & 7) * 16);
      cp_async16(dst + S::S_OFF + lane * 16,
                 s + static_cast<size_t>(g) * dout + c0 + lane * 4);
      for (int i = lane; i < M * 8; i += 32)
        cp_async16(dst + S::X_OFF + (i >> 3) * S::X_ROW + (i & 7) * 16,
                   x + static_cast<size_t>(i >> 3) * din + g * 64
                       + (i & 7) * 8);
      cp_async_arrive(full0 + 8 * st);
    }
    __syncwarp();
  } else {
    // ---- consumers: WC columns each, every row of x ----
    // ldmatrix rows of x: lanes 8i..8i+7 address matrix i (n-tile pair:
    // rows +8 for matrices 2, 3; depth +8 for matrices 1, 3)
    const int xr = NT == 1 ? (lane & 7) : (lane & 7) + ((lane >> 4) << 3);
    const uint32_t xoff = S::X_OFF + xr * S::X_ROW + ((lane >> 3) & 1) * 16;
    for (int t = 0; t < n; ++t) {
      const int st = t % S::ST;
      mbar_wait(full0 + 8 * st, (t / S::ST) & 1);
      const unsigned char* stg = sm + st * S::STAGE;
      float sc[2 * MT];
      if constexpr (MT == 2) {
        const float4 s4 =
            *reinterpret_cast<const float4*>(stg + S::S_OFF + wcol * 4);
        sc[0] = s4.x; sc[1] = s4.y; sc[2] = s4.z; sc[3] = s4.w;
      } else {
        const float2 s2 =
            *reinterpret_cast<const float2*>(stg + S::S_OFF + wcol * 4);
        sc[0] = s2.x; sc[1] = s2.y;
      }
      const unsigned char* wr = stg + wcol;
      const uint32_t xs = base + st * S::STAGE + xoff;
      uint32_t wq[8];                            // packed rows tq + 4 i
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const unsigned char* p = wr + (4 * i + tq) * S::W_ROW;
        wq[i] = MT == 2 ? *reinterpret_cast<const uint32_t*>(p)
                        : *reinterpret_cast<const uint16_t*>(p);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {              // 16-deep steps
        uint32_t d0[2 * MT], d1[2 * MT];
        dequant<MT>(wq[2 * k], sc, d0);
        dequant<MT>(wq[2 * k + 1], sc, d1);
        uint32_t bf[NT][2];
        if constexpr (NT == 1) {
          ldsm_x2(bf[0], xs + 32 * k);
        } else {
#pragma unroll
          for (int p = 0; p < NT / 2; ++p) {
            uint32_t r[4];
            ldsm_x4(r, xs + p * 16 * S::X_ROW + 32 * k);
            bf[2 * p][0] = r[0]; bf[2 * p][1] = r[1];
            bf[2 * p + 1][0] = r[2]; bf[2 * p + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const uint32_t a[4] = {d0[2 * j], d0[2 * j + 1], d1[2 * j],
                                 d1[2 * j + 1]};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[j][nt], a, bf[nt]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }
  }

  // accumulator (j, nt): [0]/[2] are columns wcol + 2j and + 1 of row
  // nt*8 + 2tq, [1]/[3] the same columns of the next row
  if (warp == CW) return;
  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r0 = nt * 8 + 2 * tq;
        float* dst = out + static_cast<size_t>(r0) * dout + c0 + wcol + 2 * j;
        if (r0 < M)
          *reinterpret_cast<float2*>(dst) =
              make_float2(acc[j][nt][0], acc[j][nt][2]);
        if (r0 + 1 < M)
          *reinterpret_cast<float2*>(dst + dout) =
              make_float2(acc[j][nt][1], acc[j][nt][3]);
      }
    return;
  }
  // send each column pair to the owner of its slice
  const int E2 = M * kI4Cols / 2, z = blockIdx.x;
  const int sl = slot_floats(M, splits);
  cluster_wait();                    // every receive barrier is ready
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = nt * 8 + 2 * tq + h;
        if (r < M) {
          const int u = (r * kI4Cols + wcol + 2 * j) / 2;      // pair index
          const int owner = ((u + 1) * splits - 1) / E2;
          const int e = 2 * (u - E2 * owner / splits);         // in slice
          st_async2(cluster_addr(base + S::RECV_OFF + 4 * (z * sl + e),
                                 owner),
                    make_float2(acc[j][nt][h], acc[j][nt][h + 2]),
                    cluster_addr(recv, owner));
        }
      }
  // sum this block's slice over the splits, in split order
  const int e0 = 2 * (E2 * z / splits);
  const int len = 2 * (E2 * (z + 1) / splits) - e0;
  if (threadIdx.x == 0) mbar_arrive_tx(recv, splits * len * 4);
  mbar_wait(recv, 0);
  const float* rv = reinterpret_cast<const float*>(sm + S::RECV_OFF);
  for (int i = threadIdx.x; i < len; i += 32 * CW) {
    float v = 0.f;
    for (int q = 0; q < splits; ++q) v += rv[q * sl + i];
    const int e = e0 + i;
    out[static_cast<size_t>(e / kI4Cols) * dout + c0 + e % kI4Cols] = v;
  }
}

// f32 x: one output column per thread and 8 rows per block row, the
// contraction in order; x's 64 columns of a group staged in shared memory.
__global__ void __launch_bounds__(kI4Cols)
int4_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
                const float* __restrict__ s, float* __restrict__ out, int M,
                int din, int dout) {
  __shared__ float xs[8][64];
  const int col = blockIdx.x * kI4Cols + threadIdx.x;
  const int m0 = blockIdx.y * 8;
  float acc[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) acc[m] = 0.f;
  for (int g = 0; g < din / 64; ++g) {
    for (int i = threadIdx.x; i < 8 * 64; i += kI4Cols) {
      const int m = m0 + i / 64;
      xs[i / 64][i % 64] =
          m < M ? x[static_cast<size_t>(m) * din + g * 64 + i % 64] : 0.f;
    }
    __syncthreads();
    const float sc = s[static_cast<size_t>(g) * dout + col];
    for (int r = 0; r < GROUP_ROWS; ++r) {
      const uint32_t byte =
          w[static_cast<size_t>(g * GROUP_ROWS + r) * dout + col];
      const float lo = nibble_to_f(byte & 0xFu) * sc;
      const float hi = nibble_to_f(byte >> 4) * sc;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        acc[m] = fmaf(xs[m][2 * r], lo, acc[m]);
        acc[m] = fmaf(xs[m][2 * r + 1], hi, acc[m]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < 8; ++m)
    if (m0 + m < M) out[static_cast<size_t>(m0 + m) * dout + col] = acc[m];
}

template <typename T>
__device__ __forceinline__ void store16(T* dst, const float* v);
template <> __device__ __forceinline__ void store16<float>(float* dst,
                                                         const float* v) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    d[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}
template <> __device__ __forceinline__ void store16<__nv_bfloat16>(
    __nv_bfloat16* dst, const float* v) {
  uint32_t u[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    u[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(u[0], u[1], u[2], u[3]);
  d[1] = make_uint4(u[4], u[5], u[6], u[7]);
}

template <typename T>
__global__ void int4_dequant_split_kernel(const uint8_t* __restrict__ w,
                                          const float* __restrict__ s,
                                          T* __restrict__ out, int half,
                                          int dout) {
  const long long n = static_cast<long long>(half) * dout;
  for (long long e = (blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x) * 16; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x * 16) {
    const int r = static_cast<int>(e / dout);
    const int c = static_cast<int>(e - static_cast<long long>(r) * dout);
    const uint4 p = __ldg(reinterpret_cast<const uint4*>(w + e));
    float sc[16];
    load_scales16(s + static_cast<size_t>(r / GROUP_ROWS) * dout + c, sc);
    const uint32_t words[4] = {p.x, p.y, p.z, p.w};
    float lo[16], hi[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const uint32_t byte = (words[b >> 2] >> (8 * (b & 3))) & 0xFFu;
      lo[b] = nibble_to_f(byte & 0xFu) * sc[b];
      hi[b] = nibble_to_f(byte >> 4) * sc[b];
    }
    store16<T>(out + e, lo);
    store16<T>(out + n + e, hi);
  }
}

template <int NT>
cudaError_t launch_int4_mma(const void* x, const void* w, const void* s,
                            void* out, int M, int din, int dout,
                            cudaStream_t st) {
  using S = I4Shape<NT>;
  static const cudaError_t ready =
      allow_launch(int4_mma_kernel<NT>, S::SMEM_MAX, false);
  if (ready != cudaSuccess) return ready;
  const int splits = int4_splits(M, din, dout);
  const int smem = S::RECV_OFF
      + (splits > 1 ? 4 * splits * slot_floats(M, splits) : 0);
  return launch_clustered(
      int4_mma_kernel<NT>, dim3(splits, dout / kI4Cols, 1), S::THREADS,
      splits, smem, st, static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint8_t*>(w), static_cast<const float*>(s),
      static_cast<float*>(out), M, din, dout, splits);
}

}  // namespace
}  // namespace svt

extern "C" int svt_int4_matmul(const void* x, const void* w, const void* s,
                               void* out, int M, int din, int dout,
                               int is_bf16, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x)
      | reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(s);
  if (M < 1 || din % 512 || dout % 512 || align % 16 ||
      (is_bf16 ? M > svt::K6_MAX_ROWS : (M + 7) / 8 > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!is_bf16) {
    svt::int4_f32_kernel<<<dim3(dout / svt::kI4Cols, (M + 7) / 8),
                           svt::kI4Cols, 0, st>>>(
        static_cast<const float*>(x), static_cast<const uint8_t*>(w),
        static_cast<const float*>(s), static_cast<float*>(out), M, din,
        dout);
    err = cudaSuccess;
  } else if (M <= 8) {
    err = svt::launch_int4_mma<1>(x, w, s, out, M, din, dout, st);
  } else {
    err = svt::launch_int4_mma<16>(x, w, s, out, M, din, dout, st);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

extern "C" int svt_int4_dequant_split(const void* w, const void* s,
                                      void* out, int half, int dout,
                                      int is_bf16, void* stream) {
  if (half % 256 || dout % 512) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long units = static_cast<long long>(half) * dout / 16;
  const int blocks = static_cast<int>((units + 255) / 256 < 132 * 16
                                      ? (units + 255) / 256 : 132 * 16);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(s);
  if (is_bf16)
    svt::int4_dequant_split_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        wp, sp, static_cast<__nv_bfloat16*>(out), half, dout);
  else
    svt::int4_dequant_split_kernel<float><<<blocks, 256, 0, st>>>(
        wp, sp, static_cast<float*>(out), half, dout);
  return static_cast<int>(cudaGetLastError());
}
