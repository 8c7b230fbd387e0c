// Launch plans of K6 (int4_matmul.cu) and K8 (decode_attention.cu): how
// many blocks a launch takes and which share of the work each block owns.
// Plain C++ with no CUDA types, so the host compiler can build it too
// (tests/test_torch_kernel_plan.py).
#pragma once

#ifndef SVT_HD
#ifdef __CUDACC__
#define SVT_HD __host__ __device__ __forceinline__
#else
#define SVT_HD inline
#endif
#endif

namespace svt {

constexpr int kSms = 132;            // SMs of the H100 SXM

struct Range {
  int begin, end;                    // [begin, end)
};

// ---- K6: out[M, dout] = x[M, din] @ dequant(W) ------------------------

constexpr int kI4Cols = 128;         // output columns per block
constexpr int kI4GroupRows = 32;     // packed rows per scale group (64 rows)
constexpr int kI4Cluster = 8;        // most splits of a tile (portable size)

// Blocks that split the contraction of one 128-column tile (one cluster):
// the fewest that give every SM four blocks at M <= 8 (the dequant is the
// work; more warps hide its latency) or two above (each block also
// streams x's rows), at most kI4Cluster, and at least one scale group
// each. It depends on the shapes alone.
SVT_HD int int4_splits(int M, int din, int dout) {
  const int tiles = dout / kI4Cols;
  const int groups = din / (2 * kI4GroupRows);
  const int per_sm = M <= 8 ? 4 : 2;
  int ks = (per_sm * kSms + tiles - 1) / tiles;
  if (ks > kI4Cluster) ks = kI4Cluster;
  if (ks > groups) ks = groups;
  return ks < 1 ? 1 : ks;
}

// Scale groups of split z: consecutive, every group in exactly one split.
SVT_HD Range int4_groups(int groups, int splits, int z) {
  Range r;
  r.begin = static_cast<int>(static_cast<long long>(groups) * z / splits);
  r.end = static_cast<int>(static_cast<long long>(groups) * (z + 1) / splits);
  return r;
}

// ---- K8: decode attention over keys 0..length-1 of the cache ------------

constexpr int kDecTile = 64;         // keys per pipeline stage
constexpr int kDecAlign = 16;        // a share starts on a 16-key boundary
constexpr int kDecMinShare = 64;     // no block takes fewer keys than this
// most splits of a (row, KV head): a non-portable cluster size, which the
// H100 schedules (at B = 1 the 4 KV heads then put 64 SMs on the prefix)
constexpr int kDecCluster = 16;

// Blocks (one cluster) that split the live prefix of one (batch row, KV
// head): enough for two blocks per SM, at most kDecCluster, and no more
// than the capacity has minimum shares. It depends on the shapes alone:
// the length stays on the device.
SVT_HD int decode_splits(int smax, int batch, int kv_heads) {
  const int rows = batch * kv_heads;
  int p = (2 * kSms + rows - 1) / rows;
  const int most = (smax + kDecMinShare - 1) / kDecMinShare;
  if (p > most) p = most;
  if (p > kDecCluster) p = kDecCluster;
  return p < 1 ? 1 : p;
}

// Keys of split p of `splits` for a row of `length` live keys: equal
// 16-aligned shares of at least kDecMinShare keys, cut at the length, so
// that a short prefix takes fewer blocks and no block reads at or past
// the length. A split past the prefix gets an empty range.
SVT_HD Range decode_keys(int length, int splits, int p) {
  int share = (length + splits - 1) / splits;
  share = (share + kDecAlign - 1) / kDecAlign * kDecAlign;
  if (share < kDecMinShare) share = kDecMinShare;
  const long long b = static_cast<long long>(share) * p;
  Range r;
  r.begin = b < length ? static_cast<int>(b) : length;
  r.end = length - r.begin < share ? length : r.begin + share;
  return r;
}

}  // namespace svt
