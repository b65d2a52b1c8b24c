// K3: line-search candidate errors, err[k] = sum over valid cells of
// |q1 - s^T wL s / n| for K candidate pose tables, with membership and
// Lambda frozen in the packed rows.
//
// Replaces the TPU kernel _cand_kernel of dmsa_lidar_slam_tpu/ops/
// fused_residuals.py (cand_errors).  True f32 throughout (the TPU kernel
// splits into bf16 hi/lo limbs to reach f32-class sums on the MXU).
//
// What bounds it here: per point and candidate one table-row read and ~40
// flops; the K = 15 tables of the window problem (15 x 502 x 32 B =
// 241 KB) exceed a block's shared memory, so they are read through the
// read-only path and stay resident in L1/L2.  The packed rows are read
// once for all K candidates.
//
// Design: a warp owns the runs that start among 32 sorted positions;
// lanes take members, each lane accumulates the K candidates' (s, q1) in
// registers, a fixed butterfly reduces them per run, and lane 0 adds the
// cell's |val| per candidate.  Candidate errors are compared against each
// other (argmin), so the sum order is fixed: warps in a block are summed
// in shared memory in warp order, blocks write partials, and a second
// kernel sums the partials in block order.  No float atomics anywhere.
#include "common.cuh"

namespace {

constexpr int kMaxK = 16;
constexpr int kCandWarps = 8;

__global__ void __launch_bounds__(32 * kCandWarps)
    cand_partial(const float* __restrict__ tabs, int K, int dtab, const float* __restrict__ pk,
                 int m, float* __restrict__ partial) {
  __shared__ float swarp[kCandWarps][kMaxK];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int base = (blockIdx.x * kCandWarps + wib) * 32;
  float acc[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) acc[k] = 0.f;

  if (base < m) {
    const int mypos = base + lane;
    unsigned starts = __ballot_sync(FULL_MASK, mypos < m && pk[14 * m + mypos] > 0.5f);
    while (starts) {
      const int s = base + __ffs(starts) - 1;
      starts &= starts - 1;
      float sx[kMaxK], sy[kMaxK], sz[kMaxK], q1[kMaxK];
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) sx[k] = sy[k] = sz[k] = q1[k] = 0.f;
      int e = -1;
      for (int c0 = s; e < 0; c0 += 32) {
        const int j = c0 + lane;
        const bool later_start = j < m && j > s && pk[14 * m + j] > 0.5f;
        unsigned nexts = __ballot_sync(FULL_MASK, later_start || j >= m);
        const int cnt = nexts ? __ffs(nexts) - 1 : 32;
        if (nexts) e = c0 + cnt - 1;
        if (lane < cnt) {
          const float xs = pk[j], ys = pk[m + j], zs = pk[2 * m + j];
          const float mx = pk[3 * m + j], my = pk[4 * m + j], mz = pk[5 * m + j];
          float lam[6];
#pragma unroll
          for (int c = 0; c < 6; ++c) lam[c] = pk[(6 + c) * m + j];
          const float w = pk[12 * m + j];
          const int t = (int)pk[13 * m + j];
#pragma unroll
          for (int k = 0; k < kMaxK; ++k) {
            if (k < K) {
              Pose ps = load_pose(tabs + (size_t)k * dtab * 8, t);
              float px, py, pz;
              transform(ps, xs, ys, zs, px, py, pz);
              const float dx = (px - mx) * w, dy = (py - my) * w, dz = (pz - mz) * w;
              float lx, ly, lz;
              sym6_mv(lam, dx, dy, dz, lx, ly, lz);
              sx[k] += dx;
              sy[k] += dy;
              sz[k] += dz;
              q1[k] += lx * dx + ly * dy + lz * dz;
            }
          }
        }
      }
      const float invn = pk[15 * m + e];
      if (invn > 0.f) {  // uniform across the warp
        float lam[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) lam[c] = pk[(6 + c) * m + e];
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          if (k < K) {
            const float a = warp_sum(sx[k]), b = warp_sum(sy[k]), c = warp_sum(sz[k]);
            const float q = warp_sum(q1[k]);
            float cx, cy, cz;
            sym6_mv(lam, a, b, c, cx, cy, cz);
            acc[k] += fabsf(q - invn * (cx * a + cy * b + cz * c));
          }
        }
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) swarp[wib][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.f;
    for (int w = 0; w < kCandWarps; ++w) s += swarp[w][threadIdx.x];
    partial[(size_t)blockIdx.x * K + threadIdx.x] = s;
  }
}

// out[k] = sum over blocks of partial[b, k]: warp k, lanes stride blocks,
// fixed butterfly.
__global__ void cand_final(const float* __restrict__ partial, int nblocks, int K,
                           float* __restrict__ out) {
  const int k = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (k >= K) return;
  float s = 0.f;
  for (int b = lane; b < nblocks; b += 32) s += partial[(size_t)b * K + k];
  s = warp_sum(s);
  if (lane == 0) out[k] = s;
}

}  // namespace

extern "C" int k3_cand_errors(const float* tabs, int K, int dtab, const float* packed, int m,
                              float* partial, float* out, cudaStream_t stream) {
  if (K > kMaxK || K < 1) return (int)cudaErrorInvalidValue;
  const int blocks = max(1, (m + 32 * kCandWarps - 1) / (32 * kCandWarps));
  cand_partial<<<blocks, 32 * kCandWarps, 0, stream>>>(tabs, K, dtab, packed, m, partial);
  int err = (int)cudaGetLastError();
  if (err) return err;
  cand_final<<<1, 32 * K, 0, stream>>>(partial, blocks, K, out);
  return (int)cudaGetLastError();
}
