// K5: per-point count, mean and covariance of the valid neighbours within a
// radius (the radius-moment normals of every keyframe cloud).
//
// Replaces the TPU kernel _moments_kernel of dmsa_lidar_slam_tpu/ops/
// nn_bruteforce.py (radius_neighbor_moments).  That kernel thresholds a
// bf16 hi/lo MXU distance tile into an incidence matrix and contracts it
// against the ten moment rows of the references, about the masked cloud
// mean, at HIGHEST precision.  Here each pair is tested directly in f32 and
// the moments are accumulated about the QUERY point (r - q): every summand
// is a neighbourhood-scale number (|r - q| <= rho), so the covariance
// carries none of the cancellation of ~30 m coordinates that the TPU
// kernel's note warns of.
//
// Semantics (as the plain version, nn_bruteforce.radius_neighbor_moments_ref):
// for each VALID query q, over the valid references r with
// |r - q|^2 <= rho^2 (q itself included): cnt, mean = q + s / cnt with
// s = sum (r - q), and cov = (S - s s^T / cnt) / max(cnt - 1, 1) with
// S = sum (r - q)(r - q)^T, zero where cnt < 2.  Invalid queries get zeros.
// A masked slot never enters a sum, whatever it holds (NaN, Inf).  d2 is
// rounded op by op as (dx*dx + dy*dy) + dz*dz (__fsub_rn / __fmul_rn /
// __fadd_rn, no FMA contraction), and rho^2 is the f32 radius squared in
// f32, as the plain version rounds both, so both count exactly the same
// pairs.
//
// What bounds it here: instruction issue.  The distance test runs for all
// N^2 pairs (1.7e7 at the main path's N = 4,096: 8 f32 operations and the
// compare), the ten sums only for the neighbours (~10 per query there);
// bytes are negligible (13 N in, 52 N out).
//
// Design, two kernels:
//  - moment_pieces: a block takes kQPT x kThreads queries (kQPT per thread,
//    ten f32 sums each in registers) and one split of the references, so
//    that the grid (query tiles x reference splits) fills the card (1,024
//    blocks at N = 4,096).  The split's references are staged as float4 in
//    shared memory; an invalid one is parked at NaN, so its d2 is NaN and
//    fails the test with no validity operation (at any radius, +inf
//    included).  Every pair runs the distance test; the sums sit behind one
//    warp vote per reference, so a warp pays for them only when one of its
//    lanes has that reference as a neighbour.  Each block writes its partial
//    count per query to scratch [splits, 10, N], and the nine moment sums
//    only where that count is not 0.
//  - moment_finish: for 32 queries, 8 warps each sum a run of splits in
//    split order, then warp 0 adds the runs in order and forms mean and
//    cov.  (One thread per query summing all splits took 29 us at N =
//    4,096: its lanes' nonzero splits differ, so a warp walked their union,
//    one dependent load per split.)
// Fixed-order sums and no float atomics: the result is bit-identical from
// call to call on one card (the split count follows the SM count).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQPT = 2;  // queries per thread (2 and 4 time alike, 8 slower)
constexpr int kQTile = kThreads * kQPT;
constexpr int kRefTile = kThreads;  // references per shared-memory tile
constexpr int kSplitGrain = 32;     // a split holds a multiple of this many references
constexpr int kBlocksPerSM = 8;     // grid target
constexpr int kRows = 10;           // scratch rows per query: count, s (3), S (6)
constexpr int kFinishQ = 32;        // queries per finish block, one per lane
constexpr int kFinishWarps = 8;     // split groups per finish block, one per warp
constexpr int kFinishBatch = 8;     // splits a lane loads at once

struct Cut {
  int qtiles, refs_per_split, splits;
};

Cut cut_of(int n, int sms) {
  Cut c;
  c.qtiles = (n + kQTile - 1) / kQTile;
  const int grains = max(1, (n + kSplitGrain - 1) / kSplitGrain);
  const int want = min(grains, max(1, (kBlocksPerSM * sms + c.qtiles - 1) / c.qtiles));
  const int per = (grains + want - 1) / want;
  c.refs_per_split = per * kSplitGrain;
  c.splits = (grains + per - 1) / per;
  return c;
}

__device__ __forceinline__ void accumulate(float* a, float dx, float dy, float dz) {
  a[0] += 1.f;
  a[1] += dx;
  a[2] += dy;
  a[3] += dz;
  a[4] += dx * dx;
  a[5] += dx * dy;
  a[6] += dx * dz;
  a[7] += dy * dy;
  a[8] += dy * dz;
  a[9] += dz * dz;
}

// rho_dev null: the radius is rho_host; else the f32 device scalar *rho_dev.
__global__ void __launch_bounds__(kThreads)
    moment_pieces(const float* __restrict__ pts, const unsigned char* __restrict__ valid, int n,
                  int refs_per_split, float rho_host, const float* __restrict__ rho_dev,
                  float* __restrict__ part) {
  __shared__ float4 tile[kRefTile];
  const float rho = rho_dev != nullptr ? __ldg(rho_dev) : rho_host;
  const float rho2 = __fmul_rn(rho, rho);
  const float nan = __int_as_float(0x7fffffff);
  const int q0 = blockIdx.x * kQTile + threadIdx.x;
  const int r0 = blockIdx.y * refs_per_split;
  const int r1 = min(n, r0 + refs_per_split);
  float qx[kQPT], qy[kQPT], qz[kQPT], acc[kQPT][kRows];
  bool any = false;
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    const int qi = q0 + i * kThreads;
    const bool v = qi < n && valid[qi];
    any |= v;
    // an invalid query sits at NaN too: it has no neighbour
    qx[i] = v ? pts[3 * qi] : nan;
    qy[i] = v ? pts[3 * qi + 1] : nan;
    qz[i] = v ? pts[3 * qi + 2] : nan;
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[i][r] = 0.f;
  }
  const bool live = __any_sync(FULL_MASK, any);
  for (int t0 = r0; t0 < r1; t0 += kRefTile) {
    const int j = t0 + threadIdx.x;
    tile[threadIdx.x] = j < r1 && valid[j] ? make_float4(pts[3 * j], pts[3 * j + 1], pts[3 * j + 2], 0.f)
                                           : make_float4(nan, nan, nan, 0.f);
    __syncthreads();
    if (live) {
      const int cnt = min(kRefTile, r1 - t0);
#pragma unroll 2
      for (int k = 0; k < cnt; ++k) {
        const float4 rv = tile[k];
        float dx[kQPT], dy[kQPT], dz[kQPT];
        bool hit[kQPT], any_hit = false;
#pragma unroll
        for (int i = 0; i < kQPT; ++i) {
          dx[i] = __fsub_rn(rv.x, qx[i]);
          dy[i] = __fsub_rn(rv.y, qy[i]);
          dz[i] = __fsub_rn(rv.z, qz[i]);
          const float d2 =
              __fadd_rn(__fadd_rn(__fmul_rn(dx[i], dx[i]), __fmul_rn(dy[i], dy[i])), __fmul_rn(dz[i], dz[i]));
          hit[i] = d2 <= rho2;
          any_hit |= hit[i];
        }
        // one vote per reference: the warp runs the sums only when one of
        // its lanes has this reference as a neighbour of one of its queries
        if (__any_sync(FULL_MASK, any_hit)) {
#pragma unroll
          for (int i = 0; i < kQPT; ++i) {
            if (hit[i]) accumulate(acc[i], dx[i], dy[i], dz[i]);
          }
        }
      }
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.y * kRows * n;
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    const int qi = q0 + i * kThreads;
    if (qi >= n) continue;
    out[qi] = acc[i][0];
    if (acc[i][0] > 0.f) {
#pragma unroll
      for (int r = 1; r < kRows; ++r) out[(size_t)r * n + qi] = acc[i][r];
    }
  }
}

// A block takes kFinishQ queries (one per lane) and kFinishWarps warps:
// warp w sums its run of splits in order, then warp 0 adds the warps' sums
// in warp order.  A lane loads a batch of splits' counts, then, all at
// once, the moment rows of those with a count (the others are unwritten):
// two dependent loads per batch.
__global__ void __launch_bounds__(kFinishQ * kFinishWarps)
    moment_finish(const float* __restrict__ pts, const unsigned char* __restrict__ valid, int n,
                  int splits, const float* __restrict__ part, float* __restrict__ cnt_out,
                  float* __restrict__ mean_out, float* __restrict__ cov_out) {
  __shared__ float red[kFinishWarps][kRows][kFinishQ];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * kFinishQ + lane;
  const bool active = i < n && valid[i];
  const int per = (splits + kFinishWarps - 1) / kFinishWarps;
  const int b1 = min(splits, (w + 1) * per);
  const size_t stride = (size_t)kRows * n;
  float s[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = 0.f;
  if (active) {
    for (int b0 = w * per; b0 < b1; b0 += kFinishBatch) {
      float c[kFinishBatch], m[kFinishBatch][kRows - 1];
#pragma unroll
      for (int u = 0; u < kFinishBatch; ++u) c[u] = b0 + u < b1 ? part[(b0 + u) * stride + i] : 0.f;
#pragma unroll
      for (int u = 0; u < kFinishBatch; ++u) {
#pragma unroll
        for (int r = 1; r < kRows; ++r) m[u][r - 1] = c[u] > 0.f ? part[(b0 + u) * stride + (size_t)r * n + i] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kFinishBatch; ++u) {
        s[0] += c[u];
#pragma unroll
        for (int r = 1; r < kRows; ++r) s[r] += m[u][r - 1];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) red[w][r][lane] = s[r];
  __syncthreads();
  if (w != 0 || i >= n) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int v = 1; v < kFinishWarps; ++v) s[r] += red[v][r][lane];
  }
  const float c = s[0], sx = s[1], sy = s[2], sz = s[3];
  float m[3] = {0.f, 0.f, 0.f};
  float cv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (active) {
    const float inv = 1.f / fmaxf(c, 1.f);
    m[0] = pts[3 * i] + sx * inv;
    m[1] = pts[3 * i + 1] + sy * inv;
    m[2] = pts[3 * i + 2] + sz * inv;
    if (c >= 2.f) {
      const float den = 1.f / fmaxf(c - 1.f, 1.f);
      cv[0] = (s[4] - sx * sx * inv) * den;
      cv[1] = (s[5] - sx * sy * inv) * den;
      cv[2] = (s[6] - sx * sz * inv) * den;
      cv[3] = (s[7] - sy * sy * inv) * den;
      cv[4] = (s[8] - sy * sz * inv) * den;
      cv[5] = (s[9] - sz * sz * inv) * den;
    }
  }
  cnt_out[i] = c;
  mean_out[3 * i] = m[0];
  mean_out[3 * i + 1] = m[1];
  mean_out[3 * i + 2] = m[2];
  float* o = cov_out + 9 * i;
  o[0] = cv[0];
  o[1] = cv[1];
  o[2] = cv[2];
  o[3] = cv[1];
  o[4] = cv[3];
  o[5] = cv[4];
  o[6] = cv[2];
  o[7] = cv[4];
  o[8] = cv[5];
}

}  // namespace

// The scratch of k5_radius_moments for n points on the current device, in
// bytes: part [splits, 10, n] f32 (row 0 the count, rows 1-9 the moment
// sums, written only where the count is not 0).
extern "C" int k5_scratch_bytes(int n, long long* nbytes) {
  int sms = 0;
  const cudaError_t e = num_sms(&sms);
  if (e != cudaSuccess) return (int)e;
  nbytes[0] = (long long)cut_of(n, sms).splits * kRows * n * sizeof(float);
  return 0;
}

// rho_dev null: the radius is the host number rho_host, else the f32 device
// scalar *rho_dev; the kernel squares it in f32.  part as k5_scratch_bytes
// gives it.
extern "C" int k5_radius_moments(const float* pts, const unsigned char* valid, int n, float rho_host,
                                 const float* rho_dev, float* part, float* cnt, float* mean, float* cov,
                                 cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int sms = 0;
  const cudaError_t e = num_sms(&sms);
  if (e != cudaSuccess) return (int)e;
  const Cut c = cut_of(n, sms);
  moment_pieces<<<dim3(c.qtiles, c.splits), kThreads, 0, stream>>>(pts, valid, n, c.refs_per_split, rho_host,
                                                                   rho_dev, part);
  moment_finish<<<(n + kFinishQ - 1) / kFinishQ, kFinishQ * kFinishWarps, 0, stream>>>(
      pts, valid, n, c.splits, part, cnt, mean, cov);
  return (int)cudaGetLastError();
}
