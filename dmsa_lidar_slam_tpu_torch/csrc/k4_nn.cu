// K4: exact squared distance from each query to its nearest valid
// reference point, by brute force.
//
// Replaces the TPU kernel _kernel of dmsa_lidar_slam_tpu/ops/
// nn_bruteforce.py (min_sq_dist / has_neighbor_within), which forms
// |q|^2 - 2 r.q + |r|^2 on the MXU from bf16 hi/lo limbs.  Here the
// distance is computed directly as |q - r|^2 in f32: no cancellation, so
// no centering is needed and the result is never negative.
//
// What bounds it here: instruction rate.  Per pair 7 f32 instructions (3
// differences, a product, 2 fused multiply-adds, the min); the main-path
// calls are 20,480 x 12,288 and 8,192 x 20,480 pairs (a few hundred
// million), while the bytes are a few hundred KB.
//
// Design: a block takes kQPT x kThreads queries (kQPT per thread, in
// registers: one broadcast shared-memory read of a reference feeds kQPT
// independent min chains) and one split of the references, so that the
// grid (query tiles x reference splits) holds several blocks per SM.  The
// references are staged kRefTile at a time in shared memory; an invalid one
// is parked at +inf, so it never wins and costs no extra instruction.  A
// warp whose queries are all invalid skips the pairs.  Each block combines
// its per-query minima into the output with atomicMin on the f32 bit
// pattern, which orders like the value for non-negative floats: exact and
// independent of order, so the result is bit-identical from call to call.
// The output starts as 0xffffffff (a memset, no kernel), above every
// non-negative float's bits; every query receives one minimum per split,
// so none is left there.  Invalid queries get +inf, as do all queries when
// no reference is valid.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQPT = 8;  // queries per thread
constexpr int kQTile = kThreads * kQPT;
constexpr int kRefTile = kThreads;  // references per shared-memory tile
constexpr int kBlocksPerSM = 4;     // grid target

__global__ void __launch_bounds__(kThreads)
    nn_min(const float* __restrict__ ref, const unsigned char* __restrict__ rvalid, int n,
           int refs_per_split, const float* __restrict__ q, const unsigned char* __restrict__ qvalid,
           int nq, unsigned* __restrict__ out) {
  __shared__ float4 tile[kRefTile];
  const int q0 = blockIdx.x * kQTile + threadIdx.x;
  const int r0 = blockIdx.y * refs_per_split;
  const int r1 = min(n, r0 + refs_per_split);
  float qx[kQPT], qy[kQPT], qz[kQPT], best[kQPT];
  bool any = false;
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    const int qi = q0 + i * kThreads;
    const bool v = qi < nq && qvalid[qi];
    any |= v;
    qx[i] = v ? q[3 * qi] : 0.f;
    qy[i] = v ? q[3 * qi + 1] : 0.f;
    qz[i] = v ? q[3 * qi + 2] : 0.f;
    best[i] = INFINITY;
  }
  const bool live = __any_sync(FULL_MASK, any);
  for (int t0 = r0; t0 < r1; t0 += kRefTile) {
    const int j = t0 + threadIdx.x;
    tile[threadIdx.x] = j < r1 && rvalid[j] ? make_float4(ref[3 * j], ref[3 * j + 1], ref[3 * j + 2], 0.f)
                                            : make_float4(INFINITY, INFINITY, INFINITY, 0.f);
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int k = 0; k < kRefTile; ++k) {
        const float4 rv = tile[k];
#pragma unroll
        for (int i = 0; i < kQPT; ++i) {
          const float dx = qx[i] - rv.x, dy = qy[i] - rv.y, dz = qz[i] - rv.z;
          best[i] = fminf(best[i], fmaf(dz, dz, fmaf(dy, dy, dx * dx)));
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    const int qi = q0 + i * kThreads;
    if (qi < nq) atomicMin(out + qi, __float_as_uint(qvalid[qi] ? best[i] : INFINITY));
  }
}

}  // namespace

extern "C" int k4_min_sq_dist(const float* ref, const unsigned char* rvalid, int n, const float* q,
                              const unsigned char* qvalid, int nq, float* out,
                              cudaStream_t stream) {
  if (nq <= 0) return (int)cudaGetLastError();
  int sms = 0;
  cudaError_t e = num_sms(&sms);
  if (e != cudaSuccess) return (int)e;
  const int qtiles = (nq + kQTile - 1) / kQTile;
  const int rtiles = max(1, (n + kRefTile - 1) / kRefTile);
  // reference tiles per split: enough splits for kBlocksPerSM blocks per SM
  const int want = max(1, (kBlocksPerSM * sms + qtiles - 1) / qtiles);
  const int per = (rtiles + min(want, rtiles) - 1) / min(want, rtiles);
  const int splits = (rtiles + per - 1) / per;
  e = cudaMemsetAsync(out, 0xff, (size_t)nq * sizeof(float), stream);
  if (e != cudaSuccess) return (int)e;
  nn_min<<<dim3(qtiles, splits), kThreads, 0, stream>>>(ref, rvalid, n, per * kRefTile, q, qvalid,
                                                         nq, reinterpret_cast<unsigned*>(out));
  return (int)cudaGetLastError();
}
