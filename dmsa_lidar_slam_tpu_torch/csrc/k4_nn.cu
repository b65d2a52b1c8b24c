// K4: exact squared distance from each query to its nearest valid
// reference point, by brute force.
//
// Replaces the TPU kernel _kernel of dmsa_lidar_slam_tpu/ops/
// nn_bruteforce.py (min_sq_dist / has_neighbor_within), which forms
// |q|^2 - 2 r.q + |r|^2 on the MXU from bf16 hi/lo limbs.  Here the
// distance is computed directly as |q - r|^2 in f32: no cancellation, so
// no centering is needed and the result is never negative.
//
// What bounds it here: arithmetic and instruction rate, ~8 flops per pair; the
// main-path calls are 20,480 x 12,288 and 8,192 x 20,480 pairs (a few
// hundred million), each reference point read once per block from shared
// memory.  Design: one thread per query, reference tiles staged in shared
// memory as float4 (x, y, z, penalty) where invalid references carry +inf,
// so they never win.  Invalid queries get +inf, as do all queries when no
// reference is valid.
#include "common.cuh"

namespace {

constexpr int kNNThreads = 128;

__global__ void __launch_bounds__(kNNThreads)
    nn_min(const float* __restrict__ ref, const unsigned char* __restrict__ rvalid, int n,
           const float* __restrict__ q, const unsigned char* __restrict__ qvalid, int nq,
           float* __restrict__ out) {
  __shared__ float4 tile[kNNThreads];
  const int i = blockIdx.x * kNNThreads + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (i < nq) {
    qx = q[3 * i];
    qy = q[3 * i + 1];
    qz = q[3 * i + 2];
  }
  float best = INFINITY;
  for (int t0 = 0; t0 < n; t0 += kNNThreads) {
    const int r = t0 + threadIdx.x;
    float4 v = make_float4(0.f, 0.f, 0.f, INFINITY);
    if (r < n && rvalid[r]) v = make_float4(ref[3 * r], ref[3 * r + 1], ref[3 * r + 2], 0.f);
    tile[threadIdx.x] = v;
    __syncthreads();
    const int cnt = min(kNNThreads, n - t0);
    for (int k = 0; k < cnt; ++k) {
      const float4 rv = tile[k];
      const float dx = qx - rv.x, dy = qy - rv.y, dz = qz - rv.z;
      best = fminf(best, dx * dx + dy * dy + dz * dz + rv.w);
    }
    __syncthreads();
  }
  if (i < nq) out[i] = qvalid[i] ? best : INFINITY;
}

}  // namespace

extern "C" int k4_min_sq_dist(const float* ref, const unsigned char* rvalid, int n, const float* q,
                              const unsigned char* qvalid, int nq, float* out,
                              cudaStream_t stream) {
  const int blocks = (nq + kNNThreads - 1) / kNNThreads;
  if (blocks > 0) nn_min<<<blocks, kNNThreads, 0, stream>>>(ref, rvalid, n, q, qvalid, nq, out);
  return (int)cudaGetLastError();
}
