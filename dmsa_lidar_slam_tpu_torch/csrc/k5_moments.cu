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
// Masked reference slots are zeroed before use, so a NaN/Inf there never
// enters a sum.  d2 is rounded op by op as (dx*dx + dy*dy) + dz*dz
// (__fmul_rn / __fadd_rn, no FMA contraction), the same rounding as the
// plain version, so both count exactly the same pairs.
//
// What bounds it here: arithmetic, ~9 flops per pair for the distance test
// (N^2 pairs, 1.7e7 at the main path's N = 4,096) and ~20 more per
// neighbour; bytes are negligible (13 N in, 52 N out).  Design: one thread
// per query, reference tiles staged in shared memory as float4
// (x, y, z, valid), the ten sums in f32 registers, accumulated predicated
// (no divergent branch in the inner loop).  At N = 4,096 one thread per
// query fills only 32 blocks of 128 threads, about a quarter of the SMs:
// splitting the references over blocks, with a fixed-order second pass as
// K2 does, is later work.
#include "common.cuh"

namespace {

constexpr int kMomThreads = 128;

__global__ void __launch_bounds__(kMomThreads)
    radius_moments(const float* __restrict__ pts, const unsigned char* __restrict__ valid, int n,
                   const float* __restrict__ rho2_ptr, float* __restrict__ cnt_out,
                   float* __restrict__ mean_out, float* __restrict__ cov_out) {
  __shared__ float4 tile[kMomThreads];
  const int i = blockIdx.x * kMomThreads + threadIdx.x;
  const float rho2 = __ldg(rho2_ptr);
  const bool active = i < n && valid[i];
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = pts[3 * i];
    qy = pts[3 * i + 1];
    qz = pts[3 * i + 2];
  }
  float c = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
  float sxx = 0.f, sxy = 0.f, sxz = 0.f, syy = 0.f, syz = 0.f, szz = 0.f;
  for (int t0 = 0; t0 < n; t0 += kMomThreads) {
    const int r = t0 + threadIdx.x;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n && valid[r]) v = make_float4(pts[3 * r], pts[3 * r + 1], pts[3 * r + 2], 1.f);
    tile[threadIdx.x] = v;
    __syncthreads();
    if (active) {
      const int cnt = min(kMomThreads, n - t0);
      for (int k = 0; k < cnt; ++k) {
        const float4 rv = tile[k];
        const float dx = __fsub_rn(rv.x, qx);
        const float dy = __fsub_rn(rv.y, qy);
        const float dz = __fsub_rn(rv.z, qz);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        const float f = d2 <= rho2 ? rv.w : 0.f;
        const float gx = f * dx, gy = f * dy, gz = f * dz;
        c += f;
        sx += gx;
        sy += gy;
        sz += gz;
        sxx += gx * dx;
        sxy += gx * dy;
        sxz += gx * dz;
        syy += gy * dy;
        syz += gy * dz;
        szz += gz * dz;
      }
    }
    __syncthreads();
  }
  if (i >= n) return;
  float m[3] = {0.f, 0.f, 0.f};
  float cv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (active) {
    const float inv = 1.f / fmaxf(c, 1.f);
    m[0] = qx + sx * inv;
    m[1] = qy + sy * inv;
    m[2] = qz + sz * inv;
    if (c >= 2.f) {
      const float den = 1.f / fmaxf(c - 1.f, 1.f);
      cv[0] = (sxx - sx * sx * inv) * den;
      cv[1] = (sxy - sx * sy * inv) * den;
      cv[2] = (sxz - sx * sz * inv) * den;
      cv[3] = (syy - sy * sy * inv) * den;
      cv[4] = (syz - sy * sz * inv) * den;
      cv[5] = (szz - sz * sz * inv) * den;
    }
  }
  cnt_out[i] = active ? c : 0.f;
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

extern "C" int k5_radius_moments(const float* pts, const unsigned char* valid, int n,
                                 const float* rho2, float* cnt, float* mean, float* cov,
                                 cudaStream_t stream) {
  const int blocks = (n + kMomThreads - 1) / kMomThreads;
  if (blocks > 0) radius_moments<<<blocks, kMomThreads, 0, stream>>>(pts, valid, n, rho2, cnt, mean, cov);
  return (int)cudaGetLastError();
}
