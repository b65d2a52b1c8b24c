// Shared device helpers for the DMSA kernels (sm_90a).
//
// Point math as in the JAX reference's ops/fused_residuals.py channel
// helpers (_qrot, _vjpq, _sym6_mv, _floored_inverse6_rows), in true f32
// with acosf (the TPU kernels' bf16 limb splits and polynomial acos are TPU
// mechanisms and are not carried over).
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#define FULL_MASK 0xffffffffu

// Packed per-point layout [16, M] (fused_residuals.pack_rows):
// 0-2 xs, 3-5 mu0, 6-11 lamw6, 12 w, 13 tidx, 14 run-start flag,
// 15 1/count at valid run-end rows (else 0).
#define PK_ROWS 16

struct Pose {
  float qw, qx, qy, qz, tx, ty, tz;
};

__device__ __forceinline__ Pose load_pose(const float* __restrict__ tab, int row) {
  const float4* r = reinterpret_cast<const float4*>(tab + 8 * row);
  float4 a = __ldg(r), b = __ldg(r + 1);
  return Pose{a.x, a.y, a.z, a.w, b.x, b.y, b.z};
}

// quat_rotate(q, v) + t
__device__ __forceinline__ void transform(const Pose& p, float vx, float vy, float vz,
                                          float& ox, float& oy, float& oz) {
  float tx = 2.f * (p.qy * vz - p.qz * vy);
  float ty = 2.f * (p.qz * vx - p.qx * vz);
  float tz = 2.f * (p.qx * vy - p.qy * vx);
  ox = vx + p.qw * tx + (p.qy * tz - p.qz * ty) + p.tx;
  oy = vy + p.qw * ty + (p.qz * tx - p.qx * tz) + p.ty;
  oz = vz + p.qw * tz + (p.qx * ty - p.qy * tx) + p.tz;
}

// cotangent of quat_rotate wrt q for output cotangent g
__device__ __forceinline__ void vjp_q(const Pose& p, float vx, float vy, float vz, float gx,
                                      float gy, float gz, float& aw, float& ax, float& ay,
                                      float& az) {
  float tx = 2.f * (p.qy * vz - p.qz * vy);
  float ty = 2.f * (p.qz * vx - p.qx * vz);
  float tz = 2.f * (p.qx * vy - p.qy * vx);
  aw = gx * tx + gy * ty + gz * tz;
  float cvgx = vy * gz - vz * gy, cvgy = vz * gx - vx * gz, cvgz = vx * gy - vy * gx;
  float ctgx = ty * gz - tz * gy, ctgy = tz * gx - tx * gz, ctgz = tx * gy - ty * gx;
  float gux = gy * p.qz - gz * p.qy, guy = gz * p.qx - gx * p.qz, guz = gx * p.qy - gy * p.qx;
  float cvux = vy * guz - vz * guy, cvuy = vz * gux - vx * guz, cvuz = vx * guy - vy * gux;
  ax = 2.f * p.qw * cvgx + ctgx + 2.f * cvux;
  ay = 2.f * p.qw * cvgy + ctgy + 2.f * cvuy;
  az = 2.f * p.qw * cvgz + ctgz + 2.f * cvuz;
}

__device__ __forceinline__ void sym6_mv(const float* l, float x, float y, float z, float& ox,
                                        float& oy, float& oz) {
  ox = l[0] * x + l[1] * y + l[2] * z;
  oy = l[1] * x + l[3] * y + l[4] * z;
  oz = l[2] * x + l[4] * y + l[5] * z;
}

__device__ __forceinline__ float sign_of(float v) { return (float)((v > 0.f) - (v < 0.f)); }

// Butterfly sum: every lane ends with the total, in a fixed order.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// Eigenvalue-floored inverse of a packed symmetric 3x3 (00,01,02,11,12,22):
// V diag(1/max(lambda, floor)) V^T by the Newton-form spectral polynomial,
// the same formula as the reference's eig3.floored_inverse_sym6.
__device__ __forceinline__ void floored_inverse6(const float* a, float floor, float* o) {
  const float eps = 1e-30f;
  float a00 = a[0], a01 = a[1], a02 = a[2], a11 = a[3], a12 = a[4], a22 = a[5];
  float q = (a00 + a11 + a22) / 3.f;
  float b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
  float p2 = (b00 * b00 + b11 * b11 + b22 * b22 + 2.f * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.f;
  float p = sqrtf(fmaxf(p2, eps));
  float detb = b00 * (b11 * b22 - a12 * a12) - a01 * (a01 * b22 - a12 * a02) +
               a02 * (a01 * a12 - b11 * a02);
  float r = fminf(fmaxf(detb / (2.f * p * p * p), -1.f), 1.f);
  float phi = acosf(r) / 3.f;
  float l1 = q + 2.f * p * cosf(phi);
  float l3 = q + 2.f * p * cosf(phi + 2.0943951023931953f);
  float l2 = 3.f * q - l1 - l3;
  if (p2 < eps) l1 = l2 = l3 = q;

  auto g = [&](float x) { return 1.f / fmaxf(x, floor); };
  auto dg = [&](float x) { return x > floor ? -1.f / fmaxf(x * x, eps) : 0.f; };
  auto d2g = [&](float x) { return x > floor ? 2.f / fmaxf(x * x * x, eps) : 0.f; };
  auto ddiff = [&](float la, float lb) {
    float d = la - lb;
    return fabsf(d) < 1e-6f ? dg(0.5f * (la + lb)) : (g(la) - g(lb)) / d;
  };
  float dd1 = g(l1);
  float dd12 = ddiff(l1, l2);
  float dd23 = ddiff(l2, l3);
  float d13 = l1 - l3;
  float dd123 = fabsf(d13) < 1e-6f ? 0.5f * d2g(0.5f * (l1 + l3)) : (dd12 - dd23) / d13;

  float p00 = a00 - l1, p11 = a11 - l1, p22 = a22 - l1;
  float q00 = a00 - l2, q11 = a11 - l2, q22 = a22 - l2;
  float r00 = p00 * q00 + a01 * a01 + a02 * a02;
  float r01 = p00 * a01 + a01 * q11 + a02 * a12;
  float r02 = p00 * a02 + a01 * a12 + a02 * q22;
  float r11 = a01 * a01 + p11 * q11 + a12 * a12;
  float r12 = a01 * a02 + p11 * a12 + a12 * q22;
  float r22 = a02 * a02 + a12 * a12 + p22 * q22;
  o[0] = dd12 * p00 + dd123 * r00 + dd1;
  o[1] = dd12 * a01 + dd123 * r01;
  o[2] = dd12 * a02 + dd123 * r02;
  o[3] = dd12 * p11 + dd123 * r11 + dd1;
  o[4] = dd12 * a12 + dd123 * r12;
  o[5] = dd12 * p22 + dd123 * r22 + dd1;
}
