// Forward-mode dual numbers in f64 (value, one tangent) and the rotation
// helpers of core/rotations.py on them, shared by the pose-table kernels
// (K6 k6_window_tables.cu, K7 k7_keyframe_tables.cu).
//
// Every branch is the branch torch.func differentiates in the PyTorch code:
// axang2quat's and axang2rotm's series at theta^2 < 1e-12, quat2axang's
// sign and its small-|v| branch, rotm2quat's argmax pivot, torch.clamp's
// tangent (passed where lo <= x <= hi), abs's (sign(x), 0 at 0) and the
// norm's zero tangent at 0.  An unchosen branch is never evaluated, so an
// infinite slope it may hold never reaches a tangent.  The including source
// brings the CUDA keywords (nvcc's own cuda_runtime.h, or the tests' host
// emulation).
#pragma once
#include <math.h>

namespace {

constexpr double kEps = 1e-12;

struct Dual {
  double v, d;
};

__device__ __forceinline__ Dual mk(double v, double d = 0.0) {
  Dual r;
  r.v = v;
  r.d = d;
  return r;
}

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return mk(a.v + b.v, a.d + b.d); }
__device__ __forceinline__ Dual operator+(Dual a, double b) { return mk(a.v + b, a.d); }
__device__ __forceinline__ Dual operator+(double a, Dual b) { return mk(a + b.v, b.d); }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return mk(a.v - b.v, a.d - b.d); }
__device__ __forceinline__ Dual operator-(Dual a, double b) { return mk(a.v - b, a.d); }
__device__ __forceinline__ Dual operator-(double a, Dual b) { return mk(a - b.v, -b.d); }
__device__ __forceinline__ Dual operator-(Dual a) { return mk(-a.v, -a.d); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) { return mk(a.v * b.v, a.d * b.v + a.v * b.d); }
__device__ __forceinline__ Dual operator*(Dual a, double b) { return mk(a.v * b, a.d * b); }
__device__ __forceinline__ Dual operator*(double a, Dual b) { return mk(a * b.v, a * b.d); }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const double q = a.v / b.v;
  return mk(q, (a.d - q * b.d) / b.v);
}
__device__ __forceinline__ Dual operator/(Dual a, double b) { return mk(a.v / b, a.d / b); }
__device__ __forceinline__ Dual operator/(double a, Dual b) {
  const double q = a / b.v;
  return mk(q, -q * b.d / b.v);
}

__device__ __forceinline__ Dual vsqrt(Dual x) {
  const double s = sqrt(x.v);
  return mk(s, x.d / (2.0 * s));
}
__device__ __forceinline__ Dual vsin(Dual x) {
  double s, c;
  sincos(x.v, &s, &c);
  return mk(s, c * x.d);
}
__device__ __forceinline__ Dual vcos(Dual x) {
  double s, c;
  sincos(x.v, &s, &c);
  return mk(c, -s * x.d);
}
__device__ __forceinline__ Dual vacos(Dual x) { return mk(acos(x.v), -x.d / sqrt(1.0 - x.v * x.v)); }
__device__ __forceinline__ Dual vatan2(Dual y, Dual x) {
  return mk(atan2(y.v, x.v), (x.v * y.d - y.v * x.d) / (x.v * x.v + y.v * y.v));
}
__device__ __forceinline__ double sgn(double x) { return (double)((x > 0.0) - (x < 0.0)); }
__device__ __forceinline__ Dual vabs(Dual x) { return mk(fabs(x.v), sgn(x.v) * x.d); }
// torch.clamp: NaN stays NaN; the tangent passes where lo <= x <= hi
__device__ __forceinline__ double clamp(double x, double lo, double hi) { return x < lo ? lo : (x > hi ? hi : x); }
__device__ __forceinline__ Dual vclamp(Dual x, double lo, double hi) {
  return mk(clamp(x.v, lo, hi), (x.v >= lo && x.v <= hi) ? x.d : 0.0);
}
__device__ __forceinline__ Dual vclamp_min(Dual x, double lo) { return mk(x.v < lo ? lo : x.v, x.v >= lo ? x.d : 0.0); }

// torch.linalg.norm of a short vector: a zero tangent at 0
template <int K>
__device__ __forceinline__ Dual vnorm(const Dual* x) {
  double s = x[0].v * x[0].v, t = x[0].v * x[0].d;
#pragma unroll
  for (int i = 1; i < K; ++i) {
    s += x[i].v * x[i].v;
    t += x[i].v * x[i].d;
  }
  const double n = sqrt(s);
  return mk(n, n > 0.0 ? t / n : 0.0);
}

__device__ __forceinline__ void cross(const Dual* a, const Dual* b, Dual* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// rotations.axang2quat
__device__ void axang2quat(const Dual* a, Dual* q) {
  const Dual th2 = a[0] * a[0] + a[1] * a[1] + a[2] * a[2];
  Dual k, w;
  if (th2.v < 1e-12) {
    k = 0.5 - th2 / 48.0;
    w = 1.0 - th2 / 8.0;
  } else {
    const Dual th = vsqrt(th2 + kEps);
    const Dual half = 0.5 * th;
    k = vsin(half) / th;
    w = vcos(half);
  }
  q[0] = w;
  q[1] = a[0] * k;
  q[2] = a[1] * k;
  q[3] = a[2] * k;
}

// rotations.quat2axang
__device__ void quat2axang(const Dual* qin, Dual* a) {
  const double s = sgn(qin[0].v + kEps);
  const Dual v[3] = {qin[1] * s, qin[2] * s, qin[3] * s};
  const Dual w = vclamp(qin[0] * s, -1.0, 1.0);
  const Dual vn = vnorm<3>(v);
  const Dual scale = vn.v < 1e-9 ? 2.0 / vclamp_min(w, 0.5) : (2.0 * vatan2(vn, w)) / vn;
  a[0] = v[0] * scale;
  a[1] = v[1] * scale;
  a[2] = v[2] * scale;
}

// rotations.quat_mul
__device__ __forceinline__ void quat_mul(const Dual* p, const Dual* q, Dual* o) {
  o[0] = p[0] * q[0] - p[1] * q[1] - p[2] * q[2] - p[3] * q[3];
  o[1] = p[0] * q[1] + p[1] * q[0] + p[2] * q[3] - p[3] * q[2];
  o[2] = p[0] * q[2] - p[1] * q[3] + p[2] * q[0] + p[3] * q[1];
  o[3] = p[0] * q[3] + p[1] * q[2] - p[2] * q[1] + p[3] * q[0];
}

// rotations.quat_rotate: v + w t + u x t, t = 2 (u x v)
__device__ __forceinline__ void quat_rotate(const Dual* q, const Dual* v, Dual* o) {
  Dual t[3], c[3];
  cross(q + 1, v, t);
  t[0] = 2.0 * t[0];
  t[1] = 2.0 * t[1];
  t[2] = 2.0 * t[2];
  cross(q + 1, t, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = v[i] + q[0] * t[i] + c[i];
}

// rotations.axang2rotm (Rodrigues), row-major
__device__ void axang2rotm(const Dual* a, Dual* R) {
  const Dual th2 = a[0] * a[0] + a[1] * a[1] + a[2] * a[2];
  Dual ca, cb;
  if (th2.v < 1e-12) {
    ca = 1.0 - th2 / 6.0;
    cb = 0.5 - th2 / 24.0;
  } else {
    const Dual th = vsqrt(th2 + kEps);
    ca = vsin(th) / th;
    cb = (1.0 - vcos(th)) / (th2 + kEps);
  }
  const Dual z = mk(0.0);
  const Dual K[9] = {z, -a[2], a[1], a[2], z, -a[0], -a[1], a[0], z};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const Dual kk = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j] + K[3 * i + 2] * K[6 + j];
      R[3 * i + j] = ((i == j ? 1.0 : 0.0) + ca * K[3 * i + j]) + cb * kk;
    }
}

// rotations.rotm2quat: the candidate row of the largest pivot (the first on
// a tie, as argmax); row idx holds the pivot at idx and, elsewhere, the
// pair sums of the off-diagonal entries over 4 pivot + 1e-12
__device__ void rotm2quat(const Dual* m, Dual* q) {
  const Dual piv[4] = {1.0 + ((m[0] + m[4]) + m[8]), ((1.0 + m[0]) - m[4]) - m[8],
                       ((1.0 - m[0]) + m[4]) - m[8], ((1.0 - m[0]) - m[4]) + m[8]};
  int idx = 0;
  double best = sqrt(fmax(piv[0].v, 0.0)) / 2.0;
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const double s = sqrt(fmax(piv[i].v, 0.0)) / 2.0;
    if (s > best) {
      best = s;
      idx = i;
    }
  }
  // pair (i, j), i < j: wx, wy, wz, xy, xz, yz
  const Dual pair[6] = {m[7] - m[5], m[2] - m[6], m[3] - m[1], m[1] + m[3], m[2] + m[6], m[5] + m[7]};
  const Dual p = vsqrt(vclamp_min(piv[idx], 0.0)) / 2.0;
  const Dual den = 4.0 * p + kEps;
  Dual c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int lo = min(idx, j), hi = max(idx, j);
    c[j] = j == idx ? p : pair[lo == 0 ? hi - 1 : lo + hi] / den;
  }
  const Dual n = vnorm<4>(c);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = c[i] / n;
}

}  // namespace
