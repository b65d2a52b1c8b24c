// K6: the window's pose tables and their parameter Jacobian in one launch,
// and the same tables at the line search's candidate parameters in another.
//
// Replaces no TPU kernel.  The JAX package builds these tables inside its
// one jitted step, where XLA fuses the graph; the port ran the same graph
// eagerly (trajectory/continuous.py _window_tables, torch.func.jacfwd of it
// over the P parameters, torch.func.vmap of it over the K candidates):
// ~2,600 tiny f64 kernels a Gauss-Newton iteration, each costing the host
// tens of microseconds.  This kernel computes what those do, in f64:
//   the control chain (C poses: axang2quat, the Hillis-Steele prefix
//   composition and its normalisation, quat2axang, axang2quat again), the
//   D dense rows (barycentric translations A @ transl, slerped
//   orientations), the trailing identity row, and the C - 1 IMU residuals
//   (rotm2quat's pivot, the 9 x 9 quadratic form); tables out in f32, as
//   `.to(float32)` rounds them, residuals in f64.
//
// What bounds it here: latency.  The work is ~10^7 f64 operations and the
// output ~0.5 MB (D = 501, P = 30); the longest dependent chain is one
// thread's control chain followed by one IMU residual.
//
// Design: forward mode by dual numbers (value, one tangent).  A "lane" is
// one unit tangent (jacobian mode: lane p seeds parameter p, every lane
// also carries the value) or one candidate's parameters (batch mode, zero
// tangents: one code path for both modes keeps the build as short as the
// other kernels').  Each block takes kGroup lanes: its first kGroup threads
// build their lane's control chain in shared memory, then the block's threads
// spread over dense rows x lanes (a warp: one lane, 32 consecutive rows, so
// its stores are 1 KB contiguous), or, in the IMU block of the lane group,
// over intervals x lanes.  Every output element is written by one thread:
// no atomics, and a call repeats its bits.
//
// Every branch is the branch torch.func differentiates in the PyTorch code
// (core/rotations.py): axang2quat's and axang2rotm's series at theta^2 <
// 1e-12, quat2axang's sign and its small-|v| branch, quat_slerp's sign flip,
// its clamp (the tangent passes where the value is inside [-1, 1], bounds
// included) and its `close` lerp, rotm2quat's argmax pivot, and the norm's
// zero tangent at 0.  An unchosen branch is never evaluated, so the
// infinite slopes it may hold (acos at 1) never reach a tangent.
#include <cuda_runtime.h>
#include <math.h>
#include "dual.cuh"

namespace {

constexpr int kGroup = 8;  // lanes per block
constexpr int kRows = 32;  // dense rows per block (one warp's)
constexpr int kThreads = kGroup * kRows;
constexpr int kMaxCtrl = 16;
constexpr int kSlots = 10;  // per control pose: q (4), global transl (3), global orient (3)

// rotations.quat_slerp at the constant fraction u
__device__ void quat_slerp(const Dual* q1, const Dual* q2in, double u, Dual* o) {
  Dual dot = q1[0] * q2in[0] + q1[1] * q2in[1] + q1[2] * q2in[2] + q1[3] * q2in[3];
  const double flip = dot.v < 0.0 ? -1.0 : 1.0;
  dot = vclamp(vabs(dot), -1.0, 1.0);
  Dual w1 = mk(1.0 - u), w2 = mk(u);
  if (!(sin(acos(dot.v)) < 1e-6)) {
    const Dual th = vacos(dot);
    const Dual st = vsin(th);
    w1 = vsin((1.0 - u) * th) / st;
    w2 = vsin(u * th) / st;
  }
  Dual q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = w1 * q1[i] + w2 * (q2in[i] * flip);
  const Dual n = vnorm<4>(q);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = q[i] / n;
}

struct Args {
  const double* params;  // [P] (jacobian mode) or [lanes, P] (batch mode)
  bool jac;
  int lanes, P, C, D, L, E;
  const double *anchor_o, *anchor_t;       // [3]
  const double* A;                         // [D, C]
  const long long *left, *right;           // [D]
  const double* u;                         // [D]
  const double *dt, *stamps, *gravity;     // [], [C], [3]
  const double *prot, *pvel, *ppos, *cov;  // [C-1, 3, 3], [C-1, 3], [C-1, 3], [C-1, 9, 9]
  const double* bal;                       // []
  float* tab;      // jacobian mode: [D + 1, 8]; batch mode: [lanes, D + 1, 8]
  double* extra;   // jacobian mode: [E]; batch mode: [lanes, E]
  float* dtab;     // jacobian mode: [P, D + 1, 8]
  double* jextra;  // jacobian mode: [P, E]
};

// Parameter i of the lane: its value, and in jacobian mode the unit tangent
// of lane p.
__device__ __forceinline__ Dual param(const Args& a, int lane, int i) {
  if (a.jac) return mk(a.params[i], i == lane ? 1.0 : 0.0);
  return mk(a.params[(size_t)lane * a.P + i]);
}

// slot layout of a control pose in shared memory
constexpr int kQ = 0, kT = 4, kO = 7;

// One lane's control chain: relative poses from the parameters, the prefix
// composition of poses.compose_prefix (Hillis-Steele rounds, the same
// pairs), normalised; global orientations by quat2axang; their quaternions
// again by axang2quat (what dense_pose_tables slerps).
__device__ void build_chain(const Args& a, int lane, Dual (*sh)[kSlots]) {
  const int m = 3 * (a.C - 1);
  for (int c = 0; c < a.C; ++c) {
    Dual aa[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int io = 3 * (c - 1) + i;
      aa[i] = c == 0 ? mk(a.anchor_o[i]) : param(a, lane, io);
      sh[c][kT + i] = c == 0 ? mk(a.anchor_t[i]) : param(a, lane, m + io);
    }
    axang2quat(aa, &sh[c][kQ]);
  }
  for (int s = 1; s < a.C; s *= 2) {
    for (int i = a.C - 1; i >= s; --i) {  // descending: sh[i - s] is still the round's input
      const Dual* qa = &sh[i - s][kQ];
      Dual q[4], t[3];
      quat_mul(qa, &sh[i][kQ], q);
      quat_rotate(qa, &sh[i][kT], t);
#pragma unroll
      for (int k = 0; k < 4; ++k) sh[i][kQ + k] = q[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) sh[i][kT + k] = sh[i - s][kT + k] + t[k];
    }
  }
  for (int c = 0; c < a.C; ++c) {
    Dual q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = sh[c][kQ + k];
    const Dual n = vnorm<4>(q);
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = q[k] / n;
    quat2axang(q, &sh[c][kO]);
    axang2quat(&sh[c][kO], &sh[c][kQ]);
  }
}

// Dense translation row r: A[r] @ global translations
__device__ __forceinline__ void dense_transl(const Args& a, int r, Dual (*sh)[kSlots], Dual* t) {
  const double* Ar = a.A + (size_t)r * a.C;
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = Ar[0] * sh[0][kT + k];
  for (int c = 1; c < a.C; ++c) {
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = t[k] + Ar[c] * sh[c][kT + k];
  }
}

__device__ void dense_row(const Args& a, int lane, int r, Dual (*sh)[kSlots]) {
  float v[8], d[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = d[k] = 0.f;
  if (r == a.D) {  // the trailing identity row
    v[0] = 1.f;
  } else {
    Dual q[4], t[3];
    quat_slerp(&sh[a.left[r]][kQ], &sh[a.right[r]][kQ], a.u[r], q);
    dense_transl(a, r, sh, t);
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const Dual x = k < 4 ? q[k] : t[k - 4];
      v[k] = (float)x.v;
      d[k] = (float)x.d;
    }
  }
  float* out = a.jac ? a.dtab : a.tab;
  const float* src = a.jac ? d : v;
  float4* o = reinterpret_cast<float4*>(out + 8 * ((size_t)lane * (a.D + 1) + r));
  o[0] = make_float4(src[0], src[1], src[2], src[3]);
  o[1] = make_float4(src[4], src[5], src[6], src[7]);
  if (a.jac && lane == 0) {
    float4* p = reinterpret_cast<float4*>(a.tab + 8 * (size_t)r);
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// continuous.imu_residuals for interval k
__device__ void imu_residual(const Args& a, int lane, int k, Dual (*sh)[kSlots]) {
  const double one_div = 1.0 / *a.dt;
  const double delta_t = a.stamps[k + 1] - a.stamps[k];
  const double* g = a.gravity;
  const int p0 = k * a.L, p1 = (k + 1) * a.L;
  Dual d00[3], d01[3], d10[3], d11[3];
  dense_transl(a, p0, sh, d00);
  dense_transl(a, p0 + 1, sh, d01);
  dense_transl(a, p1 - 1, sh, d10);
  dense_transl(a, p1, sh, d11);
  Dual R[9];
  axang2rotm(&sh[k][kO], R);
  Dual dp[3], dv[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const Dual vs = one_div * (d01[i] - d00[i]);
    const Dual ve = one_div * (d11[i] - d10[i]);
    dp[i] = ((sh[k + 1][kT + i] - sh[k][kT + i]) - vs * delta_t) - (0.5 * (delta_t * delta_t)) * g[i];
    dv[i] = (ve - vs) - g[i] * delta_t;
  }
  Dual comb[9];  // rotation, velocity, position errors
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    comb[3 + i] = (R[i] * dv[0] + R[3 + i] * dv[1] + R[6 + i] * dv[2]) - a.pvel[3 * k + i];
    comb[6 + i] = (R[i] * dp[0] + R[3 + i] * dp[1] + R[6 + i] * dp[2]) - a.ppos[3 * k + i];
  }
  // relative orientation k + 1, straight from the parameters
  Dual ro[3], Rr[9], M[9], q[4];
#pragma unroll
  for (int i = 0; i < 3; ++i) ro[i] = param(a, lane, 3 * k + i);
  axang2rotm(ro, Rr);
  const double* pr = a.prot + 9 * k;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l) M[3 * i + l] = pr[i] * Rr[l] + pr[3 + i] * Rr[3 + l] + pr[6 + i] * Rr[6 + l];
  rotm2quat(M, q);
  quat2axang(q, comb);
  const double* ci = a.cov + 81 * k;
  Dual quad = mk(0.0);
  for (int i = 0; i < 9; ++i) {
    Dual row = ci[9 * i] * comb[0];
#pragma unroll
    for (int j = 1; j < 9; ++j) row = row + ci[9 * i + j] * comb[j];
    quad = quad + comb[i] * row;
  }
  const Dual res = vsqrt(vabs(quad * *a.bal) + 1e-30);
  if (a.jac) {
    a.jextra[(size_t)lane * a.E + k] = res.d;
    if (lane == 0) a.extra[k] = res.v;
  } else {
    a.extra[(size_t)lane * a.E + k] = res.v;
  }
}

// blockIdx.y: lane group; blockIdx.x: a slice of kRows table rows, or, the
// last one when the problem has IMU residuals, the group's IMU block.
__global__ void __launch_bounds__(kThreads) window_tables(Args a) {
  __shared__ Dual sh[kGroup][kMaxCtrl][kSlots];
  const int t = threadIdx.x;
  const int g0 = blockIdx.y * kGroup;
  if (t < kGroup && g0 + t < a.lanes) build_chain(a, g0 + t, sh[t]);
  __syncthreads();
  const int row_blocks = (a.D + 1 + kRows - 1) / kRows;
  if ((int)blockIdx.x < row_blocks) {
    const int j = t / kRows, r = blockIdx.x * kRows + t % kRows;
    if (g0 + j < a.lanes && r <= a.D) dense_row(a, g0 + j, r, sh[j]);
  } else {
    const int k = t / kGroup, j = t % kGroup;
    if (k < a.E && g0 + j < a.lanes) imu_residual(a, g0 + j, k, sh[j]);
  }
}

}  // namespace

// n_sets == 0: the jacobian mode, params [P]; tab [D + 1, 8], extra [E],
// dtab [P, D + 1, 8], jextra [P, E].  n_sets = K > 0: the batch mode,
// params [K, P]; tab [K, D + 1, 8], extra [K, E]; dtab, jextra unused.
// E = use_imu ? C - 1 : 0.  Every pointer on the card; none read on the
// host.
extern "C" int k6_window_tables(const double* params, int n_sets, int P, int C, int D, int use_imu,
                                const double* anchor_o, const double* anchor_t, const double* A,
                                const long long* left, const long long* right, const double* u,
                                const double* dt, const double* stamps, const double* gravity,
                                const double* prot, const double* pvel, const double* ppos,
                                const double* cov, const double* bal, float* tab, double* extra,
                                float* dtab, double* jextra, cudaStream_t stream) {
  if (C < 2 || C > kMaxCtrl || P != 6 * (C - 1) || D < C || (D - 1) % (C - 1) != 0 || n_sets < 0)
    return (int)cudaErrorInvalidValue;
  const Args a{params, n_sets == 0, n_sets == 0 ? P : n_sets, P, C, D, (D - 1) / (C - 1), use_imu ? C - 1 : 0,
               anchor_o, anchor_t, A, left, right, u, dt, stamps, gravity, prot, pvel, ppos, cov, bal,
               tab, extra, dtab, jextra};
  const int row_blocks = (D + 1 + kRows - 1) / kRows;
  const dim3 grid(row_blocks + (a.E > 0 ? 1 : 0), (a.lanes + kGroup - 1) / kGroup);
  window_tables<<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
