// K7: the submap's keyframe pose tables and their parameter Jacobian in one
// launch, and the same tables at the line search's candidate parameters in
// another.
//
// Replaces no TPU kernel.  The JAX package builds these tables inside its
// one jitted step, where XLA fuses the graph; the port ran the same graph
// eagerly (map/keyframes.py _kf_tables, torch.func.jacfwd of it over the P
// parameters, torch.func.vmap of it over the K candidates): thousands of
// tiny f64 kernels a Gauss-Newton iteration, each costing the host tens of
// microseconds.  This kernel computes what those do, in f64:
//   the keyframe chain (S poses: the anchor and the 6 (S - 1) parameters,
//   axang2quat, the Hillis-Steele prefix composition of
//   poses.compose_prefix and its normalisation, quat2axang), the table rows
//   [axang2quat(global orientation), global translation, 0] and the
//   trailing identity row, the S gravity residuals (the k > 0,
//   grav_plausible and kf_mask gate) and the S - 1 odometry residuals
//   (rotm2axang of R_cur^T R_prior, the kf_mask[1:] gate), each where the
//   problem has them; tables out in f32, as `.to(float32)` rounds them,
//   residuals in f64.
//
// What bounds it here: latency.  At S = 48, P = 282 the work is ~10^7 f64
// operations and the output under 0.7 MB; the longest dependent chain is
// one thread's prefix composition (ceil(log2 S) rounds over the chain)
// followed by one row: its normalisation, quat2axang, axang2quat and its
// two residuals.
//
// Design: forward mode by dual numbers (value, one tangent; csrc/dual.cuh).
// A "lane" is one unit tangent (jacobian mode: lane p seeds parameter p,
// every lane also carries the value) or one candidate's parameters (batch
// mode, zero tangents).  Each block takes kGroup lanes and a slice of kRows
// table rows: its first kGroup threads build their lane's prefix chain in
// shared memory (every row block of a lane group builds the same chain, the
// same bits), then, after the one barrier, a warp takes one lane and 32
// consecutive rows: row k's thread writes the row's table entries and
// keyframe k's gravity residual and odometry residual (k >= 1).  Every
// output element is written by one thread: no atomics, and a call repeats
// its bits.
#include <cuda_runtime.h>
#include <math.h>
#include "dual.cuh"

namespace {

constexpr int kGroup = 2;  // lanes per block
constexpr int kRows = 32;  // table rows per block (one warp's)
constexpr int kThreads = kGroup * kRows;
constexpr int kMaxKf = 128;  // keyframes a chain holds in shared memory
constexpr int kSlots = 7;    // per keyframe: prefix quaternion (4), global translation (3)
constexpr int kQ = 0, kT = 4;

struct Args {
  const double* params;  // [P] (jacobian mode) or [lanes, P] (batch mode)
  bool jac;
  int lanes, P, S, E;
  bool grav, odom;
  const double *anchor_o, *anchor_t;  // [3]
  const unsigned char *plausible, *kf_mask;  // [S] bool
  const double *grav_meas, *gravity, *cov_grav, *bal_grav;  // [S, 3], [3], [3, 3], []
  const double *odom_t, *odom_o, *cov_ot, *cov_oo, *bal_odom;  // [S, 3], [S, 3], [3, 3], [3, 3], []
  float* tab;      // jacobian mode: [S + 1, 8]; batch mode: [lanes, S + 1, 8]
  double* extra;   // jacobian mode: [E]; batch mode: [lanes, E]
  float* dtab;     // jacobian mode: [P, S + 1, 8]
  double* jextra;  // jacobian mode: [P, E]
};

// Parameter i of the lane: its value, and in jacobian mode the unit tangent
// of lane p.
__device__ __forceinline__ Dual param(const Args& a, int lane, int i) {
  if (a.jac) return mk(a.params[i], i == lane ? 1.0 : 0.0);
  return mk(a.params[(size_t)lane * a.P + i]);
}

// Relative pose k of the chain (poses.chain_from_params): the anchor at 0,
// else orientation params[3 (k - 1) + i] and translation params[m + ...].
__device__ __forceinline__ void relative(const Args& a, int lane, int k, Dual* o, Dual* t) {
  const int m = 3 * (a.S - 1);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int io = 3 * (k - 1) + i;
    o[i] = k == 0 ? mk(a.anchor_o[i]) : param(a, lane, io);
    t[i] = k == 0 ? mk(a.anchor_t[i]) : param(a, lane, m + io);
  }
}

// One lane's prefix chain, poses.compose_prefix before its normalisation:
// the relative quaternions by axang2quat, then the Hillis-Steele rounds of
// poses.inclusive_scan (the same pairs).
__device__ void build_chain(const Args& a, int lane, Dual (*sh)[kSlots]) {
  for (int k = 0; k < a.S; ++k) {
    Dual o[3];
    relative(a, lane, k, o, &sh[k][kT]);
    axang2quat(o, &sh[k][kQ]);
  }
  for (int s = 1; s < a.S; s *= 2) {
    for (int i = a.S - 1; i >= s; --i) {  // descending: sh[i - s] is still the round's input
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
}

// x^T C x for a constant row-major 3 x 3 C
__device__ __forceinline__ Dual quad3(const Dual* x, const double* c) {
  Dual q = mk(0.0);
#pragma unroll
  for (int i = 0; i < 3; ++i) q = q + x[i] * ((c[3 * i] * x[0] + c[3 * i + 1] * x[1]) + c[3 * i + 2] * x[2]);
  return q;
}

// where(active, sqrt(|quad| + 1e-30), 0)
__device__ __forceinline__ Dual gated_sqrt(bool active, Dual quad) {
  return active ? vsqrt(vabs(quad) + 1e-30) : mk(0.0);
}

// keyframes.gravity_residuals for keyframe k at global orientation o
__device__ Dual gravity_residual(const Args& a, int k, const Dual* o) {
  Dual R[9];
  axang2rotm(o, R);
  const double* gm = a.grav_meas + 3 * k;
  Dual diff[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) diff[i] = ((R[3 * i] * gm[0] + R[3 * i + 1] * gm[1]) + R[3 * i + 2] * gm[2]) - a.gravity[i];
  return gated_sqrt(k > 0 && a.plausible[k] && a.kf_mask[k], quad3(diff, a.cov_grav) * *a.bal_grav);
}

// keyframes.odometry_residuals for keyframe k >= 1 (relative pose k)
__device__ Dual odometry_residual(const Args& a, int lane, int k) {
  Dual o[3], t[3];
  relative(a, lane, k, o, t);
  Dual td[3], Rc[9], Rp[9], M[9], q[4], od[3];
  const Dual po[3] = {mk(a.odom_o[3 * k]), mk(a.odom_o[3 * k + 1]), mk(a.odom_o[3 * k + 2])};
#pragma unroll
  for (int i = 0; i < 3; ++i) td[i] = a.odom_t[3 * k + i] - t[i];
  axang2rotm(o, Rc);
  axang2rotm(po, Rp);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l) M[3 * i + l] = (Rc[i] * Rp[l] + Rc[3 + i] * Rp[3 + l]) + Rc[6 + i] * Rp[6 + l];
  rotm2quat(M, q);
  quat2axang(q, od);
  return gated_sqrt(a.kf_mask[k], (quad3(td, a.cov_ot) + quad3(od, a.cov_oo)) * *a.bal_odom);
}

__device__ __forceinline__ void store_row(float* out, const float* x) {
  float4* o = reinterpret_cast<float4*>(out);
  o[0] = make_float4(x[0], x[1], x[2], x[3]);
  o[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store_extra(const Args& a, int lane, int e, Dual r) {
  if (a.jac) {
    a.jextra[(size_t)lane * a.E + e] = r.d;
    if (lane == 0) a.extra[e] = r.v;
  } else {
    a.extra[(size_t)lane * a.E + e] = r.v;
  }
}

// Table row k of the lane and keyframe k's residuals; row S is the identity.
__device__ void keyframe_row(const Args& a, int lane, int k, Dual (*sh)[kSlots]) {
  float v[8], d[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = d[i] = 0.f;
  if (k == a.S) {
    v[0] = 1.f;
  } else {
    Dual q[4], o[3], qr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = sh[k][kQ + i];
    const Dual n = vnorm<4>(q);
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
    quat2axang(q, o);  // the global orientation
    axang2quat(o, qr);
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      const Dual x = i < 4 ? qr[i] : sh[k][kT + i - 4];
      v[i] = (float)x.v;
      d[i] = (float)x.d;
    }
    if (a.grav) store_extra(a, lane, k, gravity_residual(a, k, o));
    if (a.odom && k > 0) store_extra(a, lane, (a.grav ? a.S : 0) + k - 1, odometry_residual(a, lane, k));
  }
  store_row((a.jac ? a.dtab : a.tab) + 8 * ((size_t)lane * (a.S + 1) + k), a.jac ? d : v);
  if (a.jac && lane == 0) store_row(a.tab + 8 * (size_t)k, v);
}

// blockIdx.y: lane group; blockIdx.x: a slice of kRows table rows.
__global__ void __launch_bounds__(kThreads) keyframe_tables(Args a) {
  __shared__ Dual sh[kGroup][kMaxKf][kSlots];
  const int t = threadIdx.x;
  const int g0 = blockIdx.y * kGroup;
  if (t < kGroup && g0 + t < a.lanes) build_chain(a, g0 + t, sh[t]);
  __syncthreads();
  const int j = t / kRows, k = blockIdx.x * kRows + t % kRows;
  if (g0 + j < a.lanes && k <= a.S) keyframe_row(a, g0 + j, k, sh[j]);
}

}  // namespace

// n_sets == 0: the jacobian mode, params [P]; tab [S + 1, 8], extra [E],
// dtab [P, S + 1, 8], jextra [P, E].  n_sets = K > 0: the batch mode,
// params [K, P]; tab [K, S + 1, 8], extra [K, E]; dtab, jextra unused.
// E = use_grav S + use_odom (S - 1), the gravity residuals first.  The
// gravity operands are read only with use_grav, the odometry ones only with
// use_odom, kf_mask with either.  Every pointer on the card; none read on
// the host.
extern "C" int k7_keyframe_tables(const double* params, int n_sets, int P, int S, int use_grav, int use_odom,
                                  const double* anchor_o, const double* anchor_t, const unsigned char* kf_mask,
                                  const unsigned char* plausible, const double* grav_meas, const double* gravity,
                                  const double* cov_grav, const double* bal_grav, const double* odom_t,
                                  const double* odom_o, const double* cov_ot, const double* cov_oo,
                                  const double* bal_odom, float* tab, double* extra, float* dtab, double* jextra,
                                  cudaStream_t stream) {
  if (S < 2 || S > kMaxKf || P != 6 * (S - 1) || n_sets < 0) return (int)cudaErrorInvalidValue;
  const int E = (use_grav ? S : 0) + (use_odom ? S - 1 : 0);
  const Args a{params, n_sets == 0, n_sets == 0 ? P : n_sets, P, S, E, use_grav != 0, use_odom != 0,
               anchor_o, anchor_t, plausible, kf_mask, grav_meas, gravity, cov_grav, bal_grav,
               odom_t, odom_o, cov_ot, cov_oo, bal_odom, tab, extra, dtab, jextra};
  const dim3 grid((S + 1 + kRows - 1) / kRows, (a.lanes + kGroup - 1) / kGroup);
  keyframe_tables<<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
