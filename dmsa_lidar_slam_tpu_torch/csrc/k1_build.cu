// K1: Gaussian cell build over voxel-sorted points -> packed rows [16, n].
//
// Replaces the TPU kernels _build_fwd_kernel + _build_bwd_kernel of
// dmsa_lidar_slam_tpu/ops/fused_residuals.py (compact path: world points
// recomputed from (pose table, xs, tidx); tidx, ring and mask decoded from
// one f32 `enc` lane).
//
// What bounds it here: memory traffic and latency, not arithmetic.  Per
// point it reads 6 f32 of sorted input plus one 32-byte table row (the
// table is small and stays in L1/L2) and writes 16 f32; per cell it runs
// one closed-form 3x3 eigen solve.  At n = 409,600 that is ~36 MB of
// device traffic.  Runs (cells) are contiguous but unbounded in length.
//
// Design: a warp owns 32 consecutive sorted positions and processes every
// run that STARTS among them, cooperatively: lanes take 32 members at a
// time, sums are warp-reduced with a fixed butterfly (deterministic), so a
// giant cell costs n_run / 32 steps instead of n_run serial steps.
// Moments are taken about the run's first member (f32 cancellation at cell
// scale, as the TPU kernel).  The cell stats are then written to every
// member directly (no backward broadcast pass is needed on this card).
// The global weight normalization needs the sums over all cells, which
// blocks running in no order cannot share: k1_build_finish reduces the
// per-end-row (valid, raw weight) in one block in a fixed order and then
// scales the lamw6 rows, so the result does not change from run to run.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

struct Member {
  float x, y, z;     // local point
  float px, py, pz;  // world point * w
  float w;
  int ring, tidx;
};

__device__ __forceinline__ Member load_member(const float* __restrict__ tab,
                                              const float* __restrict__ kin, int n, int j) {
  Member m;
  m.x = kin[j];
  m.y = kin[n + j];
  m.z = kin[2 * n + j];
  int enc = (int)kin[3 * n + j];
  m.w = (float)(enc & 1);
  m.ring = (enc >> 1) & 1023;
  m.tidx = enc >> 11;
  Pose p = load_pose(tab, m.tidx);
  float ox, oy, oz;
  transform(p, m.x, m.y, m.z, ox, oy, oz);
  m.px = ox * m.w;
  m.py = oy * m.w;
  m.pz = oz * m.w;
  return m;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    build_fwd(const float* __restrict__ tab, const float* __restrict__ kin, int n,
              int min_points, float floor, float* __restrict__ packed,
              float* __restrict__ endw) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int base = warp * 32;
  if (base >= n) return;
  const float* newc = kin + 4 * n;
  const float* is_end = kin + 5 * n;

  const int mypos = base + lane;
  unsigned starts = __ballot_sync(FULL_MASK, mypos < n && newc[mypos] > 0.5f);
  while (starts) {
    const int s = base + __ffs(starts) - 1;
    starts &= starts - 1;

    // origin = world point of the run's first member
    Member first = load_member(tab, kin, n, s);
    const float o_x = first.px, o_y = first.py, o_z = first.pz;

    float cnt = 0.f, s1x = 0.f, s1y = 0.f, s1z = 0.f;
    float m00 = 0.f, m01 = 0.f, m02 = 0.f, m11 = 0.f, m12 = 0.f, m22 = 0.f, rc = 0.f;
    int e = -1;  // run end position
    for (int c0 = s; e < 0; c0 += 32) {
      const int j = c0 + lane;
      const bool inb = j < n;
      unsigned ends = __ballot_sync(FULL_MASK, inb && is_end[j] > 0.5f);
      int last_lane = ends ? __ffs(ends) - 1 : 31;
      if (ends) e = c0 + last_lane;
      if (inb && lane <= last_lane) {
        Member mb = load_member(tab, kin, n, j);
        float dx = (mb.px - o_x) * mb.w, dy = (mb.py - o_y) * mb.w, dz = (mb.pz - o_z) * mb.w;
        cnt += mb.w;
        s1x += dx;
        s1y += dy;
        s1z += dz;
        m00 += dx * dx;
        m01 += dx * dy;
        m02 += dx * dz;
        m11 += dy * dy;
        m12 += dy * dz;
        m22 += dz * dz;
        if (j > s) {
          int prev_ring = ((int)kin[3 * n + j - 1] >> 1) & 1023;
          rc += (mb.ring != prev_ring) ? 1.f : 0.f;
        }
      }
    }
    cnt = warp_sum(cnt);
    s1x = warp_sum(s1x);
    s1y = warp_sum(s1y);
    s1z = warp_sum(s1z);
    m00 = warp_sum(m00);
    m01 = warp_sum(m01);
    m02 = warp_sum(m02);
    m11 = warp_sum(m11);
    m12 = warp_sum(m12);
    m22 = warp_sum(m22);
    rc = warp_sum(rc);

    // cell statistics (every lane computes the same values)
    const float safe_n = fmaxf(cnt, 1.f);
    const float mx = s1x / safe_n, my = s1y / safe_n, mz = s1z / safe_n;
    const float den = fmaxf(cnt - 1.f, 1.f);
    float cov[6] = {(m00 - cnt * mx * mx) / den, (m01 - cnt * mx * my) / den,
                    (m02 - cnt * mx * mz) / den, (m11 - cnt * my * my) / den,
                    (m12 - cnt * my * mz) / den, (m22 - cnt * mz * mz) / den};
    const bool valid = cnt > 0.5f && cnt >= (float)min_points && rc > 0.5f;
    const float validf = valid ? 1.f : 0.f;
    float info[6];
    floored_inverse6(cov, floor, info);
    const float raw_w = cnt / (safe_n * safe_n);  // obs = w in the compact path
    const float lw = raw_w * validf;
    const float mu_x = o_x + mx, mu_y = o_y + my, mu_z = o_z + mz;
    const float invn = validf / safe_n;

    // write every member's packed column
    for (int c0 = s; c0 <= e; c0 += 32) {
      const int j = c0 + lane;
      if (j > e) break;
      int enc = (int)kin[3 * n + j];
      packed[0 * n + j] = kin[j];
      packed[1 * n + j] = kin[n + j];
      packed[2 * n + j] = kin[2 * n + j];
      packed[3 * n + j] = mu_x;
      packed[4 * n + j] = mu_y;
      packed[5 * n + j] = mu_z;
#pragma unroll
      for (int c = 0; c < 6; ++c) packed[(6 + c) * n + j] = info[c] * lw;
      packed[12 * n + j] = (float)(enc & 1);
      packed[13 * n + j] = (float)(enc >> 11);
      packed[14 * n + j] = (j == s) ? 1.f : 0.f;
      const bool end_row = j == e;
      packed[15 * n + j] = end_row ? invn : 0.f;
      endw[j] = end_row ? validf : 0.f;
      endw[n + j] = end_row ? validf * raw_w : 0.f;
    }
  }
}

constexpr int kReduceThreads = 1024;

// One block: (valid count, raw-weight sum) over all end rows, fixed order.
__global__ void __launch_bounds__(kReduceThreads)
    build_reduce(const float* __restrict__ endw, int n, float* __restrict__ stats,
                 int* __restrict__ nvalid) {
  __shared__ float sc[kReduceThreads], sw[kReduceThreads];
  float c = 0.f, w = 0.f;
  for (int j = threadIdx.x; j < n; j += kReduceThreads) {
    c += endw[j];
    w += endw[n + j];
  }
  sc[threadIdx.x] = c;
  sw[threadIdx.x] = w;
  __syncthreads();
  for (int s = kReduceThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      sc[threadIdx.x] += sc[threadIdx.x + s];
      sw[threadIdx.x] += sw[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    stats[0] = sc[0];
    stats[1] = sc[0] / fmaxf(sw[0], 1e-30f);  // weight normalization
    *nvalid = (int)(sc[0] + 0.5f);
  }
}

__global__ void build_normalize(const float* __restrict__ stats, int n,
                                float* __restrict__ packed) {
  const float wnorm = stats[1];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < 6 * n; i += gridDim.x * blockDim.x)
    packed[6 * n + i] *= wnorm;
}

}  // namespace

extern "C" int k1_build_fwd(const float* tab, int dtab, const float* kin, int n, int min_points,
                            float floor, float* packed, float* endw, cudaStream_t stream) {
  (void)dtab;
  const int warps = (n + 31) / 32;
  const int blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0)
    build_fwd<<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(tab, kin, n, min_points, floor, packed,
                                                          endw);
  return (int)cudaGetLastError();
}

extern "C" int k1_build_finish(const float* endw, int n, float* packed, float* stats,
                               int* nvalid, cudaStream_t stream) {
  build_reduce<<<1, kReduceThreads, 0, stream>>>(endw, n, stats, nvalid);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int blocks = min((6 * n + 255) / 256, 1024);
  if (blocks > 0) build_normalize<<<blocks, 256, 0, stream>>>(stats, n, packed);
  return (int)cudaGetLastError();
}
