// K2: Gauss-Newton normal equations Hext = [J e]^T [J e] over the cell
// residuals, in one pass over the packed rows plus a tiled J^T J.
//
// Replaces the TPU kernel _gn_kernel of dmsa_lidar_slam_tpu/ops/
// fused_residuals.py (gn_system).  Same math: per point the world point,
// d0 = (p - mu0) w, wL d0, the quadratic form and the quaternion VJP,
// contracted with the table Jacobian row of its pose to give u [P]; per cell
// r = sqrt(|q1 - s^T wL s / n|) and J row = sign(val)/r * u_r.  The mean
// term is omitted, as in the TPU kernel.  All in true f32 (the TPU kernel
// rounds the Jacobian gather and the run sums to bf16).
//
// What bounds it here: the per-point contraction with the table Jacobian
// (7P FMAs per point, reading 7P f32 of the [Dtab, 7, P] Jacobian from
// L1/L2), then (P+1)^2 FMAs per valid cell for J^T J.  At P = 594 the
// output Hext is 1.4 MB, far more than a block's 227 KB of shared memory.
// Cells are runs of the voxel sort and can be very long (one cell of
// 20,511 points at the 100-keyframe shape): work per cell is unbalanced.
//
// Design: (1) gn_segments: every valid cell is cut into segments of at most
// kSegment (host side, fused_residuals._k2_segments) and a warp owns the
// segments that start among 32 sorted positions, so a giant cell spreads
// over many warps.  Lanes take 32 members at a time and then, member by
// member, stride the P accumulators of u held in the warp's slice of shared
// memory (lane p owns u[p], u[p+32], ...: coalesced Jacobian reads, no
// atomics).  The segment's u and its (s, q1) sums go to a staging row in
// device memory.  (2) gn_cells: a warp per cell end sums its segments' rows
// in segment order, forms r and the J row sign(val)/r * u and writes it to
// row vid[end] of a J matrix in device memory (vid: exclusive count of
// valid cells, so rows are dense and their order is fixed).  (3) gn_jtj: a
// tiled 64x64 J^T J over the J rows with a split over row ranges; the
// partial tiles are summed in a fixed order, so Hext is deterministic.
#include "common.cuh"

namespace {

constexpr int kRowWarps = 4;

// stage_u[sid, :P] = sum over the segment's members of u_j, stage_s[sid] =
// (sum d0, sum d0^T wL d0), for every segment sid = seg_of[start] >= 0.
__global__ void __launch_bounds__(32 * kRowWarps)
    gn_segments(const float* __restrict__ tab, const float* __restrict__ jt, int P,
                const float* __restrict__ pk, int m, const int* __restrict__ seg_of,
                float* __restrict__ stage_u, float4* __restrict__ stage_s) {
  extern __shared__ float smem[];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kRowWarps + wib;
  const int base = warp * 32;
  if (base >= m) return;
  float* u = smem + wib * P;

  const int mypos = base + lane;
  int my_sid = -1, prev_sid = -1;
  if (mypos < m) {
    my_sid = seg_of[mypos];
    prev_sid = mypos > 0 ? seg_of[mypos - 1] : -1;
  }
  unsigned starts = __ballot_sync(FULL_MASK, my_sid >= 0 && my_sid != prev_sid);
  while (starts) {
    const int s = base + __ffs(starts) - 1;
    starts &= starts - 1;
    const int sid = seg_of[s];
    for (int p = lane; p < P; p += 32) u[p] = 0.f;
    __syncwarp();

    float sx = 0.f, sy = 0.f, sz = 0.f, q1 = 0.f;
    bool done = false;
    for (int c0 = s; !done; c0 += 32) {
      const int j = c0 + lane;
      // members: a prefix of the chunk (segments are contiguous)
      const bool member = j < m && seg_of[j] == sid;
      const unsigned outside = __ballot_sync(FULL_MASK, !member);
      const int cnt = outside ? __ffs(outside) - 1 : 32;
      done = outside != 0;
      float cot[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      int t = -1;
      if (lane < cnt) {
        const float xs = pk[j], ys = pk[m + j], zs = pk[2 * m + j];
        float lam[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) lam[c] = pk[(6 + c) * m + j];
        const float w = pk[12 * m + j];
        t = (int)pk[13 * m + j];
        Pose ps = load_pose(tab, t);
        float px, py, pz;
        transform(ps, xs, ys, zs, px, py, pz);
        const float dx = (px - pk[3 * m + j]) * w;
        const float dy = (py - pk[4 * m + j]) * w;
        const float dz = (pz - pk[5 * m + j]) * w;
        float lx, ly, lz;
        sym6_mv(lam, dx, dy, dz, lx, ly, lz);
        sx += dx;
        sy += dy;
        sz += dz;
        q1 += lx * dx + ly * dy + lz * dz;
        vjp_q(ps, xs, ys, zs, lx, ly, lz, cot[0], cot[1], cot[2], cot[3]);
        cot[4] = lx;
        cot[5] = ly;
        cot[6] = lz;
      }
      // Members that share a table row (sorted runs keep the original point
      // order, so a keyframe's points, or a scan's points of one dense
      // sample, sit next to each other) are summed first: a segmented lane
      // scan over equal tidx leaves each group's cotangent sum in its last
      // lane, and only those lanes are contracted.
      const int t_prev = __shfl_up_sync(FULL_MASK, t, 1);
      const int t_next = __shfl_down_sync(FULL_MASK, t, 1);
      bool head = lane == 0 || t_prev != t;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const bool h_up = __shfl_up_sync(FULL_MASK, head, o);
#pragma unroll
        for (int c = 0; c < 7; ++c) {
          const float v_up = __shfl_up_sync(FULL_MASK, cot[c], o);
          if (lane >= o && !head) cot[c] += v_up;
        }
        if (lane >= o) head = head || h_up;
      }
      unsigned tails = __ballot_sync(FULL_MASK, lane < cnt && (lane == 31 || t_next != t));
      // u[p] += sum_c cot_g[c] * jt[t_g, c, p] for each group g, in order
      while (tails) {
        const int k = __ffs(tails) - 1;
        tails &= tails - 1;
        const int tk = __shfl_sync(FULL_MASK, t, k);
        float ck[7];
#pragma unroll
        for (int c = 0; c < 7; ++c) ck[c] = __shfl_sync(FULL_MASK, cot[c], k);
        const float* jrow = jt + (size_t)tk * 7 * P;
        for (int p = lane; p < P; p += 32) {
          float acc = u[p];
#pragma unroll
          for (int c = 0; c < 7; ++c) acc += ck[c] * __ldg(jrow + c * P + p);
          u[p] = acc;
        }
      }
    }
    sx = warp_sum(sx);
    sy = warp_sum(sy);
    sz = warp_sum(sz);
    q1 = warp_sum(q1);
    __syncwarp();
    float* row = stage_u + (size_t)sid * P;
    for (int p = lane; p < P; p += 32) row[p] = u[p];
    if (lane == 0) stage_s[sid] = make_float4(sx, sy, sz, q1);
    __syncwarp();
  }
}

// For every valid cell (end row e with 1/count > 0): the sums of its
// segments first_sid[e]..seg_of[e] in segment order, r = sqrt(|q1 -
// s^T wL s / n|) and the J row sign(val)/r * u to jrows[vid[e]], r last.
__global__ void __launch_bounds__(32 * kRowWarps)
    gn_cells(const float* __restrict__ pk, int m, int P, const int* __restrict__ seg_of,
             const int* __restrict__ first_sid, const int* __restrict__ vid,
             const float* __restrict__ stage_u, const float4* __restrict__ stage_s,
             float* __restrict__ jrows, int rmax) {
  const int lane = threadIdx.x & 31;
  const int base = (blockIdx.x * kRowWarps + (threadIdx.x >> 5)) * 32;
  if (base >= m) return;
  const int mypos = base + lane;
  unsigned ends = __ballot_sync(FULL_MASK, mypos < m && pk[15 * m + mypos] > 0.f);
  const int ld = P + 1;
  while (ends) {
    const int e = base + __ffs(ends) - 1;
    ends &= ends - 1;
    const int k0 = first_sid[e], k1 = seg_of[e];
    float sx = 0.f, sy = 0.f, sz = 0.f, q1 = 0.f;
    for (int k = k0 + lane; k <= k1; k += 32) {
      const float4 v = stage_s[k];
      sx += v.x;
      sy += v.y;
      sz += v.z;
      q1 += v.w;
    }
    sx = warp_sum(sx);
    sy = warp_sum(sy);
    sz = warp_sum(sz);
    q1 = warp_sum(q1);
    const int r_idx = vid[e];
    if (r_idx >= rmax) continue;  // uniform across the warp
    const float invn = pk[15 * m + e];
    float lam[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) lam[c] = pk[(6 + c) * m + e];
    float cx, cy, cz;
    sym6_mv(lam, sx, sy, sz, cx, cy, cz);
    const float val = q1 - invn * (cx * sx + cy * sy + cz * sz);
    const float r = sqrtf(fabsf(val) + 1e-30f);
    const float scale = sign_of(val) / r;
    float* row = jrows + (size_t)r_idx * ld;
    for (int p = lane; p < P; p += 32) {
      float acc = 0.f;
#pragma unroll 4
      for (int k = k0; k <= k1; ++k) acc += stage_u[(size_t)k * P + p];
      row[p] = scale * acc;
    }
    if (lane == 0) row[P] = r;
  }
}

constexpr int kTile = 64;
constexpr int kK = 32;

// partial[z] = sum over the z-th row range of J^T J, for one 64x64 tile.
__global__ void __launch_bounds__(256)
    gn_jtj(const float* __restrict__ jrows, const int* __restrict__ nrows_dev, int P1,
           float* __restrict__ partial) {
  __shared__ float As[kK][kTile + 1];
  __shared__ float Bs[kK][kTile + 1];
  const int nrows = *nrows_dev;
  const int splits = gridDim.z;
  const int per = (nrows + splits - 1) / splits;
  const int r0 = blockIdx.z * per;
  const int r1 = min(nrows, r0 + per);
  const int a0 = blockIdx.y * kTile, b0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4] = {};
  for (int k0 = r0; k0 < r1; k0 += kK) {
    for (int i = threadIdx.x; i < kK * kTile; i += 256) {
      const int kk = i / kTile, cc = i % kTile;
      const int r = k0 + kk;
      const bool ok = r < r1;
      As[kk][cc] = (ok && a0 + cc < P1) ? jrows[(size_t)r * P1 + a0 + cc] : 0.f;
      Bs[kk][cc] = (ok && b0 + cc < P1) ? jrows[(size_t)r * P1 + b0 + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = As[kk][ty + 16 * i];
        bv[i] = Bs[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] += av[i] * bv[jj];
    }
    __syncthreads();
  }
  float* out = partial + (size_t)blockIdx.z * P1 * P1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int a = a0 + ty + 16 * i, b = b0 + tx + 16 * jj;
      if (a < P1 && b < P1) out[(size_t)a * P1 + b] = acc[i][jj];
    }
}

__global__ void gn_sum_splits(const float* __restrict__ partial, int splits, int P1,
                              float* __restrict__ hext) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int nn = P1 * P1;
  if (i >= nn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * nn + i];
  hext[i] = s;
}

}  // namespace

extern "C" int k2_gn_rows(const float* tab, const float* jt, int P, const float* packed, int m,
                          const int* seg_of, const int* first_sid, const int* vid,
                          float* stage_u, float* stage_s, float* jrows, int rmax,
                          cudaStream_t stream) {
  const int warps = (m + 31) / 32;
  const int blocks = (warps + kRowWarps - 1) / kRowWarps;
  if (blocks == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)kRowWarps * P * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gn_segments, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  float4* ss = reinterpret_cast<float4*>(stage_s);
  gn_segments<<<blocks, 32 * kRowWarps, smem, stream>>>(tab, jt, P, packed, m, seg_of, stage_u, ss);
  int err = (int)cudaGetLastError();
  if (err) return err;
  gn_cells<<<blocks, 32 * kRowWarps, 0, stream>>>(packed, m, P, seg_of, first_sid, vid, stage_u, ss,
                                                   jrows, rmax);
  return (int)cudaGetLastError();
}

extern "C" int k2_gn_jtj(const float* jrows, const int* nrows, int P1, int splits, float* partial,
                         float* hext, cudaStream_t stream) {
  const int tiles = (P1 + kTile - 1) / kTile;
  dim3 grid(tiles, tiles, splits);
  gn_jtj<<<grid, 256, 0, stream>>>(jrows, nrows, P1, partial);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int nn = P1 * P1;
  gn_sum_splits<<<(nn + 255) / 256, 256, 0, stream>>>(partial, splits, P1, hext);
  return (int)cudaGetLastError();
}
