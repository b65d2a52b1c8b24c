// K1: Gaussian cell build over voxel-sorted points -> packed rows [16, n].
//
// Replaces the TPU kernels _build_fwd_kernel + _build_bwd_kernel of
// dmsa_lidar_slam_tpu/ops/fused_residuals.py (compact path: world points
// recomputed from (pose table, xs, tidx)).  The voxel sort between the key
// kernel and the build stays one torch.sort, as the TPU package leaves it
// to XLA.
//
// What bounds it on this card: neither bytes nor operations but launches
// and latency.  At the window shape (n = 28,672) the whole call moves
// ~3 MB, under a microsecond of HBM time, so what costs is the number of
// launches the host has to enqueue and the chains of dependent loads inside
// the kernels.  Per point the build reads its sorted key and slot, gathers
// the local point, table index, ring and mask through the slot and one
// 32-byte table row (the table stays in L1/L2), and writes 16 f32; per cell
// it runs one closed-form 3x3 eigen solve.  Runs (cells) are contiguous in
// the sorted order but unbounded in length: the masked points form one run
// of ~5% of n, and the one warp that walks it sets the build kernel's time
// at large n.  At the window shape the host's enqueue sets the call's pace,
// half of it the sort's 11 kernels and 10 memsets.
//
// Design: three launches around the sort and no other device work.
//  - voxel_key: one thread per point writes the int64 sort key, bit for bit
//    voxel.combined_key(*voxel.voxel_keys(...)) as PyTorch computes it on
//    the card: p * (1/g) for a grid given as a host number (PyTorch's CUDA
//    division by a host scalar multiplies by its f32 reciprocal), p / g
//    rounded once for a grid that is a device tensor.  No fast math.
//  - build_fwd: a warp owns the runs that START among 32 consecutive sorted
//    positions and processes each cooperatively; a run's members are those
//    whose sorted key equals the first member's (no run-flag tensors).
//    Lanes gather kUnroll x 32 members per step through the sort order
//    (several independent loads in flight, so a run of 20,000 masked points
//    costs ~80 steps), sums are warp-reduced with a fixed butterfly, and
//    moments are taken about the run's first member (f32 cancellation at
//    cell scale, as the TPU kernel).  The cell stats are written to every
//    member directly.  Each block writes its partial sums in block order:
//    valid cells, raw cells (run starts of unmasked points) and the raw
//    weight of its valid cells.
//  - build_finish: every block sums all the block partials in one fixed
//    order (so all blocks agree bit for bit), scales its slice of the lamw6
//    rows by the global weight normalisation, and block 0 writes nvalid and
//    num_raw as device scalars.  No float atomics: the packed rows come out
//    bit-identical from one run to the next.
#include "common.cuh"

namespace {

constexpr int kKeyThreads = 256;
constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 8;
constexpr int kFinishThreads = 256;
constexpr int kFinishBlocks = 264;  // two per SM

constexpr unsigned kCoordOffset = 1u << 14;
constexpr unsigned kInvalidKey = 0x7fffffffu;

// Per-block partial sums of build_fwd, summed by build_finish.
struct BlockPartial {
  int valid;   // valid cells
  int raw;     // run starts of unmasked points
  float w;     // raw weight count / n^2 over valid cells
  int pad;
};

// voxel.voxel_coords: int32(floor(p / g)) + 2^14, with PyTorch's rounding
__device__ __forceinline__ unsigned voxel_coord(float p, float g, bool divide) {
  const float v = divide ? __fdiv_rn(p, g) : __fmul_rn(p, g);
  return (unsigned)__float2int_rz(floorf(v)) + kCoordOffset;
}

// grid null: g_host is the f32 reciprocal of a host grid; else divide by
// the f32 device scalar *grid.
__global__ void __launch_bounds__(kKeyThreads)
    voxel_key(const float* __restrict__ pts, const unsigned char* __restrict__ mask,
              const int* __restrict__ split, int n, float g_host, const float* __restrict__ grid,
              long long* __restrict__ key) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool divide = grid != nullptr;
  const float g = divide ? *grid : g_host;
  unsigned hi = kInvalidKey, lo = kInvalidKey;
  if (mask[i]) {
    const unsigned c0 = voxel_coord(pts[3 * i], g, divide);
    const unsigned c1 = voxel_coord(pts[3 * i + 1], g, divide);
    const unsigned c2 = voxel_coord(pts[3 * i + 2], g, divide);
    hi = (c0 << 16) | (c1 & 0xffffu);
    lo = split ? (c2 << 3) | ((unsigned)split[i] & 7u) : c2;
  }
  // (int64(hi) << 32) + (int64(lo) + 2^31), in the wrap-around of int64
  const unsigned long long h = (unsigned long long)(long long)(int)hi << 32;
  key[i] = (long long)(h + (unsigned long long)((long long)(int)lo + 2147483648LL));
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    build_fwd(const float* __restrict__ tab, const float* __restrict__ xs,
              const long long* __restrict__ tidx, const int* __restrict__ rings,
              const unsigned char* __restrict__ mask, const long long* __restrict__ key_s,
              const long long* __restrict__ order, int n, int min_points, float floor,
              float* __restrict__ packed, BlockPartial* __restrict__ partial) {
  __shared__ BlockPartial s_warp[kWarpsPerBlock];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int base = (blockIdx.x * kWarpsPerBlock + wib) * 32;
  int n_valid = 0, n_raw = 0;
  float w_sum = 0.f;

  if (base < n) {
    const int mypos = base + lane;
    const bool is_start = mypos < n && (mypos == 0 || key_s[mypos] != key_s[mypos - 1]);
    unsigned starts = __ballot_sync(FULL_MASK, is_start);
    while (starts) {
      const int s = base + __ffs(starts) - 1;
      starts &= starts - 1;
      const long long ks = key_s[s];

      // origin = world point (times validity) of the run's first member
      const int o0 = (int)order[s];
      const float w0 = mask[o0] ? 1.f : 0.f;
      float o_x, o_y, o_z;
      transform(load_pose(tab, (int)tidx[o0]), xs[3 * o0], xs[3 * o0 + 1], xs[3 * o0 + 2], o_x, o_y,
                o_z);
      o_x *= w0;
      o_y *= w0;
      o_z *= w0;

      float cnt = 0.f, s1x = 0.f, s1y = 0.f, s1z = 0.f;
      float m00 = 0.f, m01 = 0.f, m02 = 0.f, m11 = 0.f, m12 = 0.f, m22 = 0.f, rc = 0.f;
      int len = 0;        // members of the run
      int ring_carry = 0; // ring of the last member before the current slice
      for (int c0 = s;; c0 += 32 * kUnroll) {
        // Every load is unconditional, at a position clamped into the
        // array, so the kUnroll slices' gathers are in flight together;
        // lanes outside the run add nothing (selects, not branches).
        bool in[kUnroll];
        int o[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = c0 + 32 * u + lane;
          const int jc = min(j, n - 1);
          in[u] = j < n && key_s[jc] == ks;
          o[u] = (int)order[jc];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int oj = o[u];
          // ring of the previous sorted member: lane - 1, or for lane 0 the
          // last lane of the previous slice (or step)
          const int ring = rings[oj];
          int prev = __shfl_up_sync(FULL_MASK, ring, 1);
          if (lane == 0) prev = ring_carry;
          ring_carry = __shfl_sync(FULL_MASK, ring, 31);
          const float w = mask[oj] ? 1.f : 0.f;
          float px, py, pz;
          transform(load_pose(tab, (int)tidx[oj]), xs[3 * oj], xs[3 * oj + 1], xs[3 * oj + 2], px, py,
                    pz);
          const bool mem = in[u];
          const float dx = mem ? (px * w - o_x) * w : 0.f;
          const float dy = mem ? (py * w - o_y) * w : 0.f;
          const float dz = mem ? (pz * w - o_z) * w : 0.f;
          cnt += mem ? w : 0.f;
          s1x += dx;
          s1y += dy;
          s1z += dz;
          m00 += dx * dx;
          m01 += dx * dy;
          m02 += dx * dz;
          m11 += dy * dy;
          m12 += dy * dz;
          m22 += dz * dz;
          rc += (mem && c0 + 32 * u + lane > s && ring != prev) ? 1.f : 0.f;
        }
        bool more = true;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const unsigned b = __ballot_sync(FULL_MASK, in[u]);
          len += __popc(b);
          more = more && b == FULL_MASK;
        }
        if (!more) break;
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
      const float lw = raw_w * validf;              // build_finish normalises
      const float mu_x = o_x + mx, mu_y = o_y + my, mu_z = o_z + mz;
      const float invn = validf / safe_n;
      n_valid += valid ? 1 : 0;
      n_raw += w0 > 0.f ? 1 : 0;
      w_sum += validf * raw_w;

      // write every member's packed column
      const int e = s + len - 1;
      for (int c0 = s; c0 <= e; c0 += 32 * kUnroll) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = c0 + 32 * u + lane;
          const int oj = (int)order[min(j, e)];  // unconditional, as above
          const float x = xs[3 * oj], y = xs[3 * oj + 1], z = xs[3 * oj + 2];
          const float wj = mask[oj] ? 1.f : 0.f;
          const float tj = (float)tidx[oj];
          if (j <= e) {
            packed[0 * n + j] = x;
            packed[1 * n + j] = y;
            packed[2 * n + j] = z;
            packed[3 * n + j] = mu_x;
            packed[4 * n + j] = mu_y;
            packed[5 * n + j] = mu_z;
#pragma unroll
            for (int c = 0; c < 6; ++c) packed[(6 + c) * n + j] = info[c] * lw;
            packed[12 * n + j] = wj;
            packed[13 * n + j] = tj;
            packed[14 * n + j] = (j == s) ? 1.f : 0.f;
            packed[15 * n + j] = (j == e) ? invn : 0.f;
          }
        }
      }
    }
  }
  if (lane == 0) s_warp[wib] = BlockPartial{n_valid, n_raw, w_sum, 0};
  __syncthreads();
  if (threadIdx.x == 0) {
    BlockPartial t{0, 0, 0.f, 0};
    for (int w = 0; w < kWarpsPerBlock; ++w) {
      t.valid += s_warp[w].valid;
      t.raw += s_warp[w].raw;
      t.w += s_warp[w].w;
    }
    partial[blockIdx.x] = t;
  }
}

__global__ void __launch_bounds__(kFinishThreads)
    build_finish(const BlockPartial* __restrict__ partial, int nparts, int n,
                 float* __restrict__ packed, int* __restrict__ nvalid,
                 long long* __restrict__ num_raw) {
  __shared__ int sv[kFinishThreads];
  __shared__ long long sr[kFinishThreads];
  __shared__ float sw[kFinishThreads];
  int v = 0;
  long long r = 0;
  float w = 0.f;
  for (int i = threadIdx.x; i < nparts; i += kFinishThreads) {
    v += partial[i].valid;
    r += partial[i].raw;
    w += partial[i].w;
  }
  sv[threadIdx.x] = v;
  sr[threadIdx.x] = r;
  sw[threadIdx.x] = w;
  __syncthreads();
  for (int s = kFinishThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      sv[threadIdx.x] += sv[threadIdx.x + s];
      sr[threadIdx.x] += sr[threadIdx.x + s];
      sw[threadIdx.x] += sw[threadIdx.x + s];
    }
    __syncthreads();
  }
  const float wnorm = (float)sv[0] / fmaxf(sw[0], 1e-30f);  // mean raw weight -> 1
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *nvalid = sv[0];
    *num_raw = sr[0];
  }
  float* lam = packed + 6 * (size_t)n;
  const size_t total = 6 * (size_t)n;
  for (size_t i = (size_t)blockIdx.x * kFinishThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kFinishThreads)
    lam[i] *= wnorm;
}

}  // namespace

extern "C" int k1_voxel_keys(const float* pts, const unsigned char* mask, const int* split, int n,
                             float g_host, const float* grid, long long* key, cudaStream_t stream) {
  if (n > 0)
    voxel_key<<<(n + kKeyThreads - 1) / kKeyThreads, kKeyThreads, 0, stream>>>(
        pts, mask, split, n, g_host, grid, key);
  return (int)cudaGetLastError();
}

// partial: 16 bytes for each block of 256 sorted positions
// (fused_residuals.K1_BLOCK_POSITIONS).
extern "C" int k1_build(const float* tab, const float* xs, const long long* tidx, const int* rings,
                        const unsigned char* mask, const long long* key_s, const long long* order,
                        int n, int min_points, float floor, float* packed, void* partial,
                        int* nvalid, long long* num_raw, cudaStream_t stream) {
  BlockPartial* bp = static_cast<BlockPartial*>(partial);
  const int nparts = (n + 32 * kWarpsPerBlock - 1) / (32 * kWarpsPerBlock);
  if (nparts > 0)
    build_fwd<<<nparts, 32 * kWarpsPerBlock, 0, stream>>>(tab, xs, tidx, rings, mask, key_s, order, n,
                                                          min_points, floor, packed, bp);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int blocks = max(1, min(kFinishBlocks, (int)((6 * (long long)n + 1023) / 1024)));
  build_finish<<<blocks, kFinishThreads, 0, stream>>>(bp, nparts, n, packed, nvalid, num_raw);
  return (int)cudaGetLastError();
}
