// K1: Gaussian cell build over voxel-sorted points -> packed rows [16, n].
//
// Replaces the TPU kernels _build_fwd_kernel + _build_bwd_kernel of
// dmsa_lidar_slam_tpu/ops/fused_residuals.py in both of their input
// layouts (_build_decode): the compact one (dpad > 0: world points
// recomputed from (pose table, xs, tidx), obs = w) and the 12-row one
// (dpad = 0: the caller's world points, and a per-point observation weight
// whose per-cell sum gives the rebalancing weight sum(obs) / n^2 instead of
// n / n^2).  The two are instantiations of one build kernel and one finish
// (kRows12); the key kernel and the sort are shared.  The voxel sort
// between the key kernel and the build stays one torch.sort, as the TPU
// package leaves it to XLA.
//
// What bounds it on this card: neither bytes nor operations but launches
// and latency.  At the window shape (n = 28,672) the whole call moves
// ~3 MB, under a microsecond of HBM time, so what costs is the number of
// launches the host has to enqueue (half of them the sort's 11 kernels and
// 10 memsets) and the chains of dependent loads inside the kernels.  Per
// point the build reads its sorted key and slot, gathers the local point,
// table index, ring and mask through the slot and one 32-byte table row
// (the table stays in L1/L2), and writes 16 f32; per cell it runs one
// closed-form 3x3 eigen solve.  A warp's time is a few such chains: one
// gather step of at most 256 members per run it starts, a search of the
// sorted keys where its chunk opens inside a run, the eigen solve, the
// writes; no warp walks more than 256 members of one run.  On an H100 at
// the submap view a span-4 solve sees (n = 196,608, 44 of 48 keyframes
// masked) a call is ~0.14 card ms: the sort ~62 us, build_fwd ~45 us,
// build_finish ~22 us (it re-sums every long run's pieces in each of its
// blocks), against ~6 us of HBM time.
//
// Runs (cells) are contiguous in the sorted order but unbounded in length:
// every masked point gets the sentinel key, so the masked points form one
// run at the end (a third to three fifths of the window's n, the unused
// slots of its scan and static-point caps; 75-96% of the submap view's,
// whose 48 keyframes hold 2-12 active ones), and a coarse cell or the
// spatial backend's per-rank cloud can hold thousands of points.  So the
// sorted order is cut into fixed chunks of kBuildChunk = 256 positions
// (chunk k is build_fwd's block k), and a run's work follows its length:
//  - a short run (at most 256 members) is summed, finished and written
//    whole by the warp among whose 32 positions it starts, one gather step,
//    in the same order whatever the chunk cut: its bits do not depend on it;
//  - a long run (key_s[s + 256] is still its key) leaves one piece in every
//    chunk it meets.  The warp where it starts sums its members to the end
//    of that chunk; warp 0 of each later chunk that opens inside it finds
//    the run's first position by a search of the sorted keys (32 probes a
//    round, ~5 rounds at n = 196,608; two where the run is short, which
//    leaves it to its first warp) and sums the members in its chunk.
//    Each piece takes moments about the run's first member, so pieces add;
//    each writes its members' rows that need no statistics (local point,
//    validity, table index, run-start flag, a 0 in row 15).  The warp whose
//    chunk holds the run's end records it.
//  - build_finish sums each long run's pieces in chunk order, a fixed order
//    (lane i of a warp takes pieces i, i + 32, ..., then the butterfly), so
//    every block that does it gets the same bits, and writes the mean, the
//    weighted information and 1/count of the members in its own slice of
//    chunks.
//
// Design: three launches around the sort and no other device work.
//  - voxel_key: one thread per point writes the int64 sort key, bit for bit
//    voxel.combined_key(*voxel.voxel_keys(...)) as PyTorch computes it on
//    the card: p * (1/g) for a grid given as a host number (PyTorch's CUDA
//    division by a host scalar multiplies by its f32 reciprocal), p / g
//    rounded once for a grid that is a device tensor.  No fast math.
//  - build_fwd: per run start, as above; a run's members are those whose
//    sorted key equals its first member's (no run-flag tensors).  Lanes
//    gather kUnroll x 32 members per step through the sort order (several
//    independent loads in flight), sums are warp-reduced with a fixed
//    butterfly, and moments are taken about the run's first member (f32
//    cancellation at cell scale, as the TPU kernel).  The 12-row
//    instantiation reads each member's world point through the sort order
//    instead of transforming it (12 bytes instead of a table row and the
//    local point), and adds its obs * w to a twelfth warp-reduced sum, in
//    the same fixed order.  A short run's stats are written to every member
//    directly.  Each block writes its partial counts in block order: valid
//    short cells, raw cells (run starts of unmasked points), the raw weight
//    of its valid short cells and its positions in long runs; and its
//    chunk's long-run record (ChunkRuns).
//  - build_finish: every block sums all the block partials in one fixed
//    order, then every long run's pieces (warp w takes the runs that start
//    in chunk groups w, w + 8, ...), adds their valid cells and weights in
//    warp order, so all blocks agree bit for bit; writes the long runs'
//    statistics into its slice of positions, scales the slice's lamw6 rows
//    by the global weight normalisation, and block 0 writes nvalid, num_raw
//    and the long-run positions as device scalars (and adds the last to a
//    caller's counter).  No float atomics: the packed rows come out
//    bit-identical from one run to the next.  A problem with no long run
//    gives the bits of the earlier one-warp-per-run design.
#include "common.cuh"

namespace {

constexpr int kKeyThreads = 256;
constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 8;
constexpr int kBuildChunk = 32 * kWarpsPerBlock;  // sorted positions per build_fwd block
static_assert(kBuildChunk == 32 * kUnroll, "a run of one chunk is one gather step");
constexpr int kFinishThreads = 32 * kWarpsPerBlock;
constexpr int kFinishBlocks = 264;  // two per SM

constexpr unsigned kCoordOffset = 1u << 14;
constexpr unsigned kInvalidKey = 0x7fffffffu;

// Per-block partial counts and sums of build_fwd, summed by build_finish.
struct BlockPartial {
  int valid;     // valid short cells
  int raw;       // run starts of unmasked points
  float w;       // raw weight sum(obs) / n^2 over the valid short cells
  int long_pos;  // positions of the chunk in long runs
};

// Sums over members of one run: count of valid members, first and second
// moments about the run's first member, ring changes, sum of obs * w.
struct Sums {
  float cnt, s1x, s1y, s1z, m00, m01, m02, m11, m12, m22, rc, so;
};

// A chunk's long-run record.
struct ChunkRuns {
  int start;         // first position of the long run that starts in the chunk, or -1
  int end;           // that run's last position (written by its last chunk's block)
  float ox, oy, oz;  // that run's origin
  int pad[3];
  Sums first;  // that run's piece (its members from start to the chunk's end)
  Sums cont;   // the piece of a long run that started in an earlier chunk
};
static_assert(sizeof(ChunkRuns) == 128, "ChunkRuns layout");

// One cell's statistics from its sums.
struct Cell {
  float mu_x, mu_y, mu_z;
  float lam[6];  // weighted information, before build_finish normalises it
  float invn;    // 1 / count if valid, else 0
  float lw;      // raw weight times validity
  bool valid;
};

__device__ __forceinline__ void add_sums(Sums& t, const Sums& p) {
  t.cnt += p.cnt;
  t.s1x += p.s1x;
  t.s1y += p.s1y;
  t.s1z += p.s1z;
  t.m00 += p.m00;
  t.m01 += p.m01;
  t.m02 += p.m02;
  t.m11 += p.m11;
  t.m12 += p.m12;
  t.m22 += p.m22;
  t.rc += p.rc;
  t.so += p.so;
}

__device__ __forceinline__ void warp_sums(Sums& t) {
  t.cnt = warp_sum(t.cnt);
  t.s1x = warp_sum(t.s1x);
  t.s1y = warp_sum(t.s1y);
  t.s1z = warp_sum(t.s1z);
  t.m00 = warp_sum(t.m00);
  t.m01 = warp_sum(t.m01);
  t.m02 = warp_sum(t.m02);
  t.m11 = warp_sum(t.m11);
  t.m12 = warp_sum(t.m12);
  t.m22 = warp_sum(t.m22);
  t.rc = warp_sum(t.rc);
  t.so = warp_sum(t.so);
}

// World point of sorted member `o`: the caller's (12-row layout) or its
// local point through its pose table row (compact layout).
template <bool kRows12>
__device__ __forceinline__ void member_point(const float* __restrict__ tab, const float* __restrict__ pts,
                                             const float* __restrict__ xs, const long long* __restrict__ tidx,
                                             int o, float& x, float& y, float& z) {
  if constexpr (kRows12) {
    x = pts[3 * o];
    y = pts[3 * o + 1];
    z = pts[3 * o + 2];
  } else {
    transform(load_pose(tab, (int)tidx[o]), xs[3 * o], xs[3 * o + 1], xs[3 * o + 2], x, y, z);
  }
}

// The origin of the run that starts at sorted position s: its first
// member's world point times that member's validity, which it returns.
template <bool kRows12>
__device__ __forceinline__ float run_origin(const float* __restrict__ tab, const float* __restrict__ pts,
                                            const float* __restrict__ xs, const long long* __restrict__ tidx,
                                            const unsigned char* __restrict__ mask,
                                            const long long* __restrict__ order, int s, float& o_x, float& o_y,
                                            float& o_z) {
  const int o0 = (int)order[s];
  const float w0 = mask[o0] ? 1.f : 0.f;
  member_point<kRows12>(tab, pts, xs, tidx, o0, o_x, o_y, o_z);
  o_x *= w0;
  o_y *= w0;
  o_z *= w0;
  return w0;
}

// Warp-reduced sums over the members of the run of key ks (first position
// s, origin o) at sorted positions a, a + 1, ... up to `last` or the run's
// end; ring_carry is the ring of position a - 1's member (ring changes
// count at positions after s only).  Returns the number of members.
template <bool kRows12>
__device__ __forceinline__ int run_sums(const float* __restrict__ tab, const float* __restrict__ pts,
                                        const float* __restrict__ obs, const float* __restrict__ xs,
                                        const long long* __restrict__ tidx, const int* __restrict__ rings,
                                        const unsigned char* __restrict__ mask, const long long* __restrict__ key_s,
                                        const long long* __restrict__ order, int a, int last, int s, long long ks,
                                        int ring_carry, float o_x, float o_y, float o_z, Sums& t) {
  const int lane = threadIdx.x & 31;
  t = Sums{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int len = 0;
  for (int c0 = a;; c0 += 32 * kUnroll) {
    // Every load is unconditional, at a position clamped into the range,
    // so the kUnroll slices' gathers are in flight together; lanes outside
    // the run add nothing (selects, not branches).
    bool in[kUnroll];
    int o[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = c0 + 32 * u + lane;
      const int jc = min(j, last);
      in[u] = j <= last && key_s[jc] == ks;
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
      member_point<kRows12>(tab, pts, xs, tidx, oj, px, py, pz);
      const bool mem = in[u];
      if constexpr (kRows12) t.so += mem ? (obs ? obs[oj] : 1.f) * w : 0.f;
      const float dx = mem ? (px * w - o_x) * w : 0.f;
      const float dy = mem ? (py * w - o_y) * w : 0.f;
      const float dz = mem ? (pz * w - o_z) * w : 0.f;
      t.cnt += mem ? w : 0.f;
      t.s1x += dx;
      t.s1y += dy;
      t.s1z += dz;
      t.m00 += dx * dx;
      t.m01 += dx * dy;
      t.m02 += dx * dz;
      t.m11 += dy * dy;
      t.m12 += dy * dz;
      t.m22 += dz * dz;
      t.rc += (mem && c0 + 32 * u + lane > s && ring != prev) ? 1.f : 0.f;
    }
    bool more = true;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned b = __ballot_sync(FULL_MASK, in[u]);
      len += __popc(b);
      more = more && b == FULL_MASK;
    }
    if (!more || c0 + 32 * kUnroll > last) break;
  }
  warp_sums(t);
  return len;
}

// A cell's statistics from its sums (every lane computes the same values).
template <bool kRows12>
__device__ __forceinline__ Cell cell_stats(const Sums& t, float o_x, float o_y, float o_z, int min_points,
                                           float floor) {
  const float cnt = t.cnt;
  const float safe_n = fmaxf(cnt, 1.f);
  const float mx = t.s1x / safe_n, my = t.s1y / safe_n, mz = t.s1z / safe_n;
  const float den = fmaxf(cnt - 1.f, 1.f);
  float cov[6] = {(t.m00 - cnt * mx * mx) / den, (t.m01 - cnt * mx * my) / den,
                  (t.m02 - cnt * mx * mz) / den, (t.m11 - cnt * my * my) / den,
                  (t.m12 - cnt * my * mz) / den, (t.m22 - cnt * mz * mz) / den};
  Cell c;
  c.valid = cnt > 0.5f && cnt >= (float)min_points && t.rc > 0.5f;
  const float validf = c.valid ? 1.f : 0.f;
  float info[6];
  floored_inverse6(cov, floor, info);
  const float raw_w = (kRows12 ? t.so : cnt) / (safe_n * safe_n);  // obs = w in the compact layout
  c.lw = raw_w * validf;
#pragma unroll
  for (int k = 0; k < 6; ++k) c.lam[k] = info[k] * c.lw;
  c.mu_x = o_x + mx;
  c.mu_y = o_y + my;
  c.mu_z = o_z + mz;
  c.invn = validf / safe_n;
  return c;
}

// The first sorted position of key ks in [lo, hi], given that position hi
// holds it: the warp narrows [lo, hi] with 32 probes a round (keys before
// the run are smaller, so the probes in the run are a suffix of the lanes).
__device__ __forceinline__ int run_first(const long long* __restrict__ key_s, long long ks, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int q = max(lo, hi - step * (31 - lane));
    const unsigned in = __ballot_sync(FULL_MASK, key_s[q] == ks);  // lane 31 (q = hi) is in
    const int f = __ffs(in) - 1;
    const int qf = __shfl_sync(FULL_MASK, q, f);
    const int qp = __shfl_sync(FULL_MASK, q, max(f - 1, 0));
    if (f > 0) lo = qp + 1;
    hi = qf;
  }
  return lo;
}

// The packed columns of members [a, e] of the run that starts at s: local
// point, validity, table index and run-start flag, and with c (a short
// run's statistics) its mean, weighted information and 1/count at the end;
// without, 0 in row 15 (build_finish writes the rest of a long run's).
__device__ __forceinline__ void write_rows(const float* __restrict__ xs, const long long* __restrict__ tidx,
                                           const unsigned char* __restrict__ mask,
                                           const long long* __restrict__ order, int n, int a, int e, int s,
                                           const Cell* c, float* __restrict__ packed) {
  const int lane = threadIdx.x & 31;
  for (int c0 = a; c0 <= e; c0 += 32 * kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = c0 + 32 * u + lane;
      const int oj = (int)order[min(j, e)];  // unconditional, as in run_sums
      const float x = xs[3 * oj], y = xs[3 * oj + 1], z = xs[3 * oj + 2];
      const float wj = mask[oj] ? 1.f : 0.f;
      const float tj = (float)tidx[oj];
      if (j <= e) {
        packed[0 * n + j] = x;
        packed[1 * n + j] = y;
        packed[2 * n + j] = z;
        if (c) {
          packed[3 * n + j] = c->mu_x;
          packed[4 * n + j] = c->mu_y;
          packed[5 * n + j] = c->mu_z;
#pragma unroll
          for (int k = 0; k < 6; ++k) packed[(6 + k) * n + j] = c->lam[k];
        }
        packed[12 * n + j] = wj;
        packed[13 * n + j] = tj;
        packed[14 * n + j] = (j == s) ? 1.f : 0.f;
        packed[15 * n + j] = (c && j == e) ? c->invn : 0.f;
      }
    }
  }
}

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

// tab: the compact layout's pose table (null in the 12-row layout); pts,
// obs: the 12-row layout's world points and observation weights (obs null:
// 1 for every point).
template <bool kRows12>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    build_fwd(const float* __restrict__ tab, const float* __restrict__ pts, const float* __restrict__ obs,
              const float* __restrict__ xs,
              const long long* __restrict__ tidx, const int* __restrict__ rings,
              const unsigned char* __restrict__ mask, const long long* __restrict__ key_s,
              const long long* __restrict__ order, int n, int min_points, float floor,
              float* __restrict__ packed, BlockPartial* __restrict__ partial, ChunkRuns* __restrict__ runs) {
  __shared__ BlockPartial s_warp[kWarpsPerBlock];
  __shared__ int s_start[kWarpsPerBlock];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c_lo = blockIdx.x * kBuildChunk;
  const int c_hi = min(c_lo + kBuildChunk, n) - 1;  // the chunk's last position
  const int base = c_lo + 32 * wib;
  ChunkRuns& mine = runs[blockIdx.x];
  int n_valid = 0, n_raw = 0, long_pos = 0, long_start = -1;
  float w_sum = 0.f;

  if (base < n) {
    const int mypos = base + lane;
    const bool is_start = mypos < n && (mypos == 0 || key_s[mypos] != key_s[mypos - 1]);
    unsigned starts = __ballot_sync(FULL_MASK, is_start);
    while (starts) {
      const int s = base + __ffs(starts) - 1;
      starts &= starts - 1;
      const long long ks = key_s[s];
      const bool is_long = s + kBuildChunk < n && key_s[s + kBuildChunk] == ks;
      float o_x, o_y, o_z;
      const float w0 = run_origin<kRows12>(tab, pts, xs, tidx, mask, order, s, o_x, o_y, o_z);
      n_raw += w0 > 0.f ? 1 : 0;
      Sums t;
      if (is_long) {
        // its first piece: the members up to the chunk's end
        run_sums<kRows12>(tab, pts, obs, xs, tidx, rings, mask, key_s, order, s, c_hi, s, ks, 0, o_x, o_y, o_z,
                          t);
        write_rows(xs, tidx, mask, order, n, s, c_hi, s, nullptr, packed);
        long_pos += c_hi - s + 1;
        long_start = s;
        if (lane == 0) {
          mine.ox = o_x;
          mine.oy = o_y;
          mine.oz = o_z;
          mine.first = t;
        }
        continue;
      }
      const int len = run_sums<kRows12>(tab, pts, obs, xs, tidx, rings, mask, key_s, order, s, n - 1, s, ks, 0,
                                        o_x, o_y, o_z, t);
      const Cell c = cell_stats<kRows12>(t, o_x, o_y, o_z, min_points, floor);
      n_valid += c.valid ? 1 : 0;
      w_sum += c.lw;

      write_rows(xs, tidx, mask, order, n, s, s + len - 1, s, &c, packed);
    }
  }

  // The chunk opens inside a run: if it is long, its piece here.
  if (wib == 0 && c_lo > 0) {
    const long long kc = key_s[c_lo];
    if (key_s[c_lo - 1] == kc) {
      // a run that holds position c_lo - 256 is long; else it starts after it
      const int back = c_lo - kBuildChunk;
      const int s = run_first(key_s, kc, back >= 0 && key_s[back] == kc ? 0 : back + 1, c_lo - 1);
      if (s + kBuildChunk < n && key_s[s + kBuildChunk] == kc) {
        float o_x, o_y, o_z;
        run_origin<kRows12>(tab, pts, xs, tidx, mask, order, s, o_x, o_y, o_z);
        Sums t;
        const int len = run_sums<kRows12>(tab, pts, obs, xs, tidx, rings, mask, key_s, order, c_lo, c_hi, s, kc,
                                          rings[(int)order[c_lo - 1]], o_x, o_y, o_z, t);
        const int e = c_lo + len - 1;
        write_rows(xs, tidx, mask, order, n, c_lo, e, s, nullptr, packed);
        long_pos += len;
        const bool ends = e < c_hi || c_hi + 1 >= n || key_s[c_hi + 1] != kc;
        if (lane == 0) {
          mine.cont = t;
          if (ends) runs[s / kBuildChunk].end = e;
        }
      }
    }
  }

  if (lane == 0) {
    s_warp[wib] = BlockPartial{n_valid, n_raw, w_sum, long_pos};
    s_start[wib] = long_start;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    BlockPartial t{0, 0, 0.f, 0};
    int start = -1;
    for (int w = 0; w < kWarpsPerBlock; ++w) {
      t.valid += s_warp[w].valid;
      t.raw += s_warp[w].raw;
      t.w += s_warp[w].w;
      t.long_pos += s_warp[w].long_pos;
      start = max(start, s_start[w]);
    }
    partial[blockIdx.x] = t;
    mine.start = start;
  }
}

// Block b owns chunks [b cpb, (b + 1) cpb): it writes the long runs'
// statistics there and scales the lamw6 rows there.
template <bool kRows12>
__global__ void __launch_bounds__(kFinishThreads)
    build_finish(const BlockPartial* __restrict__ partial, const ChunkRuns* __restrict__ runs, int nparts, int cpb,
                 int n, int min_points, float floor, float* __restrict__ packed, int* __restrict__ nvalid,
                 long long* __restrict__ num_raw, int* __restrict__ long_out, long long* __restrict__ long_acc) {
  __shared__ int sv[kFinishThreads];
  __shared__ long long sr[kFinishThreads];
  __shared__ float sw[kFinishThreads];
  __shared__ int sl[kFinishThreads];
  __shared__ int s_lv[kWarpsPerBlock];
  __shared__ float s_lw[kWarpsPerBlock];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int v = 0, l = 0;
  long long r = 0;
  float w = 0.f;
  for (int i = threadIdx.x; i < nparts; i += kFinishThreads) {
    v += partial[i].valid;
    r += partial[i].raw;
    w += partial[i].w;
    l += partial[i].long_pos;
  }
  sv[threadIdx.x] = v;
  sr[threadIdx.x] = r;
  sw[threadIdx.x] = w;
  sl[threadIdx.x] = l;
  __syncthreads();
  for (int s = kFinishThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      sv[threadIdx.x] += sv[threadIdx.x + s];
      sr[threadIdx.x] += sr[threadIdx.x + s];
      sw[threadIdx.x] += sw[threadIdx.x + s];
      sl[threadIdx.x] += sl[threadIdx.x + s];
    }
    __syncthreads();
  }

  // the long runs, each summed from its pieces in chunk order
  const int p_lo = blockIdx.x * cpb * kBuildChunk;
  const int p_hi = min(p_lo + cpb * kBuildChunk, n);  // one past this block's last position
  int lv = 0;
  float lw = 0.f;
  for (int g0 = 32 * wib; g0 < nparts; g0 += 32 * kWarpsPerBlock) {
    const int k = g0 + lane;
    unsigned starts = __ballot_sync(FULL_MASK, k < nparts && runs[k].start >= 0);
    while (starts) {
      const int k0 = g0 + __ffs(starts) - 1;
      starts &= starts - 1;
      const int s = runs[k0].start, e = runs[k0].end;
      const int pieces = e / kBuildChunk - k0 + 1;
      Sums t{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int i = lane; i < pieces; i += 32) add_sums(t, i == 0 ? runs[k0].first : runs[k0 + i].cont);
      warp_sums(t);
      const Cell c = cell_stats<kRows12>(t, runs[k0].ox, runs[k0].oy, runs[k0].oz, min_points, floor);
      lv += c.valid ? 1 : 0;
      lw += c.lw;
      for (int j = max(s, p_lo) + lane; j <= min(e, p_hi - 1); j += 32) {
        packed[3 * n + j] = c.mu_x;
        packed[4 * n + j] = c.mu_y;
        packed[5 * n + j] = c.mu_z;
#pragma unroll
        for (int q = 0; q < 6; ++q) packed[(6 + q) * n + j] = c.lam[q];
      }
      if (lane == 0 && e >= p_lo && e < p_hi) packed[15 * n + e] = c.invn;
    }
  }
  if (lane == 0) {
    s_lv[wib] = lv;
    s_lw[wib] = lw;
  }
  __syncthreads();
  int v_all = sv[0];
  float w_all = sw[0];
  for (int q = 0; q < kWarpsPerBlock; ++q) {
    v_all += s_lv[q];
    w_all += s_lw[q];
  }
  const float wnorm = (float)v_all / fmaxf(w_all, 1e-30f);  // mean raw weight -> 1
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *nvalid = v_all;
    *num_raw = sr[0];
    *long_out = sl[0];
    if (long_acc) *long_acc += sl[0];
  }
  for (int q = 0; q < 6; ++q) {
    float* lam = packed + (size_t)(6 + q) * n;
    for (int j = p_lo + threadIdx.x; j < p_hi; j += kFinishThreads) lam[j] *= wnorm;
  }
}

}  // namespace

extern "C" int k1_voxel_keys(const float* pts, const unsigned char* mask, const int* split, int n,
                             float g_host, const float* grid, long long* key, cudaStream_t stream) {
  if (n > 0)
    voxel_key<<<(n + kKeyThreads - 1) / kKeyThreads, kKeyThreads, 0, stream>>>(
        pts, mask, split, n, g_host, grid, key);
  return (int)cudaGetLastError();
}

// The build's scratch for n sorted positions: a BlockPartial and a
// ChunkRuns record per chunk of kBuildChunk positions.
extern "C" int k1_scratch_bytes(int n, long long* nbytes) {
  const long long nparts = (n + kBuildChunk - 1) / kBuildChunk;
  nbytes[0] = nparts * (long long)(sizeof(BlockPartial) + sizeof(ChunkRuns));
  return 0;
}

template <bool kRows12>
int launch_build(const float* tab, const float* pts, const float* obs, const float* xs, const long long* tidx,
                 const int* rings, const unsigned char* mask, const long long* key_s, const long long* order,
                 int n, int min_points, float floor, float* packed, void* scratch, int* nvalid,
                 long long* num_raw, int* long_out, long long* long_acc, cudaStream_t stream) {
  const int nparts = (n + kBuildChunk - 1) / kBuildChunk;
  BlockPartial* bp = static_cast<BlockPartial*>(scratch);
  ChunkRuns* runs = reinterpret_cast<ChunkRuns*>(bp + nparts);
  if (nparts > 0)
    build_fwd<kRows12><<<nparts, 32 * kWarpsPerBlock, 0, stream>>>(tab, pts, obs, xs, tidx, rings, mask, key_s,
                                                                   order, n, min_points, floor, packed, bp, runs);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int cpb = max(1, (nparts + kFinishBlocks - 1) / kFinishBlocks);
  const int blocks = max(1, (nparts + cpb - 1) / cpb);
  build_finish<kRows12><<<blocks, kFinishThreads, 0, stream>>>(bp, runs, nparts, cpb, n, min_points, floor,
                                                               packed, nvalid, num_raw, long_out, long_acc);
  return (int)cudaGetLastError();
}

// scratch: k1_scratch_bytes(n); long_out: the positions in runs longer
// than kBuildChunk (int32); long_acc: null, or an int64 counter they are
// added to.  The compact layout.
extern "C" int k1_build(const float* tab, const float* xs, const long long* tidx, const int* rings,
                        const unsigned char* mask, const long long* key_s, const long long* order,
                        int n, int min_points, float floor, float* packed, void* scratch,
                        int* nvalid, long long* num_raw, int* long_out, long long* long_acc, cudaStream_t stream) {
  return launch_build<false>(tab, nullptr, nullptr, xs, tidx, rings, mask, key_s, order, n, min_points, floor,
                             packed, scratch, nvalid, num_raw, long_out, long_acc, stream);
}

// The 12-row layout: pts [n, 3] the caller's world points, obs [n] the
// observation weights or null (1 for every point).
extern "C" int k1_build_rows12(const float* pts, const float* obs, const float* xs, const long long* tidx,
                               const int* rings, const unsigned char* mask, const long long* key_s,
                               const long long* order, int n, int min_points, float floor, float* packed,
                               void* scratch, int* nvalid, long long* num_raw, int* long_out, long long* long_acc,
                               cudaStream_t stream) {
  return launch_build<true>(nullptr, pts, obs, xs, tidx, rings, mask, key_s, order, n, min_points, floor, packed,
                            scratch, nvalid, num_raw, long_out, long_acc, stream);
}
