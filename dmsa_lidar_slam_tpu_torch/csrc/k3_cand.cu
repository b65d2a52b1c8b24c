// K3: line-search candidate errors, err[k] = sum over valid cells of
// |q1 - s^T wL s / n| for K candidate pose tables, with membership and
// Lambda frozen in the packed rows.
//
// Replaces the TPU kernel _cand_kernel of dmsa_lidar_slam_tpu/ops/
// fused_residuals.py (cand_errors).  True f32 throughout (the TPU kernel
// splits into bf16 hi/lo limbs to reach f32-class sums on the MXU).
//
// What bounds it here: per member and candidate one 32-byte table-row read
// (the K tables of the window problem, 15 x 502 x 32 B = 241 KB, stay in
// L1/L2) and ~50 operations; the packed rows are read once for all K.  At
// the window shape (M = 57,344) that is well under 10 us of issue time, so
// what costs is latency and balance: cells are runs of the voxel sort,
// unbounded in length, and the masked points form one run with no weight
// that holds 5-20% of the positions.
//
// Design: the chunk cut of K2 (common.cuh): a warp owns kChunk sorted
// positions, whatever runs they hold.
//  (1) cand_pieces stages the chunk's rows in shared memory (one coalesced
//      load round), flags 32-member groups with any weight (a ballot on the
//      w row), and walks the chunk's pieces.  Within a piece, lane k + 16 h
//      takes candidate k and every other member (h = 0: even, 1: odd
//      offsets), so no lane reduces anything but its own sums; a group with
//      no weight is skipped, and lanes past the K candidates idle.  The two halves are added with one shuffle per
//      component at the piece's end.  A cell inside the chunk is finished
//      there (|val| per candidate, skipped if the cell is invalid); the head
//      piece and the tail piece are staged as (s, q1) per candidate.
//  (2) cand_spans: the warp whose chunk holds the end row of a valid cell
//      that began in an earlier chunk sums its staged pieces in chunk order
//      (the cell's first chunk found by a ballot over chunk flags).
//  (3) cand_final sums the block partials of (1) and (2) in block order.
// Warps in a block add their candidate sums in warp order through shared
// memory; no float atomics, so err comes out bit-identical from one call to
// the next (the line search takes an argmin over it).
#include "common.cuh"

namespace {

constexpr int kMaxK = 16;
constexpr int kWarps = 4;  // chunks per cand_pieces block
constexpr int kSpanWarps = 8;  // chunks per cand_spans block

// A member's packed rows in shared memory: (x, y, z, w), (mu0, tidx),
// lamw6[0:4], (lamw6[4:6], 1/n, unused).
struct Member {
  float4 a, b, c, d;
};

__device__ __forceinline__ float cell_val(const float* lam, float invn, float4 s) {
  float cx, cy, cz;
  sym6_mv(lam, s.x, s.y, s.z, cx, cy, cz);
  return s.w - invn * (cx * s.x + cy * s.y + cz * s.z);
}

// Sums (s, q1) over the members lo..hi-1 (chunk offsets) of one cell for
// candidate k = lane & 15: lane k + 16 h takes offsets lo + h, lo + h + 2,
// ...; groups of 32 with no weight (bit clear in `live`) are skipped, and
// the lanes of candidates k >= K sum nothing.  Lanes 0-15 return the
// piece's sums for their candidate.
__device__ float4 piece_sums(const Member* __restrict__ rows, unsigned live,
                             const float* __restrict__ tab, int K, int lo, int hi) {
  const int h = (threadIdx.x >> 4) & 1;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if ((threadIdx.x & 15) < K) {
    for (int g = lo >> 5; g <= (hi - 1) >> 5; ++g) {
      if (!((live >> g) & 1u)) continue;
      const int e = min(hi, 32 * g + 32);
#pragma unroll 2
      for (int i = max(lo, 32 * g) + h; i < e; i += 2) {
        const Member r = rows[i];
        const float lam[6] = {r.c.x, r.c.y, r.c.z, r.c.w, r.d.x, r.d.y};
        const Pose ps = load_pose(tab, __float_as_int(r.b.w));
        float px, py, pz;
        transform(ps, r.a.x, r.a.y, r.a.z, px, py, pz);
        const float dx = (px - r.b.x) * r.a.w, dy = (py - r.b.y) * r.a.w, dz = (pz - r.b.z) * r.a.w;
        float lx, ly, lz;
        sym6_mv(lam, dx, dy, dz, lx, ly, lz);
        s.x += dx;
        s.y += dy;
        s.z += dz;
        s.w += lx * dx + ly * dy + lz * dz;
      }
    }
  }
  s.x += __shfl_down_sync(FULL_MASK, s.x, 16);
  s.y += __shfl_down_sync(FULL_MASK, s.y, 16);
  s.z += __shfl_down_sync(FULL_MASK, s.z, 16);
  s.w += __shfl_down_sync(FULL_MASK, s.w, 16);
  return s;
}

// Block partial: lane k of each warp holds candidate k's sum; the block
// adds them in warp order.
template <int W>
__device__ __forceinline__ void block_partial(float acc, int K, float (*swarp)[kMaxK],
                                              float* __restrict__ out) {
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane < kMaxK) swarp[wib][lane] = acc;
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.f;
    for (int w = 0; w < W; ++w) s += swarp[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(32 * kWarps)
    cand_pieces(const float* __restrict__ tabs, int K, int dtab, const float* __restrict__ pk,
                int m, int nchunks, float4* __restrict__ stage, int* __restrict__ has_start,
                int* __restrict__ span_end, float* __restrict__ partial) {
  __shared__ Member srows[kWarps][kChunk];
  __shared__ float swarp[kWarps][kMaxK];
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + wib;
  const int k = lane & 15;
  const float* tab = tabs + (size_t)min(k, K - 1) * dtab * 8;
  Member* rows = srows[wib];
  float acc = 0.f;
  if (c < nchunks) {
    const int c0 = c * kChunk, c1 = min(m, c0 + kChunk), n = c1 - c0;
    unsigned sm[4], live = 0u;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int i = 32 * g + lane, j = c0 + i;
      float v[16];
      if (i < n) {
#pragma unroll
        for (int r = 0; r < 16; ++r) v[r] = pk[(size_t)r * m + j];
      } else {
#pragma unroll
        for (int r = 0; r < 16; ++r) v[r] = 0.f;
      }
      sm[g] = __ballot_sync(FULL_MASK, v[14] > 0.5f);
      live |= (__ballot_sync(FULL_MASK, v[12] != 0.f) ? 1u : 0u) << g;
      rows[i] = Member{make_float4(v[0], v[1], v[2], v[12]),
                       make_float4(v[3], v[4], v[5], __int_as_float((int)v[13])),
                       make_float4(v[6], v[7], v[8], v[9]), make_float4(v[10], v[11], v[15], 0.f)};
    }
    __syncwarp();
    const int last = last_start(sm, c0);
    const bool runs_on = c1 < m && !(pk[14 * (size_t)m + c1] > 0.5f);
    int head_end = -1;
    for (int a = c0; a < c1;) {
      const int b = next_start(sm, c0, a, c1);
      const Member& er = rows[b - 1 - c0];
      const bool valid_end = er.d.z > 0.f;
      const bool head = a == c0 && !(sm[0] & 1u);
      const bool tail = b == c1 && runs_on;
      if (head || tail) {
        // staged: the head piece (slot 0; a whole chunk inside a cell, too)
        // and the tail piece (slot 1); a head piece that ends an invalid
        // cell here is never read
        if (tail || valid_end) {
          const float4 s = piece_sums(rows, live, tab, K, a - c0, b - c0);
          if (lane < kMaxK) stage[(size_t)(2 * c + (head ? 0 : 1)) * kMaxK + lane] = s;
        }
        if (head && !tail && valid_end) head_end = b - 1;
      } else if (valid_end) {  // a cell inside the chunk
        const float4 s = piece_sums(rows, live, tab, K, a - c0, b - c0);
        const float lam[6] = {er.c.x, er.c.y, er.c.z, er.c.w, er.d.x, er.d.y};
        acc += fabsf(cell_val(lam, er.d.z, s));
      }
      a = b;
    }
    if (lane == 0) {
      has_start[c] = last >= 0;
      span_end[c] = head_end;
    }
  }
  block_partial<kWarps>(acc, K, swarp, partial + (size_t)blockIdx.x * K);
}

// The cells that end in chunk c and began in an earlier chunk: the staged
// tail piece of the first chunk, the whole-chunk pieces between and chunk
// c's head piece, in chunk order.
__global__ void __launch_bounds__(32 * kSpanWarps)
    cand_spans(int K, const float* __restrict__ pk, int m, int nchunks,
               const float4* __restrict__ stage, const int* __restrict__ has_start,
               const int* __restrict__ span_end, float* __restrict__ partial) {
  __shared__ float swarp[kSpanWarps][kMaxK];
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kSpanWarps + wib;
  const int k = lane & 15;
  float acc = 0.f;
  const int e = c < nchunks ? span_end[c] : -1;
  if (e >= 0) {  // uniform across the warp
    const int cs = cell_first_chunk(c, has_start);
    float4 s = stage[(size_t)(2 * cs + 1) * kMaxK + k];
    for (int q = cs + 1; q <= c; ++q) {
      const float4 v = stage[(size_t)(2 * q) * kMaxK + k];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    float lam[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) lam[r] = pk[(size_t)(6 + r) * m + e];
    acc = fabsf(cell_val(lam, pk[15 * (size_t)m + e], s));
  }
  block_partial<kSpanWarps>(acc, K, swarp, partial + (size_t)blockIdx.x * K);
}

// out[k] = sum over rows of partial[r, k]: warp k, lanes stride the rows,
// fixed butterfly.
__global__ void cand_final(const float* __restrict__ partial, int nrows, int K,
                           float* __restrict__ out) {
  const int k = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (k >= K) return;
  float s = 0.f;
  for (int b = lane; b < nrows; b += 32) s += partial[(size_t)b * K + k];
  s = warp_sum(s);
  if (lane == 0) out[k] = s;
}

// Blocks of the pieces and the spans kernels for nchunks chunks.
int pieces_blocks(int nchunks) { return max(1, (nchunks + kWarps - 1) / kWarps); }
int span_blocks(int nchunks) { return max(1, (nchunks + kSpanWarps - 1) / kSpanWarps); }

}  // namespace

// The scratch of k3_cand_errors for m positions and K candidates, in bytes:
// stage [2 nchunks, 16, 4] f32, has_start [nchunks] and span_end [nchunks]
// int32, partial [pieces blocks + spans blocks, K] f32.
extern "C" int k3_scratch_bytes(int m, int K, long long* nbytes) {
  const int nchunks = (m + kChunk - 1) / kChunk;
  nbytes[0] = (long long)2 * nchunks * kMaxK * sizeof(float4);
  nbytes[1] = nbytes[2] = (long long)nchunks * sizeof(int);
  nbytes[3] = (long long)(pieces_blocks(nchunks) + span_blocks(nchunks)) * K * sizeof(float);
  return 0;
}

// Scratch as k3_scratch_bytes gives it.
extern "C" int k3_cand_errors(const float* tabs, int K, int dtab, const float* packed, int m,
                              float* stage, int* has_start, int* span_end, float* partial,
                              float* out, cudaStream_t stream) {
  if (K > kMaxK || K < 1) return (int)cudaErrorInvalidValue;
  const int nchunks = (m + kChunk - 1) / kChunk;
  const int blocks = pieces_blocks(nchunks);
  const int spans = span_blocks(nchunks);
  cand_pieces<<<blocks, 32 * kWarps, 0, stream>>>(tabs, K, dtab, packed, m, nchunks,
                                                  reinterpret_cast<float4*>(stage), has_start,
                                                  span_end, partial);
  int err = (int)cudaGetLastError();
  if (err) return err;
  cand_spans<<<spans, 32 * kSpanWarps, 0, stream>>>(
      K, packed, m, nchunks, reinterpret_cast<const float4*>(stage), has_start, span_end,
      partial + (size_t)blocks * K);
  err = (int)cudaGetLastError();
  if (err) return err;
  cand_final<<<1, 32 * K, 0, stream>>>(partial, blocks + spans, K, out);
  return (int)cudaGetLastError();
}
