// K2: Gauss-Newton normal equations Hext = [J e]^T [J e] over the cell
// residuals of the packed rows.
//
// Replaces the TPU kernel _gn_kernel of dmsa_lidar_slam_tpu/ops/
// fused_residuals.py (gn_system).  Same math: per point the world point,
// d0 = (p - mu0) w, wL d0, the quadratic form and the quaternion VJP,
// contracted with the table Jacobian row of its pose to give u [P]; per cell
// r = sqrt(|q1 - s^T wL s / n|) and J row = sign(val)/r * u_r.  The mean
// term is omitted, as in the TPU kernel.  All in true f32 (the TPU kernel
// rounds the Jacobian gather and the run sums to bf16).
//
// What bounds it on this card: at the window shape (P = 30, M = 57,344)
// the bytes and operations take ~1 us, so what costs is launches, the
// host's enqueue and chains of dependent loads; the cell segmentation
// therefore lives in the kernels, not in torch scans (on an H100 a call
// takes ~0.08 ms of card time and as much host time).  At the 100-keyframe
// submap (P = 594, M = 819,200) the card sets the pace: every member
// contracts its 7-wide cotangent with a 7 x P slice of the [Dtab, 7, P]
// Jacobian read from L1/L2 (members of a cell rarely share a table row),
// then (P+1)^2 FMAs per valid cell.  Cells are runs of the voxel sort and
// unbounded in length.
//
// Design: positions are cut into chunks of kChunk; a piece is one cell's
// members within one chunk, and a warp owns a chunk.
//  (1) gn_pieces: each chunk stages at most two pieces, as (u [P], s, q1)
//      rows: the piece that continues a cell from the previous chunk (slot
//      0) and the piece of a cell that starts here and runs on into the
//      next chunk (slot 1); 32 members with no weight (the masked run's)
//      skip the contraction.  It also flags whether the chunk holds a run
//      start and counts, per block, the valid cell ends.
//  (2) the warp whose chunk holds a valid cell's end row forms the cell's
//      sums: directly for a cell inside the chunk; for a cell that began
//      earlier, by summing the staged pieces back to the cell's first chunk
//      in chunk order (a giant cell spreads its members over many warps).
//      From the sums it forms r and the J row.
//      Small P (P + 1 <= kSmallP1, every main-path call): gn_hext_blocks
//      adds each block's J rows, kSlots per warp and round, into a private
//      [P+1, P+1] Hext in shared memory; gn_sum_splits sums the block
//      partials in block order.  3 launches.
//      Large P: gn_rows writes the J rows densely, at row = valid cell ends
//      before it (block counts from (1) summed by each block in a fixed
//      order; integer sums are exact); gn_jtj is a tiled 64x64 J^T J split
//      over row ranges and gn_sum_splits sums the splits in order.  4
//      launches.
// Every sum runs in an order fixed by the data alone and no float atomics
// are used, so Hext comes out bit-identical from one run to the next.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;      // chunks per block (kChunk positions each, common.cuh)
constexpr int kSlots = 8;      // J rows per warp and round (small P)
constexpr int kSmallP1 = 128;  // P + 1 at most for the shared-memory Hext

__device__ __forceinline__ int count_valid_ends(const float* __restrict__ pk, int m, int c0) {
  const int lane = threadIdx.x & 31;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = c0 + 32 * k + lane;
    cnt += __popc(__ballot_sync(FULL_MASK, j < m && pk[15 * (size_t)m + j] > 0.f));
  }
  return cnt;
}

// Shared floats each warp needs: u [P], then the staged group cotangents
// [8][32] (7 components and the table row).
__host__ __device__ constexpr int warp_floats(int P) { return P + 8 * 32; }

// Sums over the members a..b-1 (at most kChunk) of u_j = cot_j . jt[t_j]
// into u = ws[0:P] (this warp's shared slice; lane p owns u[p], u[p+32],
// ...) and of (d0, d0^T wL d0) into s.
__device__ void piece_sums(const float* __restrict__ tab, const float* __restrict__ jt, int P,
                           const float* __restrict__ pk, int m, int a, int b, float* ws,
                           float4& s) {
  const int lane = threadIdx.x & 31;
  float* u = ws;
  float* cs = ws + P;
  for (int p = lane; p < P; p += 32) u[p] = 0.f;
  float sx = 0.f, sy = 0.f, sz = 0.f, q1 = 0.f;
  for (int c0 = a; c0 < b; c0 += 32) {
    const int j = c0 + lane;
    const int cnt = min(32, b - c0);
    float cot[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int t = -1;
    bool live = false;
    if (lane < cnt) {
      const float xs = pk[j], ys = pk[m + j], zs = pk[2 * m + j];
      float lam[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) lam[c] = pk[(6 + c) * m + j];
      const float w = pk[12 * m + j];
      live = w != 0.f;
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
    // 32 members with no weight (the masked points' run, staged piece by
    // piece in every chunk it spans) add zero: skip their contraction.
    if (!__any_sync(FULL_MASK, live)) continue;
    // Members that share a table row (sorted runs keep the original point
    // order, so a keyframe's points, or a scan's points of one dense
    // sample, sit next to each other) are summed first: a segmented lane
    // scan over equal tidx leaves each group's cotangent sum in its last
    // lane, and only those sums enter the contraction.
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
    // Stage each group's cotangent sum at its tail lane (zeros elsewhere;
    // every lane keeps a table row that the piece uses, so no other row
    // is read), then u[p] += sum over lanes k < cnt, in order, of
    // cs[:, k] . jt[t_k, :, p]: the loads of successive lanes do not wait
    // on each other, so several groups' table rows are in flight at once.
    const bool tail = lane < cnt && (lane == 31 || t_next != t);
    const int t_last = __shfl_sync(FULL_MASK, t, cnt - 1);
#pragma unroll
    for (int c = 0; c < 7; ++c) cs[c * 32 + lane] = tail ? cot[c] : 0.f;
    cs[7 * 32 + lane] = __int_as_float(lane < cnt ? t : t_last);
    __syncwarp();
    for (int p = lane; p < P; p += 32) {
      float acc = u[p];
#pragma unroll 8
      for (int k = 0; k < cnt; ++k) {
        const float* jrow = jt + (size_t)__float_as_int(cs[7 * 32 + k]) * 7 * P + p;
#pragma unroll
        for (int c = 0; c < 7; ++c) acc += cs[c * 32 + k] * __ldg(jrow + c * P);
      }
      u[p] = acc;
    }
    __syncwarp();
  }
  s = make_float4(warp_sum(sx), warp_sum(sy), warp_sum(sz), warp_sum(q1));
  __syncwarp();
}

// Stages the sums of the piece a..b-1 as (row [P], *srow).
__device__ void stage_piece(const float* __restrict__ tab, const float* __restrict__ jt, int P,
                            const float* __restrict__ pk, int m, int a, int b, float* ws,
                            float* __restrict__ row, float4* __restrict__ srow) {
  const int lane = threadIdx.x & 31;
  float4 s;
  piece_sums(tab, jt, P, pk, m, a, b, ws, s);
  for (int p = lane; p < P; p += 32) row[p] = ws[p];
  if (lane == 0) *srow = s;
}

// Sums of a cell that ends in chunk c and began in an earlier chunk: the
// staged tail piece of its first chunk, the whole-chunk pieces between, and
// chunk c's head piece, in chunk order.
__device__ void spanning_sums(int P, int c, const int* __restrict__ has_start,
                              const float* __restrict__ stage_u,
                              const float4* __restrict__ stage_s, float* u, float4& s) {
  const int lane = threadIdx.x & 31;
  const int cs = cell_first_chunk(c, has_start);
  for (int p = lane; p < P; p += 32) {
    float acc = stage_u[(size_t)(2 * cs + 1) * P + p];
    for (int k = cs + 1; k < c; ++k) acc += stage_u[(size_t)(2 * k) * P + p];
    u[p] = acc + stage_u[(size_t)(2 * c) * P + p];
  }
  float4 t = stage_s[2 * cs + 1];
  for (int k = cs + 1; k <= c; ++k) {
    const float4 v = stage_s[2 * k];
    t.x += v.x;
    t.y += v.y;
    t.z += v.z;
    t.w += v.w;
  }
  s = t;
  __syncwarp();
}

// r and sign(val) / r of the valid cell whose end row is e, from its sums.
__device__ __forceinline__ float cell_scale(const float* __restrict__ pk, int m, int e, float4 s,
                                            float& r) {
  const float invn = pk[15 * m + e];
  float lam[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) lam[c] = pk[(6 + c) * m + e];
  float cx, cy, cz;
  sym6_mv(lam, s.x, s.y, s.z, cx, cy, cz);
  const float val = s.w - invn * (cx * s.x + cy * s.y + cz * s.z);
  r = sqrtf(fabsf(val) + 1e-30f);
  return sign_of(val) / r;
}

// Walks the pieces of chunk c from position `cursor` and forms the sums of
// each valid cell whose end row lies in the chunk (u in the warp's slice, s
// returned); calls emit(e, s) for each, at most `budget` times.  Returns
// the new cursor (c1: chunk done).
template <class Emit>
__device__ int chunk_cells(const float* __restrict__ tab, const float* __restrict__ jt, int P,
                           const float* __restrict__ pk, int m, int c, const unsigned (&sm)[4],
                           bool runs_on, const int* __restrict__ has_start,
                           const float* __restrict__ stage_u, const float4* __restrict__ stage_s,
                           float* u, int cursor, int budget, Emit emit) {
  const int c0 = c * kChunk, c1 = min(m, c0 + kChunk);
  while (cursor < c1 && budget > 0) {
    const int a = cursor;
    const int b = next_start(sm, c0, a, c1);
    cursor = b;
    if (b == c1 && runs_on) continue;  // staged: finished by a later chunk
    const int e = b - 1;
    if (!(pk[15 * (size_t)m + e] > 0.f)) continue;  // invalid cell
    float4 s;
    if (a == c0 && !(sm[0] & 1u))
      spanning_sums(P, c, has_start, stage_u, stage_s, u, s);
    else
      piece_sums(tab, jt, P, pk, m, a, b, u, s);
    emit(e, s);
    --budget;
  }
  return cursor;
}

__global__ void __launch_bounds__(32 * kWarps)
    gn_pieces(const float* __restrict__ tab, const float* __restrict__ jt, int P,
              const float* __restrict__ pk, int m, int nchunks, float* __restrict__ stage_u,
              float4* __restrict__ stage_s, int* __restrict__ has_start,
              int* __restrict__ block_cnt) {
  extern __shared__ float smem[];
  __shared__ int s_cnt[kWarps];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + wib;
  float* u = smem + wib * warp_floats(P);  // u [P], then piece_sums' staging
  int cnt = 0;
  if (c < nchunks) {
    const int c0 = c * kChunk, c1 = min(m, c0 + kChunk);
    unsigned sm[4];
    chunk_starts(pk, m, c0, sm);
    cnt = count_valid_ends(pk, m, c0);
    const int last = last_start(sm, c0);
    if (lane == 0) has_start[c] = last >= 0;
    const bool runs_on = c1 < m && !(pk[14 * (size_t)m + c1] > 0.5f);
    if (!(sm[0] & 1u))  // head piece: continues a cell from chunk c - 1
      stage_piece(tab, jt, P, pk, m, c0, next_start(sm, c0, c0, c1), u, stage_u + (size_t)(2 * c) * P,
                  stage_s + 2 * c);
    if (last >= 0 && runs_on)  // tail piece: a cell that starts here runs on
      stage_piece(tab, jt, P, pk, m, last, c1, u, stage_u + (size_t)(2 * c + 1) * P,
                  stage_s + 2 * c + 1);
  }
  if (lane == 0) s_cnt[wib] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += s_cnt[w];
    block_cnt[blockIdx.x] = t;
  }
}

// Small P: each block's cells into a private Hext in shared memory, then
// out to partial[block].  Shared memory: Hext [P1 * P1], J rows
// [kWarps][kSlots][P1], then each warp's u and staging [kWarps][warp_floats(P)].
__global__ void __launch_bounds__(32 * kWarps)
    gn_hext_blocks(const float* __restrict__ tab, const float* __restrict__ jt, int P,
                   const float* __restrict__ pk, int m, int nchunks,
                   const int* __restrict__ has_start, const float* __restrict__ stage_u,
                   const float4* __restrict__ stage_s, float* __restrict__ partial) {
  extern __shared__ float smem[];
  __shared__ int s_rows[kWarps];
  const int P1 = P + 1, nn = P1 * P1;
  float* H = smem;
  float* J = H + nn;
  float* U = J + kWarps * kSlots * P1;
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + wib;
  float* u = U + wib * warp_floats(P);
  float* myJ = J + wib * kSlots * P1;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) H[e] = 0.f;

  const int c0 = c * kChunk, c1 = min(m, c0 + kChunk);
  unsigned sm[4] = {0u, 0u, 0u, 0u};
  bool runs_on = false;
  int cursor = c1;
  if (c < nchunks) {
    chunk_starts(pk, m, c0, sm);
    runs_on = c1 < m && !(pk[14 * (size_t)m + c1] > 0.5f);
    cursor = c0;
  }
  __syncthreads();
  for (;;) {
    int rows = 0;
    cursor = chunk_cells(tab, jt, P, pk, m, c, sm, runs_on, has_start, stage_u, stage_s, u, cursor,
                         kSlots, [&](int e, float4 s) {
                           float r;
                           const float scale = cell_scale(pk, m, e, s, r);
                           float* row = myJ + rows * P1;
                           for (int p = lane; p < P; p += 32) row[p] = scale * u[p];
                           if (lane == 0) row[P] = r;
                           ++rows;
                         });
    if (lane == 0) s_rows[wib] = rows;
    __syncthreads();
    // Hext += the round's rows, in (warp, slot) order for every entry
    for (int e = threadIdx.x; e < nn; e += blockDim.x) {
      const int ra = e / P1, rb = e - ra * P1;
      float acc = H[e];
      for (int w = 0; w < kWarps; ++w) {
        const float* Jw = J + w * kSlots * P1;
        for (int k = 0; k < s_rows[w]; ++k) acc += Jw[k * P1 + ra] * Jw[k * P1 + rb];
      }
      H[e] = acc;
    }
    if (!__syncthreads_or(cursor < c1)) break;
  }
  float* out = partial + (size_t)blockIdx.x * nn;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) out[e] = H[e];
}

// Large P: the J rows of the valid cells, densely at their rank among the
// valid cell ends, r last; the last block writes min(valid cells, rmax).
__global__ void __launch_bounds__(32 * kWarps)
    gn_rows(const float* __restrict__ tab, const float* __restrict__ jt, int P,
            const float* __restrict__ pk, int m, int nchunks, const int* __restrict__ has_start,
            const float* __restrict__ stage_u, const float4* __restrict__ stage_s,
            const int* __restrict__ block_cnt, float* __restrict__ jrows, int rmax,
            int* __restrict__ nrows) {
  extern __shared__ float smem[];
  __shared__ int s_red[32 * kWarps];
  __shared__ int s_cnt[kWarps];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + wib;
  float* u = smem + wib * warp_floats(P);  // u [P], then piece_sums' staging
  int acc = 0;
  for (int i = threadIdx.x; i < (int)blockIdx.x; i += blockDim.x) acc += block_cnt[i];
  s_red[threadIdx.x] = acc;
  const int c0 = c * kChunk, c1 = min(m, c0 + kChunk);
  unsigned sm[4] = {0u, 0u, 0u, 0u};
  int cnt = 0;
  if (c < nchunks) {
    chunk_starts(pk, m, c0, sm);
    cnt = count_valid_ends(pk, m, c0);
  }
  if (lane == 0) s_cnt[wib] = cnt;
  __syncthreads();
  for (int st = 16 * kWarps; st > 0; st >>= 1) {
    if (threadIdx.x < st) s_red[threadIdx.x] += s_red[threadIdx.x + st];
    __syncthreads();
  }
  int row = s_red[0];
  for (int w = 0; w < wib; ++w) row += s_cnt[w];
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    int total = s_red[0];
    for (int w = 0; w < kWarps; ++w) total += s_cnt[w];
    *nrows = min(total, rmax);
  }
  if (c >= nchunks) return;
  const bool runs_on = c1 < m && !(pk[14 * (size_t)m + c1] > 0.5f);
  const int P1 = P + 1;
  chunk_cells(tab, jt, P, pk, m, c, sm, runs_on, has_start, stage_u, stage_s, u, c0, kChunk,
              [&](int e, float4 s) {
                float r;
                const float scale = cell_scale(pk, m, e, s, r);
                if (row < rmax) {  // uniform across the warp
                  float* out = jrows + (size_t)row * P1;
                  for (int p = lane; p < P; p += 32) out[p] = scale * u[p];
                  if (lane == 0) out[P] = r;
                }
                ++row;
              });
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

// hext = sum over z of partial[z], in z order.
__global__ void gn_sum_splits(const float* __restrict__ partial, int splits, int nn,
                              float* __restrict__ hext) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nn) return;
  float s = 0.f;
#pragma unroll 8
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * nn + i];
  hext[i] = s;
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int launch_pieces(const float* tab, const float* jt, int P, const float* pk, int m, float* stage_u,
                  float* stage_s, int* has_start, int* block_cnt, cudaStream_t stream) {
  const int nchunks = (m + kChunk - 1) / kChunk;
  const int blocks = (nchunks + kWarps - 1) / kWarps;
  const size_t smem = (size_t)kWarps * warp_floats(P) * sizeof(float);
  cudaError_t e = set_smem((const void*)gn_pieces, smem);
  if (e != cudaSuccess) return (int)e;
  gn_pieces<<<blocks, 32 * kWarps, smem, stream>>>(tab, jt, P, pk, m, nchunks, stage_u,
                                                   reinterpret_cast<float4*>(stage_s), has_start,
                                                   block_cnt);
  return (int)cudaGetLastError();
}

// Blocks of the chunk kernels for m positions (block_cnt and, for small P,
// the Hext partials have one entry each).
int num_blocks(int m) { return ((m + kChunk - 1) / kChunk + kWarps - 1) / kWarps; }

}  // namespace

// Positions per chunk of K2 and K3 (fused_residuals.CHUNK states the same
// cut in plain torch).
extern "C" int dmsa_chunk_positions() { return kChunk; }

// The chunk scratch of k2_gn_small and k2_gn_large for m positions and P
// parameters, in bytes: stage_u [2 nchunks, P] f32, stage_s [2 nchunks, 4]
// f32, has_start [nchunks] and block_cnt [blocks] int32; and, for
// k2_gn_small only, partial [blocks, P+1, P+1] f32.
extern "C" int k2_scratch_bytes(int m, int P, long long* nbytes) {
  const int nchunks = (m + kChunk - 1) / kChunk, blocks = num_blocks(m);
  nbytes[0] = (long long)2 * nchunks * P * sizeof(float);
  nbytes[1] = (long long)2 * nchunks * 4 * sizeof(float);
  nbytes[2] = (long long)nchunks * sizeof(int);
  nbytes[3] = (long long)blocks * sizeof(int);
  nbytes[4] = (long long)blocks * (P + 1) * (P + 1) * sizeof(float);
  return 0;
}

// Scratch as k2_scratch_bytes gives it; hext [P+1, P+1].
extern "C" int k2_gn_small(const float* tab, const float* jt, int P, const float* pk, int m,
                           float* stage_u, float* stage_s, int* has_start, int* block_cnt,
                           float* partial, float* hext, cudaStream_t stream) {
  const int P1 = P + 1;
  if (P1 > kSmallP1) return (int)cudaErrorInvalidValue;
  const int blocks = num_blocks(m);
  const int nn = P1 * P1;
  if (blocks > 0) {
    int err = launch_pieces(tab, jt, P, pk, m, stage_u, stage_s, has_start, block_cnt, stream);
    if (err) return err;
    const size_t smem = (size_t)(nn + kWarps * kSlots * P1 + kWarps * warp_floats(P)) * sizeof(float);
    cudaError_t e = set_smem((const void*)gn_hext_blocks, smem);
    if (e != cudaSuccess) return (int)e;
    gn_hext_blocks<<<blocks, 32 * kWarps, smem, stream>>>(
        tab, jt, P, pk, m, (m + kChunk - 1) / kChunk, has_start, stage_u,
        reinterpret_cast<const float4*>(stage_s), partial);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  gn_sum_splits<<<(nn + 255) / 256, 256, 0, stream>>>(partial, blocks, nn, hext);
  return (int)cudaGetLastError();
}

// Large P: as k2_gn_small, with jrows [rmax, P+1], nrows [1] and partial
// [splits, P+1, P+1].
extern "C" int k2_gn_large(const float* tab, const float* jt, int P, const float* pk, int m,
                           float* stage_u, float* stage_s, int* has_start, int* block_cnt,
                           float* jrows, int rmax, int* nrows, int splits, float* partial,
                           float* hext, cudaStream_t stream) {
  const int P1 = P + 1;
  const int blocks = num_blocks(m);
  if (blocks > 0) {
    int err = launch_pieces(tab, jt, P, pk, m, stage_u, stage_s, has_start, block_cnt, stream);
    if (err) return err;
    const size_t smem = (size_t)kWarps * warp_floats(P) * sizeof(float);
    cudaError_t e = set_smem((const void*)gn_rows, smem);
    if (e != cudaSuccess) return (int)e;
    gn_rows<<<blocks, 32 * kWarps, smem, stream>>>(
        tab, jt, P, pk, m, (m + kChunk - 1) / kChunk, has_start, stage_u,
        reinterpret_cast<const float4*>(stage_s), block_cnt, jrows, rmax, nrows);
    err = (int)cudaGetLastError();
    if (err) return err;
  } else {
    cudaError_t e = cudaMemsetAsync(nrows, 0, sizeof(int), stream);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (P1 + kTile - 1) / kTile;
  gn_jtj<<<dim3(tiles, tiles, splits), 256, 0, stream>>>(jrows, nrows, P1, partial);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int nn = P1 * P1;
  gn_sum_splits<<<(nn + 255) / 256, 256, 0, stream>>>(partial, splits, nn, hext);
  return (int)cudaGetLastError();
}
