"""The DMSA Gauss-Newton kernels K1-K3 and their plain PyTorch versions
(counterpart of dmsa_lidar_slam_tpu/ops/fused_residuals.py).

Both DMSA problems share one structure: world point j =
quat_rotate(q[tidx_j], x_j) + t[tidx_j] with (q, t) rows of a small pose
table (the window's dense trajectory table or one row per keyframe; static
points ride on a trailing identity row).

  K1 build_packed  voxel-key kernel -> torch.sort of the int64 keys -> cell
                   build kernel + normalisation kernel -> packed [16, N];
                   the compact layout (world points from the pose table)
                   or the 12-row one (the caller's world points and
                   per-point observation weights)
  K2 gn_system     Hext = [J e]^T [J e] over the cell residuals, [P+1, P+1]:
                   chunk pieces staged, cells summed, Hext reduced, all in
                   3-4 kernel launches
  K3 cand_errors   line-search errors of K candidate tables, [K]: chunk
                   pieces as K2's, cells finished in fixed order, 3
                   kernel launches

Packed per-point layout [16, M] (the reference's, kept so the tests compare
like with like):
    rows 0-2 x (local point), 3-5 mu0 (cell mean at build time),
    6-11 lamw6 (weight * Lambda, packed 00,01,02,11,12,22), 12 w (validity),
    13 table index, 14 run-start flag, 15 1/count at valid run-end rows.

Each public function runs its CUDA kernels (csrc/) for CUDA tensors and its
plain version (the *_ref twin) for CPU tensors; there is no fallback from
one to the other.  On the card the wrappers enqueue no torch work besides
allocations, the one sort of K1 and the operand copies of prep_tables /
prep_jac_tables, and never wait for the card.
"""

import numpy as np
import torch

from dmsa_lidar_slam_tpu_torch.core.rotations import quat_rotate, quat_rotate_vjp_q
from dmsa_lidar_slam_tpu_torch.ops import cuda_lib, gaussians
from dmsa_lidar_slam_tpu_torch.ops.eig3 import sym6_matvec
from dmsa_lidar_slam_tpu_torch.ops.gaussians import COV_EIG_FLOOR

PACK_ROWS = 16
_F32 = torch.float32


def pack_rows(cells: gaussians.CellSet, xs_sorted, tidx_sorted):
    """[16, M] packed per-point input from a CellSet plus the sorted local
    points / table indices."""
    m = cells.order.shape[0]
    i = torch.arange(m, device=cells.order.device)
    newc = (cells.start == i).to(_F32)
    is_end = cells.end == i + 1
    valid_mem = cells.valid_mem if cells.valid_mem is not None else cells.valid[cells.start]
    invn_end = torch.where(
        is_end & valid_mem, 1.0 / torch.clamp(cells.count, min=1.0), torch.zeros_like(cells.count)
    ).to(_F32)
    return torch.cat(
        [
            xs_sorted.T.to(_F32),
            cells.mu0.T.to(_F32),
            cells.lamw6.T.to(_F32),
            cells.w_sorted[None, :].to(_F32),
            tidx_sorted[None, :].to(_F32),
            newc[None, :],
            invn_end[None, :],
        ],
        dim=0,
    )


def prep_tables(tabs):
    """Candidate tables [K, Dtab, 8] (quat wxyz, transl xyz, pad) as the
    contiguous f32 kernel operand."""
    return tabs.to(_F32).contiguous()


def prep_jac_tables(dtabs):
    """Table Jacobian [P, Dtab, 8] -> [Dtab, 7, P] f32: for a point's table
    row, the 7 x P block is contiguous along P (coalesced in K2)."""
    return dtabs[:, :, :7].to(_F32).permute(1, 2, 0).contiguous()


def _world_points(tab, xs, tidx):
    q = tab[:, 0:4][tidx].to(_F32)
    t3 = tab[:, 4:7][tidx].to(_F32)
    return quat_rotate(q, xs.to(_F32)) + t3


def _scratch(device, *nbytes):
    """One allocation for several scratch arrays of a kernel call.  Returns
    the buffer (keep it alive across the launch) and a 256-byte-aligned
    pointer to each array."""
    offs, total = [], 0
    for b in nbytes:
        offs.append(total)
        total += -(-int(b) // 256) * 256
    buf = torch.empty(max(total, 256), dtype=torch.uint8, device=device)
    return buf, [buf.data_ptr() + o for o in offs]


# --------------------------------------------------------------------------
# K1: cell build
# --------------------------------------------------------------------------

K1_BLOCK_POSITIONS = 256  # sorted positions per build_fwd block (csrc/k1_build.cu)


def _grid_operand(grid_size, device):
    """The grid as k1_voxel_keys takes it: (g_host, grid pointer or None).

    voxel.voxel_coords divides by the grid; PyTorch's CUDA division by a
    host scalar multiplies by the scalar's f32 reciprocal (computed on the
    host), while a device tensor divides, rounded once.  The key kernel does
    what PyTorch does for the same argument, so points on a voxel boundary
    land in the same cell as in the plain version.  A grid on the card is
    an f32 scalar, as the optimizer passes it."""
    if isinstance(grid_size, torch.Tensor):
        if grid_size.numel() != 1:
            raise ValueError(f"grid_size: one value expected, got shape {tuple(grid_size.shape)}")
        if grid_size.is_cuda:
            if grid_size.dtype != _F32 or grid_size.device != device:
                raise ValueError(f"grid_size: f32 on {device} expected, got {grid_size.dtype} on {grid_size.device}")
            return 0.0, cuda_lib.ptr(grid_size)
        grid_size = grid_size.item()
    return float(np.float32(1.0) / np.float32(grid_size)), None


def _k1_keys(points_w, mask, grid_size, split_ids, lib, stream):
    """K1's key kernel: the int64 sort key of every point, bit for bit
    voxel.combined_key(*voxel.voxel_keys(points_w, mask, grid_size,
    channel=split_ids)) as PyTorch computes it on the card."""
    dev = points_w.device
    n = points_w.shape[0]
    cuda_lib.require(points_w, "points_w", _F32, (n, 3), dev)
    cuda_lib.require(mask, "mask", torch.bool, (n,), dev)
    if split_ids is not None:
        cuda_lib.require(split_ids, "split_ids", torch.int32, (n,), dev)
    g_host, grid_ptr = _grid_operand(grid_size, dev)
    key = torch.empty(n, dtype=torch.int64, device=dev)
    P = cuda_lib.ptr
    cuda_lib.check(
        lib.k1_voxel_keys(P(points_w), P(mask), None if split_ids is None else P(split_ids), n, g_host,
                          grid_ptr, P(key), stream),
        "k1_voxel_keys",
    )
    return key


def build_packed(points_w, mask, ring_ids, xs, tidx, grid_size, min_points: int, tab=None, split_ids=None,
                 obs_weight=None):
    """One-resolution cell build straight to the packed kernel input.

    points_w [N, 3] supply the voxel keys.  Two layouts, as the reference's
    build kernel has (its _build_decode):
      - compact, when `tab` [Dtab, 8] is given and obs_weight is None: the
        cell statistics use the world points recomputed from (tab, xs,
        tidx) in f32, exactly as K2/K3 recompute them, and obs = w;
      - 12-row, otherwise: the statistics use points_w as given (even with
        `tab`), and each member's obs is obs_weight * w (None: w), whose
        per-cell mean feeds the rebalancing weight.
    Returns (packed [16, N], num_valid, num_raw), the counts as device
    scalars (int32, int64).

    On the card: the key kernel, one stable torch.sort of the keys, then the
    build kernel gathers through the sort order itself and a second kernel
    normalises the weights (csrc/k1_build.cu; the 12-row layout is the build
    kernel's second instantiation, counted in BRANCHES["build_rows12"]).
    """
    if not points_w.is_cuda:
        return build_packed_ref(points_w, mask, ring_ids, xs, tidx, grid_size, min_points, tab, split_ids,
                                obs_weight)
    dev = points_w.device
    n = points_w.shape[0]
    rows12 = tab is None or obs_weight is not None
    if obs_weight is not None:
        cuda_lib.require(obs_weight, "obs_weight", _F32, (n,), dev)
    if not rows12:
        tabc = prep_tables(tab)
        cuda_lib.require(tabc, "tab", _F32, device=dev)
    cuda_lib.require(xs, "xs", _F32, (n, 3), dev)
    cuda_lib.require(tidx, "tidx", torch.int64, (n,), dev)
    cuda_lib.require(ring_ids, "ring_ids", torch.int32, (n,), dev)
    lib = cuda_lib.library()
    stream = cuda_lib.stream_ptr(dev)
    cuda_lib.LAUNCHES["build_packed"] += 1
    key = _k1_keys(points_w, mask, grid_size, split_ids, lib, stream)
    key_s, order = torch.sort(key, stable=True)
    packed = torch.empty((PACK_ROWS, n), dtype=_F32, device=dev)
    # int64 words: num_raw, nvalid (int32), then 16 bytes per build block
    aux = torch.empty(2 + 2 * (-(-n // K1_BLOCK_POSITIONS)), dtype=torch.int64, device=dev)
    P = cuda_lib.ptr
    tail = (P(xs), P(tidx), P(ring_ids), P(mask), P(key_s), P(order), n, int(min_points), float(COV_EIG_FLOOR),
            P(packed), aux.data_ptr() + 16, aux.data_ptr() + 8, P(aux), stream)
    if rows12:
        cuda_lib.BRANCHES["build_rows12"] += 1
        obs = None if obs_weight is None else P(obs_weight)
        cuda_lib.check(lib.k1_build_rows12(P(points_w), obs, *tail), "k1_build_rows12")
    else:
        cuda_lib.check(lib.k1_build(P(tabc), *tail), "k1_build")
    return packed, aux.view(torch.int32)[2], aux[0]


def build_packed_ref(points_w, mask, ring_ids, xs, tidx, grid_size, min_points: int, tab=None, split_ids=None,
                     obs_weight=None):
    """Plain version of build_packed: gaussians.build_cells + pack_rows.
    In the compact layout (`tab` given, obs_weight None) the statistics use
    the table-recomputed world points; otherwise points_w directly, with
    the observation weights."""
    compact = tab is not None and obs_weight is None
    pts = _world_points(tab, xs, tidx) * mask[:, None].to(_F32) if compact else points_w
    aux = torch.cat([xs.to(_F32), tidx.to(_F32)[:, None]], dim=1)
    cells, aux_s = gaussians.build_cells(
        pts, mask, ring_ids, grid_size, min_points, split_ids=split_ids, aux=aux, key_points=points_w,
        obs_weight=obs_weight,
    )
    packed = pack_rows(cells, aux_s[:, :3], aux_s[:, 3])
    return packed, cells.num_valid.to(torch.int32), cells.num_raw


# --------------------------------------------------------------------------
# K2: Gauss-Newton normal equations
# --------------------------------------------------------------------------


def _unpack(packed):
    xs = packed[0:3].T
    mu0 = packed[3:6].T
    lam6 = packed[6:12].T
    w = packed[12]
    tidx = packed[13].to(torch.int64)
    newc = packed[14]
    invn_end = packed[15]
    return xs, mu0, lam6, w, tidx, newc, invn_end


# Positions per chunk (one warp) of K2 and K3, as the library's
# dmsa_chunk_positions(); a piece is a cell's members in one chunk.  Only
# the plain statements of the cut use it: the wrappers take their scratch
# sizes from the library.
CHUNK = 128
K2_SMALL_P1 = 128  # P + 1 at most for the block-private Hext in shared memory


def gn_system(tab, dtabs, packed, max_cells=None):
    """One-pass Gauss-Newton normal equations over the cell residuals.

    tab [Dtab, 8] current pose table, dtabs [P, Dtab, 8] its parameter
    Jacobian, packed [16, M].  Returns Hext [P+1, P+1] f32 with
    Hext[:P, :P] = J^T J, Hext[:P, P] = J^T e, Hext[P, P] = e^T e, omitting
    the mean term like the reference's kernel.  max_cells bounds the number
    of valid cells (M // min_points_per_cell); for P + 1 > K2_SMALL_P1 it
    sizes the dense J rows.

    On the card the kernels find the cells and their chunk pieces from the
    packed rows themselves (csrc/k2_gn.cu; gn_system_pieces_ref states the
    cut in plain torch): 3 launches for P + 1 <= K2_SMALL_P1, 4 above.
    """
    if not packed.is_cuda:
        return gn_system_ref(tab, dtabs, packed, include_mean_term=False)
    dev = packed.device
    p_dim = dtabs.shape[0]
    m = packed.shape[1]
    tabc = prep_tables(tab)
    jt = prep_jac_tables(dtabs)
    pk = packed.contiguous()
    cuda_lib.require(tabc, "tab", _F32, device=dev)
    cuda_lib.require(jt, "jt", _F32, (tab.shape[0], 7, p_dim), dev)
    cuda_lib.require(pk, "packed", _F32, (PACK_ROWS, m), dev)
    p1 = p_dim + 1
    # stage_u, stage_s, has_start, block_cnt; the small path's partial
    *stage, small_partial = cuda_lib.scratch_bytes("k2_scratch_bytes", 5, m, p_dim)
    hext = torch.empty((p1, p1), dtype=_F32, device=dev)
    lib = cuda_lib.library()
    stream = cuda_lib.stream_ptr(dev)
    P = cuda_lib.ptr
    cuda_lib.LAUNCHES["gn_system"] += 1
    if p1 <= K2_SMALL_P1:
        buf, ptrs = _scratch(dev, *stage, small_partial)
        cuda_lib.check(lib.k2_gn_small(P(tabc), P(jt), p_dim, P(pk), m, *ptrs, P(hext), stream), "k2_gn_small")
        return hext
    cuda_lib.BRANCHES["gn_system_dense_j"] += 1
    rmax = m if max_cells is None else max(1, min(m, int(max_cells)))
    tiles = -(-p1 // 64)
    splits = max(1, min(-(-264 // (tiles * tiles)), -(-rmax // 256)))
    buf, (su, ss, hs, bc, jrows, nrows, partial) = _scratch(
        dev, *stage, 4 * rmax * p1, 4, 4 * splits * p1 * p1
    )
    cuda_lib.check(
        lib.k2_gn_large(P(tabc), P(jt), p_dim, P(pk), m, su, ss, hs, bc, jrows, rmax, nrows, splits,
                        partial, P(hext), stream),
        "k2_gn_large",
    )
    return hext


def _chunk_pieces(run_start, chunk):
    """The chunk/piece cut shared by K2 and K3 (common.cuh): positions cut
    into chunks of `chunk`, a piece one run's members within one chunk.

    Returns (run [M], piece [M]: ids per position; first, last [pieces]:
    each piece's first and last position; head [pieces]: the piece
    continues a run from the previous chunk; ends_run [pieces]: the run
    ends at the piece's last position; staged [n_chunks]: the pieces each
    chunk hands on, its head piece and the tail piece of a run that starts
    in it and goes on into the next)."""
    m = run_start.shape[0]
    pos = torch.arange(m, device=run_start.device)
    run = torch.cumsum(run_start.to(torch.int64), 0) - 1
    cut = run_start | (pos % chunk == 0)
    piece = torch.cumsum(cut.to(torch.int64), 0) - 1
    first = torch.nonzero(cut).flatten()
    last = torch.cat([first[1:], first.new_full((1,), m)]) - 1
    cont = torch.zeros_like(run_start)  # the next position is in the same run
    cont[:-1] = ~run_start[1:]
    head = ~run_start[first] & (first % chunk == 0)
    tail = run_start[first] & cont[last] & ((last + 1) % chunk == 0)
    staged = torch.zeros(-(-m // chunk), dtype=torch.int64, device=run_start.device)
    staged.index_add_(0, first // chunk, (head | tail).to(torch.int64))
    return run, piece, first, last, head, ~cont[last], staged


def gn_system_pieces_ref(tab, dtabs, packed, chunk=CHUNK):
    """Plain statement of K2's chunk/piece cut (csrc/k2_gn.cu).

    Positions are cut into chunks of `chunk`; a piece is one cell's members
    within one chunk.  Every piece is summed on its own (u = sum of
    cot_j . jt[t_j], s = sum of d0, q1 = sum of d0^T wL d0), a cell's sums
    are its pieces' sums in chunk order, and Hext follows from the valid
    cells' sums as in gn_system (no mean term).  A chunk hands on at most
    two pieces: the one that continues a cell from the previous chunk and
    the one of a cell that starts in it and runs on into the next.

    Returns (Hext [P+1, P+1], staged [n_chunks]: the pieces each chunk
    hands on).  Memory O(M x P): for tests at small sizes."""
    m = packed.shape[1]
    p_dim = dtabs.shape[0]
    dev = packed.device
    xs, mu0, lam6, w, tidx, newc, invn_end = _unpack(packed)
    run, piece, first, _, _, _, staged = _chunk_pieces(newc > 0.5, chunk)
    piece_run = run[first]

    tabf = tab.to(_F32)
    q = tabf[tidx, 0:4]
    d0 = (quat_rotate(q, xs) + tabf[tidx, 4:7] - mu0) * w[:, None]
    wld0 = sym6_matvec(lam6, d0)
    cot = torch.cat([quat_rotate_vjp_q(q, xs, wld0), wld0], dim=1)
    u = torch.einsum("mc,mcp->mp", cot, prep_jac_tables(dtabs)[tidx])
    terms = torch.cat([u, d0, torch.sum(wld0 * d0, dim=1, keepdim=True)], dim=1)
    pieces = torch.zeros(first.shape[0], p_dim + 4, dtype=_F32, device=dev).index_add_(0, piece, terms)
    n_runs = int(run[-1]) + 1 if m else 0
    cells = torch.zeros(n_runs, p_dim + 4, dtype=_F32, device=dev).index_add_(0, piece_run, pieces)

    vend = invn_end > 0
    ends = torch.nonzero(vend).flatten()
    sums = cells[run[ends]]
    sv, lam_e = sums[:, p_dim:p_dim + 3], lam6[ends]
    val = sums[:, p_dim + 3] - invn_end[ends] * torch.sum(sym6_matvec(lam_e, sv) * sv, dim=1)
    r = torch.sqrt(torch.abs(val) + 1e-30)
    jext = torch.cat([(torch.sign(val) / r)[:, None] * sums[:, :p_dim], r[:, None]], dim=1)
    return jext.T @ jext, staged


def gn_system_ref(tab, dtabs, packed, include_mean_term=True, chunk=8192):
    """Plain version of gn_system.  The per-point [chunk, 7, P] Jacobian
    gather runs over chunks of points, and the run sums go straight to the
    valid cells, so memory stays O(cells x P), not O(M x P).

    include_mean_term keeps the (wL s_bar)^T B_r row correction that the
    kernel omits (zero in exact arithmetic at the linearization point)."""
    m = packed.shape[1]
    p_dim = dtabs.shape[0]
    dev = packed.device
    xs, mu0, lam6, w, tidx, newc, invn_end = _unpack(packed)
    seg = torch.cumsum(newc.to(torch.int64), 0) - 1  # run id per position
    vend = invn_end > 0
    n_runs = int(seg[-1].item()) + 1 if m else 0
    run_valid = torch.zeros(n_runs, dtype=torch.bool, device=dev)
    run_valid[seg[vend]] = True
    vrow = torch.cumsum(run_valid.to(torch.int64), 0) - 1
    nv = int(run_valid.sum().item())
    jt = prep_jac_tables(dtabs)  # [Dtab, 7, P]
    tabf = tab.to(_F32)

    s3 = torch.zeros(n_runs, 3, dtype=_F32, device=dev)
    q1 = torch.zeros(n_runs, dtype=_F32, device=dev)
    ur = torch.zeros(nv, p_dim, dtype=_F32, device=dev)
    br = [torch.zeros(nv, p_dim, dtype=_F32, device=dev) for _ in range(3)] if include_mean_term else None
    for a in range(0, m, chunk):
        b = min(m, a + chunk)
        ti = tidx[a:b]
        q = tabf[ti, 0:4]
        x = xs[a:b]
        p = quat_rotate(q, x) + tabf[ti, 4:7]
        d0 = (p - mu0[a:b]) * w[a:b, None]
        wld0 = sym6_matvec(lam6[a:b], d0)
        quad = torch.sum(wld0 * d0, dim=1)
        sg = seg[a:b]
        s3.index_add_(0, sg, d0)
        q1.index_add_(0, sg, quad)
        rv = run_valid[sg]
        if not bool(rv.any()):
            continue
        rows = vrow[sg][rv]
        mt = jt[ti[rv]]  # [c, 7, P]
        cot = torch.cat([quat_rotate_vjp_q(q[rv], x[rv], wld0[rv]), wld0[rv]], dim=1)
        ur.index_add_(0, rows, torch.einsum("mc,mcp->mp", cot, mt))
        if include_mean_term:
            wr = w[a:b][rv]
            for ax in range(3):
                g = torch.zeros(int(rv.sum()), 3, dtype=_F32, device=dev)
                g[:, ax] = wr
                cotb = torch.cat([quat_rotate_vjp_q(q[rv], x[rv], g), g], dim=1)
                br[ax].index_add_(0, rows, torch.einsum("mc,mcp->mp", cotb, mt))

    ends = torch.nonzero(vend).flatten()  # one per valid run, in run order
    lam_e = lam6[ends]
    invn = invn_end[ends]
    sv = s3[run_valid]
    val = q1[run_valid] - invn * torch.sum(sym6_matvec(lam_e, sv) * sv, dim=1)
    r = torch.sqrt(torch.abs(val) + 1e-30)
    scale = torch.sign(val) / r
    if include_mean_term:
        wls = sym6_matvec(lam_e, sv) * invn[:, None]
        j_rows = scale[:, None] * (ur - (wls[:, 0:1] * br[0] + wls[:, 1:2] * br[1] + wls[:, 2:3] * br[2]))
    else:
        j_rows = scale[:, None] * ur
    jext = torch.cat([j_rows, r[:, None]], dim=1)
    return jext.T @ jext


# --------------------------------------------------------------------------
# K3: line-search candidate errors
# --------------------------------------------------------------------------


def cand_errors(tabs, packed):
    """Total squared DMSA cell residual per candidate pose table.

    tabs [K, Dtab, 8] (K <= 16), packed [16, M].  Returns err [K] f32 =
    sum over valid cells of |q1 - n mean^T wL mean|.

    On the card (csrc/k3_cand.cu; cand_errors_pieces_ref states the cut in
    plain torch): a pieces kernel over CHUNK-position chunks that
    finishes the cells inside a chunk and stages the pieces of the cells
    that cross chunks, a kernel that finishes those from the staged pieces,
    and a fixed-order sum of the block partials: 3 launches."""
    if not packed.is_cuda:
        return cand_errors_ref(tabs, packed)
    dev = packed.device
    k, dtab, _ = tabs.shape
    m = packed.shape[1]
    tabc = prep_tables(tabs)
    pk = packed.contiguous()
    cuda_lib.require(tabc, "tabs", _F32, (k, dtab, 8), dev)
    cuda_lib.require(pk, "packed", _F32, (PACK_ROWS, m), dev)
    if not 1 <= k <= 16:
        raise ValueError(f"cand_errors takes 1..16 candidates, got {k}")
    # stage, has_start, span_end, partial
    buf, ptrs = _scratch(dev, *cuda_lib.scratch_bytes("k3_scratch_bytes", 4, m, k))
    out = torch.empty(k, dtype=_F32, device=dev)
    lib = cuda_lib.library()
    P = cuda_lib.ptr
    cuda_lib.LAUNCHES["cand_errors"] += 1
    cuda_lib.check(
        lib.k3_cand_errors(P(tabc), k, dtab, P(pk), m, *ptrs, P(out), cuda_lib.stream_ptr(dev)),
        "k3_cand_errors",
    )
    return out


def cand_errors_pieces_ref(tabs, packed, chunk=CHUNK):
    """Plain statement of K3's chunk/piece cut (csrc/k3_cand.cu).

    Positions are cut into chunks of `chunk`; a piece is one cell's members
    within one chunk.  Every piece's (s, q1) per candidate is summed on its
    own, a cell's sums are its pieces' sums in chunk order, and err sums
    |q1 - s^T wL s / n| over the valid cells.  A cell inside one chunk is
    finished there; a cell that crosses chunks is staged as at most a head
    piece and a tail piece per chunk and finished by the chunk that holds
    its end row.

    Returns (err [K], staged [n_chunks]: the pieces each chunk hands on,
    finished [n_chunks]: the valid cells each chunk finishes from staged
    pieces)."""
    m = packed.shape[1]
    dev = packed.device
    xs, mu0, lam6, w, tidx, newc, invn_end = _unpack(packed)
    run, piece, first, last, head, ends_run, staged = _chunk_pieces(newc > 0.5, chunk)
    piece_run = run[first]
    n_runs = int(run[-1]) + 1 if m else 0
    vend = invn_end > 0
    ends = torch.nonzero(vend).flatten()
    lam_e, invn = lam6[ends], invn_end[ends]
    err = []
    for k in range(tabs.shape[0]):
        d0 = (_world_points(tabs[k], xs, tidx) - mu0) * w[:, None]
        terms = torch.cat([d0, torch.sum(sym6_matvec(lam6, d0) * d0, dim=1, keepdim=True)], dim=1)
        pieces = torch.zeros(first.shape[0], 4, dtype=_F32, device=dev).index_add_(0, piece, terms)
        cells = torch.zeros(n_runs, 4, dtype=_F32, device=dev).index_add_(0, piece_run, pieces)
        sums = cells[run[ends]]
        sv = sums[:, :3]
        err.append(torch.sum(torch.abs(sums[:, 3] - invn * torch.sum(sym6_matvec(lam_e, sv) * sv, dim=1))))
    # a valid cell that crosses chunks ends in a head piece
    finished = torch.zeros_like(staged).index_add_(0, last // chunk, (head & ends_run & vend[last]).to(torch.int64))
    return torch.stack(err), staged, finished


def cand_errors_ref(tabs, packed):
    """Plain version of cand_errors (segment sums by index_add)."""
    m = packed.shape[1]
    xs, mu0, lam6, w, tidx, newc, invn_end = _unpack(packed)
    seg = torch.cumsum(newc.to(torch.int64), 0) - 1
    vend = invn_end > 0
    out = []
    for k in range(tabs.shape[0]):
        p = _world_points(tabs[k], xs, tidx)
        d0 = (p - mu0) * w[:, None]
        quad = torch.sum(sym6_matvec(lam6, d0) * d0, dim=1)
        s3 = torch.zeros(m, 3, dtype=_F32, device=packed.device).index_add_(0, seg, d0)
        q1 = torch.zeros(m, dtype=_F32, device=packed.device).index_add_(0, seg, quad)
        se = s3[seg][vend]
        val = q1[seg][vend] - invn_end[vend] * torch.sum(sym6_matvec(lam6[vend], se) * se, dim=1)
        out.append(torch.sum(torch.abs(val)))
    return torch.stack(out)
