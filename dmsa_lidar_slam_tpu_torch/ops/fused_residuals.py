"""The DMSA Gauss-Newton kernels K1-K3 and their plain PyTorch versions
(counterpart of dmsa_lidar_slam_tpu/ops/fused_residuals.py).

Both DMSA problems share one structure: world point j =
quat_rotate(q[tidx_j], x_j) + t[tidx_j] with (q, t) rows of a small pose
table (the window's dense trajectory table or one row per keyframe; static
points ride on a trailing identity row).

  K1 build_packed  voxel sort (torch) -> cell build kernel -> packed [16, N]
  K2 gn_system     Hext = [J e]^T [J e] over the cell residuals, [P+1, P+1]
  K3 cand_errors   line-search errors of K candidate tables, [K]

Packed per-point layout [16, M] (the reference's, kept so the tests compare
like with like):
    rows 0-2 x (local point), 3-5 mu0 (cell mean at build time),
    6-11 lamw6 (weight * Lambda, packed 00,01,02,11,12,22), 12 w (validity),
    13 table index, 14 run-start flag, 15 1/count at valid run-end rows.

Each public function runs its CUDA kernel (csrc/) for CUDA tensors and its
plain version (the *_ref twin) for CPU tensors; there is no fallback from
one to the other.
"""

import torch

from dmsa_lidar_slam_tpu_torch.core.rotations import quat_rotate, quat_rotate_vjp_q
from dmsa_lidar_slam_tpu_torch.ops import cuda_lib, gaussians, voxel
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


# --------------------------------------------------------------------------
# K1: cell build
# --------------------------------------------------------------------------


def _sorted_kin(points_w, mask, ring_ids, xs, tidx, grid_size, split_ids):
    """Voxel sort and run flags (torch, as the reference leaves them to
    XLA).  Returns (kin [6, n] f32: xs(3), enc, newc, is_end; num_raw)."""
    hi, lo = voxel.voxel_keys(points_w, mask, grid_size, channel=split_ids)
    key_s, order = torch.sort(voxel.combined_key(hi, lo), stable=True)
    enc = (
        (tidx.to(torch.int32) << 11) | ((ring_ids.to(torch.int32) & 1023) << 1) | mask.to(torch.int32)
    ).to(_F32)
    new_cell, is_end = voxel.run_flags(key_s)
    enc_s = enc[order]
    kin = torch.cat(
        [xs.to(_F32)[order].T, enc_s[None], new_cell.to(_F32)[None], is_end.to(_F32)[None]], dim=0
    ).contiguous()
    num_raw = torch.sum(new_cell & mask[order])
    return kin, num_raw


def build_packed(points_w, mask, ring_ids, xs, tidx, grid_size, min_points: int, tab, split_ids=None):
    """One-resolution cell build straight to the packed kernel input.

    points_w [N, 3] supply the voxel keys; the cell statistics use the
    world points recomputed from (tab [Dtab, 8], xs, tidx) in f32, exactly
    as K2/K3 recompute them.  Returns (packed [16, N], num_valid, num_raw).
    """
    if not points_w.is_cuda:
        return build_packed_ref(points_w, mask, ring_ids, xs, tidx, grid_size, min_points, tab, split_ids)
    if tab.shape[0] > 8192:
        raise ValueError("enc packs the table index in 13 bits")
    dev = points_w.device
    kin, num_raw = _sorted_kin(points_w, mask, ring_ids, xs, tidx, grid_size, split_ids)
    n = kin.shape[1]
    tabc = prep_tables(tab)
    cuda_lib.require(tabc, "tab", _F32, device=dev)
    cuda_lib.require(kin, "kin", _F32, (6, n), dev)
    packed = torch.empty((PACK_ROWS, n), dtype=_F32, device=dev)
    endw = torch.empty((2, n), dtype=_F32, device=dev)
    stats = torch.empty(2, dtype=_F32, device=dev)
    nvalid = torch.empty((), dtype=torch.int32, device=dev)
    lib = cuda_lib.library()
    stream = cuda_lib.stream_ptr(dev)
    P = cuda_lib.ptr
    cuda_lib.LAUNCHES["build_packed"] += 1
    cuda_lib.check(
        lib.k1_build_fwd(P(tabc), tabc.shape[0], P(kin), n, int(min_points),
                         float(COV_EIG_FLOOR), P(packed), P(endw), stream),
        "k1_build_fwd",
    )
    cuda_lib.check(lib.k1_build_finish(P(endw), n, P(packed), P(stats), P(nvalid), stream), "k1_build_finish")
    return packed, nvalid, num_raw


def build_packed_ref(points_w, mask, ring_ids, xs, tidx, grid_size, min_points: int, tab=None, split_ids=None):
    """Plain version of build_packed: gaussians.build_cells + pack_rows.
    With `tab` the statistics use the table-recomputed world points (the
    kernel's semantics); without it, points_w directly."""
    pts = points_w if tab is None else _world_points(tab, xs, tidx) * mask[:, None].to(_F32)
    aux = torch.cat([xs.to(_F32), tidx.to(_F32)[:, None]], dim=1)
    cells, aux_s = gaussians.build_cells(
        pts, mask, ring_ids, grid_size, min_points, split_ids=split_ids, aux=aux, key_points=points_w
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


K2_SEGMENT = 128  # most members per K2 segment: a long cell spreads over warps


def _k2_segments(pk):
    """Cut every valid cell (run of the packed rows) into segments of at most
    K2_SEGMENT members.  Returns per position: seg_of (segment id, -1 in
    invalid cells), first_sid (segment id of the cell's first member) and
    vid (exclusive count of valid cell ends), all int32, plus the number of
    valid cells [1].  No host sync."""
    m = pk.shape[1]
    dev = pk.device
    iota = torch.arange(m, dtype=torch.int64, device=dev)
    newc = pk[14] > 0.5
    valid_end = pk[15] > 0
    run_start = torch.cummax(torch.where(newc, iota, torch.zeros_like(iota)), 0).values
    run_id = torch.cumsum(newc, 0) - 1
    run_valid = torch.zeros(m, dtype=torch.int32, device=dev).scatter_reduce_(
        0, run_id, valid_end.to(torch.int32), "amax"
    )
    pos_valid = run_valid[run_id] > 0
    seg_start = pos_valid & (newc | ((iota - run_start) % K2_SEGMENT == 0))
    seg_of = torch.where(pos_valid, torch.cumsum(seg_start, 0, dtype=torch.int32) - 1, -1).to(torch.int32)
    first_sid = seg_of[run_start].contiguous()
    incl = torch.cumsum(valid_end, 0, dtype=torch.int32)
    vid = (incl - valid_end.to(torch.int32)).contiguous()
    return seg_of.contiguous(), first_sid, vid, incl[-1:]


def gn_system(tab, dtabs, packed, max_cells=None):
    """One-pass Gauss-Newton normal equations over the cell residuals.

    tab [Dtab, 8] current pose table, dtabs [P, Dtab, 8] its parameter
    Jacobian, packed [16, M].  Returns Hext [P+1, P+1] f32 with
    Hext[:P, :P] = J^T J, Hext[:P, P] = J^T e, Hext[P, P] = e^T e, omitting
    the mean term like the reference's kernel.  max_cells bounds the number
    of valid cells (M // min_points_per_cell); it sizes the staged J rows.
    """
    if not packed.is_cuda:
        return gn_system_ref(tab, dtabs, packed, include_mean_term=False)
    dev = packed.device
    p_dim = dtabs.shape[0]
    m = packed.shape[1]
    rmax = m if max_cells is None else max(1, min(m, int(max_cells)))
    tabc = prep_tables(tab)
    jt = prep_jac_tables(dtabs)
    pk = packed.contiguous()
    cuda_lib.require(tabc, "tab", _F32, device=dev)
    cuda_lib.require(jt, "jt", _F32, (tab.shape[0], 7, p_dim), dev)
    cuda_lib.require(pk, "packed", _F32, (PACK_ROWS, m), dev)
    seg_of, first_sid, vid, nvalid = _k2_segments(pk)
    nrows = torch.clamp(nvalid, max=rmax).contiguous()
    # segments: at most one per valid cell plus one per K2_SEGMENT members
    nseg = rmax + m // K2_SEGMENT + 1
    p1 = p_dim + 1
    tiles = -(-p1 // 64)
    splits = max(1, min(-(-264 // (tiles * tiles)), -(-rmax // 256)))
    stage_u = torch.empty((nseg, p_dim), dtype=_F32, device=dev)
    stage_s = torch.empty((nseg, 4), dtype=_F32, device=dev)
    jrows = torch.empty((rmax, p1), dtype=_F32, device=dev)
    partial = torch.empty((splits, p1, p1), dtype=_F32, device=dev)
    hext = torch.empty((p1, p1), dtype=_F32, device=dev)
    lib = cuda_lib.library()
    stream = cuda_lib.stream_ptr(dev)
    P = cuda_lib.ptr
    cuda_lib.LAUNCHES["gn_system"] += 1
    cuda_lib.check(
        lib.k2_gn_rows(P(tabc), P(jt), p_dim, P(pk), m, P(seg_of), P(first_sid), P(vid), P(stage_u),
                       P(stage_s), P(jrows), rmax, stream),
        "k2_gn_rows",
    )
    cuda_lib.check(lib.k2_gn_jtj(P(jrows), P(nrows), p1, splits, P(partial), P(hext), stream), "k2_gn_jtj")
    return hext


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
    sum over valid cells of |q1 - n mean^T wL mean|."""
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
    nblocks = max(1, -(-m // 256))
    partial = torch.empty((nblocks, k), dtype=_F32, device=dev)
    out = torch.empty(k, dtype=_F32, device=dev)
    lib = cuda_lib.library()
    P = cuda_lib.ptr
    cuda_lib.LAUNCHES["cand_errors"] += 1
    cuda_lib.check(
        lib.k3_cand_errors(P(tabc), k, dtab, P(pk), m, P(partial), P(out), cuda_lib.stream_ptr(dev)),
        "k3_cand_errors",
    )
    return out


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
