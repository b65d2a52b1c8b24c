"""The DMSA Gauss-Newton kernels K1-K3 as their plain PyTorch versions: a
frozen copy of dmsa_lidar_slam_tpu_torch/ops/fused_residuals.py whose
public functions (build_packed, gn_system, cand_errors) run the plain
versions (the *_ref twins) on every device.

Both DMSA problems share one structure: world point j =
quat_rotate(q[tidx_j], x_j) + t[tidx_j] with (q, t) rows of a small pose
table (the window's dense trajectory table or one row per keyframe; static
points ride on a trailing identity row).

Packed per-point layout [16, M]:
    rows 0-2 x (local point), 3-5 mu0 (cell mean at build time),
    6-11 lamw6 (weight * Lambda, packed 00,01,02,11,12,22), 12 w (validity),
    13 table index, 14 run-start flag, 15 1/count at valid run-end rows.
"""

import torch

from bench_port.reference.core.rotations import quat_rotate, quat_rotate_vjp_q
from bench_port.reference.ops import gaussians
from bench_port.reference.ops.eig3 import sym6_matvec

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

def build_packed(points_w, mask, ring_ids, xs, tidx, grid_size, min_points: int, tab=None, split_ids=None,
                 obs_weight=None):
    """K1 as its plain version, on every device."""
    return build_packed_ref(points_w, mask, ring_ids, xs, tidx, grid_size, min_points, tab, split_ids, obs_weight)


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




def gn_system(tab, dtabs, packed, max_cells=None):
    """K2 as its plain version, on every device (the kernel omits the mean
    term, as this does)."""
    return gn_system_ref(tab, dtabs, packed, include_mean_term=False)


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
    """K3 as its plain version, on every device."""
    return cand_errors_ref(tabs, packed)


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
