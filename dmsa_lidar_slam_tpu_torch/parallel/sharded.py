"""Distributed DMSA: point-sharded Gauss-Newton over a rank mesh, the
hash backend (counterpart of dmsa_lidar_slam_tpu/parallel/sharded.py).

The points of a problem are sharded over the mesh.  Gaussian cells live
in a collision-hashed table (no global sort, so each rank's work stays
local): per-cell statistics and the small Gauss-Newton system reduce with
psum, and the (P x P) pose system is solved on every rank.

Differences from the single-card path (ops.gaussians):
  - a cell is a spatial hash slot mod `table_size`, not a sorted unique
    key.  A slot that two voxels share elects an owner voxel (the
    lexicographic minimum of the exact voxel key, two pmin'd segment-min
    rounds); only the owner's points contribute, so the cells that survive
    are exact, and the losing voxels lose their constraint for the
    iteration;
  - the ring-diversity test uses per-cell ring min/max
    (DmsaOptimizer.h:304-307).
No kernel: the cell statistics are segment sums, mins and maxes on
tensors.  Each build sorts its rank's slot ids once (voxel.segments), and
every sum over the slots, of the build and of the iteration's residuals,
adds a slot's members in that order: the same bits on every call, which
float atomics (index_add_ on a card) do not give.  Integer mins and maxes
(scatter_reduce) are exact in any order.

The Jacobian.  The reference linearizes through its psums with JAX's
forward mode; torch.func cannot carry tangents through torch.distributed.
A psum is linear, so the tangent of a psum is the psum of the local
tangents: forward mode runs on the local partial sums only (the point
tangents of transform_fn), the tangent blocks are psum'd beside their
values, and the replicated finish (means, the frozen quadratic form, the
square root) is differentiated in closed form.  The tangents are
[P, T, 3] per grid resolution, which is the price of this backend;
parallel.spatial reduces only the [P+1, P+1] block.

Problem hooks (both receive the replicated `aux`, so one built optimizer
serves every submap of the same shapes):
  transform_fn(params, local_pts, aux) -> global points [n_local, 3]
  extra_fn(params, aux) -> replicated additional residuals (gravity /
  odometry terms; MapManagement.h:210-252 analogues)
"""

from typing import NamedTuple

import torch

from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as opt
from dmsa_lidar_slam_tpu_torch.ops import voxel
from dmsa_lidar_slam_tpu_torch.ops.gaussians import info_from_cov
from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh

DEFAULT_LINE_SEARCH_FRACS = opt.OptimSettings.line_search_fracs
_I32_MAX = 2**31 - 1
_I32_MIN = -(2**31)


def hash_cell_ids(points, mask, grid_size, table_size: int):
    """Spatial-hash cell id per point: the murmur-mixed voxel hash mod
    table_size - 1.  Invalid points map to table_size - 1 (a shared junk
    slot, weight 0 in every reduction)."""
    h = voxel.murmur_voxel_hash(points, grid_size) % (table_size - 1)
    return torch.where(mask, h, torch.full_like(h, table_size - 1))


def _voxel_check_keys(points, mask, grid_size):
    """Two exact per-point voxel keys (hi, lo) for slot-owner election: the
    pair encodes the voxel coordinates losslessly (ops.voxel.voxel_keys), so
    distinct voxels sharing a slot always differ in (hi, lo)."""
    return voxel.voxel_keys(points, mask, grid_size)


def _segment_min(values, cid, table_size: int):
    out = torch.full((table_size,), _I32_MAX, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, cid, values, "amin")


def elect_slot_owners(points, mask, cid, grid_size, table_size: int, mesh: pmesh.Mesh):
    """Per-point keep mask: True iff the point's exact voxel key is the
    lexicographic minimum over its hash slot (two pmin'd segment-min
    rounds, int32).  A collided slot keeps exactly one voxel's points."""
    hi, lo = _voxel_check_keys(points, mask, grid_size)
    owner_hi = pmesh.pmin(_segment_min(hi, cid, table_size), mesh)
    is_owner_hi = hi == owner_hi[cid]
    lo_cand = torch.where(is_owner_hi & mask, lo, torch.full_like(lo, _I32_MAX))
    owner_lo = pmesh.pmin(_segment_min(lo_cand, cid, table_size), mesh)
    return mask & is_owner_hi & (lo == owner_lo[cid])


def _partial_first_moments(points, w, cid, members: voxel.Segments, rings, table_size: int):
    """This shard's count, point sum, ring min and ring max per slot."""
    sums = voxel.segment_sum(members, torch.cat([w[:, None], points * w[:, None]], dim=1))
    count, psum_ = sums[:, 0], sums[:, 1:]
    rmin = _segment_min(torch.where(w > 0, rings, torch.full_like(rings, _I32_MAX)), cid, table_size)
    rmax = torch.full((table_size,), _I32_MIN, dtype=rings.dtype, device=rings.device).scatter_reduce(
        0, cid, torch.where(w > 0, rings, torch.full_like(rings, -_I32_MAX)), "amax")
    return count, psum_, rmin, rmax


class ShardedCells(NamedTuple):
    info: torch.Tensor  # [T, 3, 3]
    weight: torch.Tensor  # [T]
    valid: torch.Tensor  # [T]
    num_valid: torch.Tensor  # []
    count: torch.Tensor  # [T] members over the mesh
    mean: torch.Tensor  # [T, 3] at build time
    members: voxel.Segments  # this rank's points grouped by slot (the build's sort)


def build_cells_sharded(points, mask, rings, grid_size, min_points: int, table_size: int, mesh: pmesh.Mesh):
    """Cell statistics reduced over the mesh.

    Two passes: psum the first moments, giving the global means; then psum
    the mean-centred second moments.  The extra psum round buys f32 safety:
    raw second moments cancel catastrophically (cov ~1e-4 under coordinates
    of ~10 m) and the floored inverse amplifies that noise by 1/floor^2.
    Returns (cells, (cid, keep))."""
    cid = hash_cell_ids(points, mask, grid_size, table_size)
    keep = elect_slot_owners(points, mask, cid, grid_size, table_size, mesh)
    w = keep.to(points.dtype)
    members = voxel.segments(cid, table_size)
    count, psum_, rmin, rmax = _partial_first_moments(points, w, cid, members, rings, table_size)
    moments = pmesh.psum(torch.cat([count[:, None], psum_], dim=1), mesh)
    count, psum_ = moments[:, 0], moments[:, 1:]
    rmin = pmesh.pmin(rmin, mesh)
    rmax = pmesh.pmax(rmax, mesh)
    mean = psum_ / torch.clamp(count, min=1.0)[:, None]

    centered = (points - mean[cid]) * w[:, None]
    outer = (centered[:, :, None] * centered[:, None, :]).reshape(-1, 9)
    m2 = voxel.segment_sum(members, outer)
    cov = pmesh.psum(m2, mesh).reshape(-1, 3, 3) / torch.clamp(count - 1.0, min=1.0)[:, None, None]

    slot = torch.arange(table_size, device=points.device)
    valid = (count >= min_points) & (rmin != rmax) & (slot < table_size - 1)
    info = info_from_cov(cov)
    raw_w = torch.where(valid, 1.0 / torch.clamp(count, min=1.0), torch.zeros_like(count))
    num_valid = torch.sum(valid)
    mean_w = torch.sum(raw_w) / torch.clamp(num_valid, min=1)
    weight = torch.where(valid, raw_w / torch.clamp(mean_w, min=1e-30), torch.zeros_like(raw_w))
    cells = ShardedCells(info=info, weight=weight, valid=valid, num_valid=num_valid, count=count, mean=mean,
                         members=members)
    return cells, (cid, keep)


def _finish(cells: ShardedCells, quad_sum):
    """Replicated residuals [..., T] from the psum'd quadratic forms."""
    val = cells.weight * quad_sum
    return val, torch.where(cells.valid, torch.sqrt(torch.abs(val) + 1e-30), torch.zeros_like(val))


def _batched_residuals(points_b, keep, cid, cells: ShardedCells, mesh: pmesh.Mesh):
    """Residuals [B, T] of B point sets [B, n, 3] over the frozen cells:
    the means from each set's own psum'd sums (membership frozen), then the
    frozen quadratic form.  Two psums for all B."""
    w = keep.to(points_b.dtype)
    s = voxel.segment_sum(cells.members, points_b * w[None, :, None], dim=1)
    mean = pmesh.psum(s, mesh) / torch.clamp(cells.count, min=1.0)[None, :, None]
    d = points_b - mean[:, cid]
    quad = torch.einsum("bni,nij,bnj->bn", d, cells.info[cid], d) * w
    q = voxel.segment_sum(cells.members, quad, dim=1)
    return _finish(cells, pmesh.psum(q, mesh))[1]


def cell_residuals_sharded(points, keep, cid, cells: ShardedCells, table_size: int, mesh: pmesh.Mesh):
    """Replicated [T] residual vector from sharded points.  `keep` is the
    frozen membership mask of the matching build_cells_sharded call
    (membership stays frozen within an iteration, DmsaOptimizer.h:234-273)."""
    assert cells.count.shape[0] == table_size
    return _batched_residuals(points[None], keep, cid, cells, mesh)[0]


def _residuals_and_jacobian(points, dpoints, keep, cid, cells: ShardedCells, mesh: pmesh.Mesh):
    """(e [T], J [T, P]) of cell_residuals_sharded at the build's points,
    given their tangents dpoints [P, n, 3].  The mean's tangent is the
    psum of the local sums' tangents over the (frozen) count; the
    quadratic form's tangent 2 d^T L dd, psum'd beside the form itself."""
    w = keep.to(points.dtype)
    ds = voxel.segment_sum(cells.members, dpoints * w[None, :, None], dim=1)
    dmean = pmesh.psum(ds, mesh) / torch.clamp(cells.count, min=1.0)[None, :, None]
    d = points - cells.mean[cid]
    ld = torch.einsum("nij,nj->ni", cells.info[cid], d)
    quad = torch.sum(d * ld, dim=1) * w
    dquad = 2.0 * torch.einsum("pni,ni->pn", dpoints - dmean[:, cid], ld) * w
    q = voxel.segment_sum(cells.members, torch.cat([quad[None], dquad]), dim=1)
    q = pmesh.psum(q, mesh)
    val, r = _finish(cells, q[0])
    dr = torch.where(cells.valid, torch.sign(val) * cells.weight * q[1:] / (2.0 * r), torch.zeros_like(q[1:]))
    return r, dr.T


def _point_tangents(transform_fn, params, local_pts, aux, chunk: int):
    """d transform_fn / d params as [P, n, 3]: forward mode over blocks of
    `chunk` unit tangents."""
    p = params.shape[0]
    eye = torch.eye(p, dtype=params.dtype, device=params.device)

    def push(t):
        return torch.func.jvp(lambda q: transform_fn(q, local_pts, aux), (params,), (t,))[1]

    return torch.cat([torch.func.vmap(push)(eye[s:s + chunk]) for s in range(0, p, chunk)])


def _gn_iteration(
    transform_fn, params, local_pts, mask, rings, aux, grid_sizes, min_points, table_size, lambda_diag,
    step_length, max_step, mesh, extra_fn, line_search_fracs,
):
    """One damped GN iteration with frozen cells (shared by the one-shot
    step and the optimize loop).  Returns (new_params, improved,
    best_error, error0, step_norm, num_cells)."""
    pdt = params.dtype
    num_params = params.shape[0]
    pts0 = transform_fn(params, local_pts, aux)
    built = [build_cells_sharded(pts0, mask, rings, g, min_points, table_size, mesh) for g in grid_sizes]
    dpts = _point_tangents(transform_fn, params, local_pts, aux, opt.OptimSettings.jacobian_chunk)
    e_parts, j_parts = [], []
    for cells, (cid, keep) in built:
        e, j = _residuals_and_jacobian(pts0, dpts, keep, cid, cells, mesh)
        e_parts.append(e)
        j_parts.append(j)
    if extra_fn is not None:
        e, j = opt.value_and_jacfwd(lambda p: extra_fn(p, aux), params, opt.OptimSettings.jacobian_chunk)
        e_parts.append(e)
        j_parts.append(j)
    rdt = e_parts[-1].dtype if extra_fn is not None else e_parts[0].dtype
    e0 = torch.cat([e.to(rdt) for e in e_parts])
    J = torch.cat([j.to(rdt) for j in j_parts])

    H = J.T @ J + lambda_diag * torch.eye(num_params, dtype=pdt, device=params.device)
    step, nan_step = opt._clipped_step(H, (J.T @ e0).to(H.dtype), step_length, max_step)

    # line search: the candidates' local sums in one batched pass, psum'd
    # together
    ks = torch.tensor(line_search_fracs, dtype=pdt, device=params.device)
    cand = params[None, :] + ks[:, None] * step[None, :]
    pts_k = torch.func.vmap(lambda p: transform_fn(p, local_pts, aux))(cand)
    parts = [_batched_residuals(pts_k, keep, cid, cells, mesh).to(rdt) for cells, (cid, keep) in built]
    if extra_fn is not None:
        parts.append(torch.func.vmap(lambda p: extra_fn(p, aux))(cand).to(rdt))
    errs = torch.sum(torch.cat(parts, dim=1) ** 2, dim=1)
    error0 = torch.dot(e0, e0)
    all_err = torch.cat([error0[None], errs])
    best = torch.argmin(all_err)
    improved = (best > 0) & ~nan_step
    new_params = torch.where(improved, cand[torch.clamp(best - 1, min=0)], params)
    num_cells = sum(c.num_valid for c, _ in built)
    return new_params, improved, all_err[best].to(pdt), error0.to(pdt), torch.linalg.norm(step), num_cells


def sharded_gn_step(
    transform_fn, params, local_pts, mask, rings, grid_sizes, min_points: int, table_size: int,
    lambda_diag: float, step_length: float, max_step: float, mesh: pmesh.Mesh, extra_fn=None, aux=None,
    line_search_fracs=DEFAULT_LINE_SEARCH_FRACS,
):
    """One damped GN step with this rank's points (local_pts, mask, rings:
    its shard).  transform_fn(params, local_pts, aux) -> global points, the
    problem's transform (it knows its shard from the mesh); extra_fn(params,
    aux) -> replicated additional residuals.  Cell build, residuals and the
    Jacobian reduce with psum; the small solve is replicated.  Returns
    (new_params, best_error, num_cells)."""
    new_params, _, best_err, _, _, num_cells = _gn_iteration(
        transform_fn, params, local_pts, mask, rings, aux, grid_sizes, min_points, table_size, lambda_diag,
        step_length, max_step, mesh, extra_fn, line_search_fracs,
    )
    return new_params, best_err, num_cells


def sharded_optimize(
    transform_fn, params0, local_pts, mask, rings, aux, grid_sizes, num_iter: int, min_points: int,
    table_size: int, lambda_diag: float, step_length: float, max_step: float, epsilon: float = 1e-5,
    mesh: pmesh.Mesh = pmesh.ONE_RANK, extra_fn=None, line_search_fracs=DEFAULT_LINE_SEARCH_FRACS,
    min_num_gaussians: int = opt.OptimSettings.min_num_gaussians,
):
    """The DMSA optimization loop on this rank's shard: per-iteration cell
    rebuild, damped GN step, line search, and the reference's stop rules
    (too-few-gaussians / no-improvement / ||step|| < epsilon,
    DmsaOptimizer.h:89-93,130-143; thresholds from the single-card
    OptimSettings).  The too-few iteration keeps its pre-step params.  The
    stop test reads replicated values, so every rank stops together.
    Returns (params, num_iters, final_error, num_cells)."""
    params = params0
    err = torch.tensor(float("inf"), dtype=params0.dtype, device=params0.device)
    ncells = torch.zeros((), dtype=torch.int64, device=params0.device)
    iters = 0
    for _ in range(num_iter):
        with pmesh.count_scope("iteration"):
            p, improved, err, _, step_norm, ncells = _gn_iteration(
                transform_fn, params, local_pts, mask, rings, aux, grid_sizes, min_points, table_size,
                lambda_diag, step_length, max_step, mesh, extra_fn, line_search_fracs,
            )
        too_few = ncells < min_num_gaussians
        params = torch.where(too_few, params, p)
        iters += 1
        if bool(~improved | (step_norm < epsilon) | too_few):  # host sync: the stop decision
            break
    return params, torch.tensor(iters, dtype=torch.int32, device=params0.device), err, ncells


def make_sharded_step(
    mesh: pmesh.Mesh, transform_fn, min_points, table_size, lambda_diag, step_length, max_step, grid_sizes,
    extra_fn=None, line_search_fracs=DEFAULT_LINE_SEARCH_FRACS,
):
    """sharded_gn_step over the mesh.  Call as step(params, local_pts,
    mask, rings, aux) with the full arrays on every member (each takes its
    shard of the leading axis); returns (new_params, best_error,
    num_cells), replicated."""

    def step(params, local_pts, mask, rings, aux):
        return sharded_gn_step(
            transform_fn, params, pmesh.shard_leading(mesh, local_pts), pmesh.shard_leading(mesh, mask),
            pmesh.shard_leading(mesh, rings), grid_sizes, min_points, table_size, lambda_diag, step_length,
            max_step, mesh, extra_fn=extra_fn, aux=aux, line_search_fracs=line_search_fracs,
        )

    return step


def make_sharded_optimize(
    mesh: pmesh.Mesh, transform_fn, num_iter, min_points, table_size, lambda_diag, step_length, max_step,
    epsilon=1e-5, extra_fn=None, line_search_fracs=DEFAULT_LINE_SEARCH_FRACS, n_grids: int = 2,
):
    """The full optimization loop over the mesh:
        opt(params0, local_pts, mask, rings, aux, grid_sizes)
    with the full arrays on every member and grid_sizes [n_grids] per call
    (one built loop serves every submap's grid).  Returns (params,
    num_iters, final_error, num_cells), replicated."""

    def run(params0, local_pts, mask, rings, aux, grid_sizes):
        grids = tuple(grid_sizes[i] for i in range(n_grids))
        return sharded_optimize(
            transform_fn, params0, pmesh.shard_leading(mesh, local_pts), pmesh.shard_leading(mesh, mask),
            pmesh.shard_leading(mesh, rings), aux, grids, num_iter, min_points, table_size, lambda_diag,
            step_length, max_step, epsilon=epsilon, mesh=mesh, extra_fn=extra_fn,
            line_search_fracs=line_search_fracs,
        )

    return run
