"""Spatially-owned distributed DMSA: shuffle points to voxel owners, run
the single-card kernels K1-K3 per rank, reduce only the normal equations
(counterpart of dmsa_lidar_slam_tpu/parallel/spatial.py).

Each voxel has an owner rank (a murmur-mixed hash of its coordinates mod
the mesh size).  Per Gauss-Newton iteration:

  1. every rank transforms its resident points and sends each to the owner
     of its voxel: one all_to_all of the point payload (local point, table
     index, ring, split id) and one of its mask, per grid resolution.  The
     owner recomputes the world point from the replicated pose table with
     the sender's own expression, so the point lands in the voxel its owner
     hash was computed from;
  2. the owner holds all members of its cells, so the single-card cell
     build K1 runs unchanged on the received rows: exact cells, no hash
     table, no owner election;
  3. the only other collectives are the [P+1, P+1] normal-equation block of
     K2 and the K line-search errors of K3 (one psum each), and the two
     counts (one int32[2] psum).

The all_to_all uses fixed-capacity buckets, `cap` rows per (sender,
receiver) pair, cap_factor x the balanced share.  Points overflowing a
bucket lose their constraint for that iteration: counted and returned
(`overflow`), never silent.

Interface as parallel.keyframe_dist.make_keyframe_dist_optimize, so the
pipelines can select either backend.
"""

import functools

import torch

from dmsa_lidar_slam_tpu_torch.core import rotations as rot
from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as opt
from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
from dmsa_lidar_slam_tpu_torch.ops import fused_residuals as fr
from dmsa_lidar_slam_tpu_torch.ops import voxel
from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh

_F32 = torch.float32


def owner_of_voxels(points, mask, grid_size, n_devices: int):
    """Owner rank per point: the murmur-mixed voxel hash mod n_devices;
    n_devices for masked points (nobody's)."""
    h = voxel.murmur_voxel_hash(points, grid_size)
    return torch.where(mask, h % n_devices, torch.full_like(h, n_devices))


def shuffle_to_owners(payload, owner, n_devices: int, cap: int, mesh: pmesh.Mesh):
    """all_to_all repartition of per-point payload rows by owner rank.

    payload [n_loc, C], owner [n_loc] in [0, n_devices] (n_devices: masked,
    dropped).  Returns (received [n_devices * cap, C], recv_mask, overflow
    []): rows [d * cap, (d + 1) * cap) come from rank d; overflow counts
    this rank's points dropped because a bucket exceeded `cap`."""
    n_loc, n_cols = payload.shape
    dev = payload.device
    # stable sort by owner; each point's rank within its destination run
    order = torch.argsort(owner, stable=True)
    owner_s = owner[order]
    i = torch.arange(n_loc, device=dev)
    newd = torch.ones(n_loc, dtype=torch.bool, device=dev)
    newd[1:] = owner_s[1:] != owner_s[:-1]
    rank = i - torch.cummax(torch.where(newd, i, torch.zeros_like(i)), dim=0).values
    sent = owner_s < n_devices
    fits = (rank < cap) & sent
    overflow = torch.sum((rank >= cap) & sent)
    # scatter into [n_devices, cap] send buckets (plus one junk row)
    slot = torch.where(fits, owner_s * cap + rank, torch.full_like(rank, n_devices * cap))
    buckets = torch.zeros(n_devices * cap + 1, n_cols, dtype=payload.dtype, device=dev)
    buckets[slot] = torch.where(fits[:, None], payload[order], torch.zeros((), dtype=payload.dtype, device=dev))
    bmask = torch.zeros(n_devices * cap + 1, dtype=torch.bool, device=dev)
    bmask[slot] = fits
    recv = pmesh.all_to_all(buckets[:-1].reshape(n_devices, cap, n_cols), mesh)
    recv_mask = pmesh.all_to_all(bmask[:-1].reshape(n_devices, cap), mesh)
    return recv.reshape(n_devices * cap, n_cols), recv_mask.reshape(n_devices * cap), overflow


def bucket_cap(n_total: int, n_devices: int, cap_factor: float = 2.0) -> int:
    """Rows per (sender, receiver) bucket: cap_factor x the balanced share,
    rounded up to a multiple of 128."""
    n_loc = n_total // n_devices
    return -(-int(cap_factor * n_loc / n_devices) // 128) * 128


def world_points(tab, xs, tidx):
    """world = quat_rotate(q[tidx], xs) + t[tidx] in f32: one expression on
    sender and receiver, so both see the same bits."""
    return rot.quat_rotate(tab[:, 0:4][tidx], xs) + tab[:, 4:7][tidx]


@functools.lru_cache(maxsize=None)
def _cached_spatial_optimize(
    mesh, n_keyframes, n_pts_per_kf, num_iter, min_points, min_num_gaussians, line_search_fracs, cap,
    lambda_diag, step_length, max_step, epsilon, use_gravity, use_odometry, use_split, grid_factors,
):
    n_dev = mesh.size
    tabular = kfm.make_tabular(kfm.MapShapes(n_keyframes, n_pts_per_kf), use_gravity, use_odometry, use_split)

    def iteration(params, xs, mask, rings, tidx, nrm, aux, grids):
        """One Gauss-Newton iteration on this rank's shard.  Returns
        (new_params, done, improved, best error, cells, overflow); the last
        four are replicated over the mesh."""
        pdt, dev = params.dtype, params.device
        num_params = params.shape[0]
        tab, extra_c, dtab, j_extra = tabular.tables_jac(params, aux)  # K7 on the card
        world = world_points(tab, xs, tidx)
        # the normal-split channel from the current world normals rides as
        # one column: splits subdivide cells within a voxel, so ownership
        # is unaffected
        cols = [xs, tidx.to(_F32)[:, None], rings.to(_F32)[:, None]]
        if use_split:
            cols.append(kfm.normal_split_ids(rot.quat_rotate(tab[:, 0:4][tidx], nrm)).to(_F32)[:, None])
        payload = torch.cat(cols, dim=1)
        packs, counts = [], []
        for gi in range(len(grid_factors)):
            grid = grids[gi]
            owner = owner_of_voxels(world, mask, grid, n_dev)
            recv, rmask, ov = shuffle_to_owners(payload, owner, n_dev, cap, mesh)
            r_xs = recv[:, 0:3].contiguous()
            r_tidx = recv[:, 3].to(torch.int64)
            r_split = recv[:, 5].to(torch.int32) if use_split else None
            pk, nv, _ = fr.build_packed(
                world_points(tab, r_xs, r_tidx), rmask, recv[:, 4].to(torch.int32), r_xs, r_tidx, grid,
                min_points, tab, split_ids=r_split,
            )
            packs.append(pk)
            counts.append(torch.stack([nv.to(torch.int32), ov.to(torch.int32)]))
        packed = torch.cat(packs, dim=1)
        # the cell count and the overflow in one int32 psum (the reference's
        # two int32 psums, 8 bytes in one call)
        n_cells, overflow = pmesh.psum(torch.stack(counts).sum(0, dtype=torch.int32), mesh).to(torch.int64)

        # normal equations: the local block over owned cells, one psum
        max_cells = packed.shape[1] // max(1, min_points) + len(packs)
        hext = pmesh.psum(fr.gn_system(tab, dtab, packed, max_cells=max_cells), mesh)
        je = j_extra.to(pdt)
        H = hext[:num_params, :num_params].to(pdt) + je @ je.T
        H = H + lambda_diag * torch.eye(num_params, dtype=pdt, device=dev)
        g = hext[:num_params, num_params].to(pdt) + je @ extra_c.to(pdt)
        step, nan_step = opt._clipped_step(H, g, step_length, max_step)

        # line search: candidate errors complete per owned cell, one psum
        # of the K errors
        ks = torch.tensor(line_search_fracs, dtype=pdt, device=dev)
        cand = torch.cat([params[None, :], params[None, :] + ks[:, None] * step[None, :]], dim=0)
        tabs, extras = tabular.tables_batch(cand, aux)
        errs = pmesh.psum(fr.cand_errors(tabs, packed).to(pdt), mesh) + torch.sum(extras.to(pdt) ** 2, dim=1)
        best = torch.argmin(errs)
        # too few gaussians rejects this iteration's step, as the single-card
        # optimizer does (DmsaOptimizer.h:89-93 aborts before stepping)
        improved = (best > 0) & ~nan_step & (n_cells >= min_num_gaussians)
        new_params = torch.where(improved, cand[best], params)
        done = ~improved | (torch.linalg.norm(step) < epsilon)
        return new_params, done, improved, errs[best], n_cells, overflow

    def run(params0, xs, mask, rings, tidx, nrm, aux, grids):
        """The reference's num_iter iterations under lax.scan: once `done`,
        params stay frozen while the later iterations still set the error,
        cell count and overflow.  Frozen params repeat the same iteration
        bit for bit, so the host stops after the first frozen iteration (or
        at `done` itself if it kept the params): the same tuple as running
        all num_iter."""
        params, done = params0, False
        err = torch.tensor(float("inf"), dtype=params0.dtype, device=params0.device)
        n_cells = overflow = max_overflow = torch.zeros((), dtype=torch.int64, device=params0.device)
        for _ in range(num_iter):
            with pmesh.count_scope("iteration"):
                new_params, done_now, improved, err, n_cells, overflow = iteration(
                    params, xs, mask, rings, tidx, nrm, aux, grids)
            max_overflow = torch.maximum(max_overflow, overflow)
            if done:  # frozen: every later iteration is this one again
                break
            params = new_params
            done, kept = (bool(v) for v in torch.stack([done_now, ~improved]).tolist())  # one host sync
            if done and kept:
                break
        return params, err, n_cells, max_overflow

    return run


def make_spatial_dist_optimize(
    mesh: pmesh.Mesh,
    shapes: kfm.MapShapes,
    num_iter: int = 10,
    min_points: int = 6,
    min_num_gaussians: int = None,
    line_search_fracs=None,
    cap_factor: float = 2.0,
    lambda_diag: float = 1e-5,
    step_length: float = 0.2,
    max_step: float = 0.01,
    epsilon: float = 1e-5,
    use_gravity: bool = False,
    use_odometry: bool = False,
    use_split: bool = False,
    grid_factors=(2.0, 5.0),
):
    """Spatially-owned distributed keyframe adjustment (see module doc),
    built once per (mesh, shapes, settings).

    Returns opt(params0, flat_pts, flat_mask, flat_rings, aux, grid_sizes,
    flat_normals=None) -> (params, final_error, num_cells, max_overflow),
    replicated.  Every member of the mesh calls it with the same full
    arrays [K * P, ...]; each works on its shard of the leading axis.  The
    table index is derived internally (point index // n_pts_per_kf); with
    use_split=True, flat_normals [K * P, 3] (keyframe-local) supply the
    per-iteration normal-split cell channel like the single-card submap.
    The stop threshold and the candidate grid default to the single-card
    optimizer's OptimSettings."""
    if min_num_gaussians is None:
        min_num_gaussians = opt.OptimSettings.min_num_gaussians
    if line_search_fracs is None:
        line_search_fracs = opt.OptimSettings.line_search_fracs
    if not mesh.member:
        raise ValueError("this rank is not a member of the mesh")
    n_total = shapes.n_keyframes * shapes.n_pts_per_kf
    if n_total % mesh.size:
        raise ValueError(f"{n_total} points do not shard evenly over {mesh.size} ranks")
    run = _cached_spatial_optimize(
        mesh, shapes.n_keyframes, shapes.n_pts_per_kf, num_iter, min_points, min_num_gaussians,
        tuple(line_search_fracs), bucket_cap(n_total, mesh.size, cap_factor), lambda_diag, step_length, max_step,
        epsilon, use_gravity, use_odometry, use_split, tuple(grid_factors),
    )

    def optimize(params0, flat_pts, flat_mask, flat_rings, aux, grid_sizes, flat_normals=None):
        dev = flat_pts.device
        tidx = torch.arange(shapes.n_keyframes, device=dev).repeat_interleave(shapes.n_pts_per_kf)
        if flat_normals is None:
            flat_normals = torch.zeros_like(flat_pts)

        def shard(x):
            return pmesh.shard_leading(mesh, x)

        return run(
            params0, shard(flat_pts).to(_F32).contiguous(), shard(flat_mask), shard(flat_rings), shard(tidx),
            shard(flat_normals).to(_F32), aux, grid_sizes.to(device=dev, dtype=_F32),
        )

    return optimize
