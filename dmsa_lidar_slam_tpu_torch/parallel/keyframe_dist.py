"""Distributed keyframe-map adjustment with keyframes sharded over the mesh
(counterpart of dmsa_lidar_slam_tpu/parallel/keyframe_dist.py).

The keyframe ring's points are partitioned over the ranks along time;
each rank transforms only its shard's points, the cell statistics and the
Gauss-Newton system reduce over psum (parallel.sharded, the hash backend),
and the small pose-chain solve is replicated.

The gravity error terms (MapManagement.h:210-232) and odometry priors
(MapManagement.h:234-252) are tiny and replicated: an `extra_fn` over the
replicated KfAux.  Everything problem-specific rides in KfAux, so one
built optimizer serves every submap of the same map shapes: the path the
pipelines take when `Config.distributed_keyframe_opt` is set with
dist_backend="hash".
"""

import functools
import logging
from typing import NamedTuple

import torch

from dmsa_lidar_slam_tpu_torch.core import rotations as rot
from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as opt
from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh
from dmsa_lidar_slam_tpu_torch.parallel import sharded, spatial

log = logging.getLogger("dmsa_parallel_torch")

# logged once by a pipeline that selects this backend (Config.dist_backend)
HASH_BACKEND_WARNING = (
    "dist_backend='hash' optimizes a coarser submap model than single-card/'spatial': no normal-split "
    "cell channel (Gaussians.h:27-85 analogue) and owner-election cell drops"
)


class KfAux(NamedTuple):
    """Replicated per-problem data for the distributed keyframe adjustment.

    Field names match KeyframeMapData, so kfm.gravity_residuals /
    kfm.odometry_residuals / kfm.global_chain accept it unchanged (they
    read only these fields)."""

    anchor_orient: torch.Tensor  # [3]
    anchor_transl: torch.Tensor  # [3]
    kf_mask: torch.Tensor  # [K] bool
    grav_meas: torch.Tensor  # [K, 3]
    grav_plausible: torch.Tensor  # [K] bool
    odom_rel_transl: torch.Tensor  # [K, 3]
    odom_rel_orient: torch.Tensor  # [K, 3]
    gravity: torch.Tensor  # [3]
    cov_grav_inv: torch.Tensor  # [3, 3]
    odom_transl_cov_inv: torch.Tensor  # [3, 3]
    odom_orient_cov_inv: torch.Tensor  # [3, 3]
    balancing_grav: torch.Tensor  # []
    balancing_odom: torch.Tensor  # []


def aux_from_data(data: kfm.KeyframeMapData) -> KfAux:
    """The replicated aux of full problem data (the point arrays are
    sharded separately)."""
    return KfAux(**{f: getattr(data, f) for f in KfAux._fields})


def make_transform(n_keyframes: int, n_pts_per_kf: int, mesh: pmesh.Mesh):
    """Sharded keyframe-cloud transform: each rank composes the replicated
    global chain and transforms only its own points, whose first has the
    global index rank * n_local.  (K * P) must divide by the mesh size
    (whole or fractional keyframes per shard both work)."""
    shapes = kfm.MapShapes(n_keyframes, n_pts_per_kf)

    def transform(params, local_pts, aux: KfAux):
        _, gp = kfm.global_chain(params, aux, shapes)
        R = rot.axang2rotm(gp.orient).to(torch.float32)  # [K, 3, 3]
        t = gp.transl.to(torch.float32)
        m = local_pts.shape[0]
        g0 = pmesh.axis_index(mesh) * m
        kf_id = (g0 + torch.arange(m, device=local_pts.device)) // n_pts_per_kf
        return torch.einsum("nij,nj->ni", R[kf_id], local_pts) + t[kf_id]

    return transform


def make_extra_fn(n_keyframes: int, use_gravity: bool, use_odometry: bool):
    """Replicated gravity + odometry residuals from KfAux
    (MapManagement.h:210-252), or None when both terms are off."""
    if not (use_gravity or use_odometry):
        return None
    shapes = kfm.MapShapes(n_keyframes, 1)  # n_pts_per_kf unused by the chain

    def extra(params, aux: KfAux):
        chain, gp = kfm.global_chain(params, aux, shapes)
        parts = []
        if use_gravity:
            parts.append(kfm.gravity_residuals(gp, aux))
        if use_odometry:
            parts.append(kfm.odometry_residuals(chain, aux))
        return torch.cat(parts)

    return extra


def make_keyframe_dist_step(
    mesh: pmesh.Mesh,
    n_keyframes: int,
    n_pts_per_kf: int,
    min_points: int = 6,
    table_size: int = 32768,
    lambda_diag: float = 1e-5,
    step_length: float = 0.2,
    max_step: float = 0.01,
    grid_factors=(2.0, 5.0),
    min_grid: float = 0.2,
    use_gravity: bool = False,
    use_odometry: bool = False,
):
    """The one-GN-step function for a keyframe map: step(params, flat_pts,
    flat_mask, flat_rings, aux) with params [6 (K-1)], the full point
    arrays [K * P, ...] on every member, aux = aux_from_data(data)."""
    if (n_keyframes * n_pts_per_kf) % mesh.size:
        raise ValueError("points must shard evenly")
    return sharded.make_sharded_step(
        mesh,
        make_transform(n_keyframes, n_pts_per_kf, mesh),
        min_points=min_points,
        table_size=table_size,
        lambda_diag=lambda_diag,
        step_length=step_length,
        max_step=max_step,
        grid_sizes=tuple(f * min_grid for f in grid_factors),
        extra_fn=make_extra_fn(n_keyframes, use_gravity, use_odometry),
    )


@functools.lru_cache(maxsize=8)
def _cached_optimize(mesh, n_keyframes, n_pts_per_kf, num_iter, min_points, table_size, lambda_diag, step_length,
                     max_step, epsilon, use_gravity, use_odometry, grid_factors):
    return sharded.make_sharded_optimize(
        mesh,
        make_transform(n_keyframes, n_pts_per_kf, mesh),
        num_iter=num_iter,
        min_points=min_points,
        table_size=table_size,
        lambda_diag=lambda_diag,
        step_length=step_length,
        max_step=max_step,
        epsilon=epsilon,
        extra_fn=make_extra_fn(n_keyframes, use_gravity, use_odometry),
        n_grids=len(grid_factors),
    )


def make_keyframe_dist_optimize(
    mesh: pmesh.Mesh,
    shapes: kfm.MapShapes,
    num_iter: int = 10,
    min_points: int = 6,
    table_size: int = 32768,
    lambda_diag: float = 1e-5,
    step_length: float = 0.2,
    max_step: float = 0.01,
    epsilon: float = 1e-5,
    use_gravity: bool = False,
    use_odometry: bool = False,
    grid_factors=(2.0, 5.0),
):
    """The distributed keyframe adjustment, built once per (mesh, shapes,
    settings) and reused across submaps.

    Returns opt(params0, flat_pts, flat_mask, flat_rings, aux, grid_sizes)
    -> (params, num_iters, final_error, num_cells); grid_sizes
    [len(grid_factors)] per call (min_grid * grid_factors)."""
    if not mesh.member:
        raise ValueError("this rank is not a member of the mesh")
    if (shapes.n_keyframes * shapes.n_pts_per_kf) % mesh.size:
        raise ValueError("points must shard evenly")
    return _cached_optimize(
        mesh, shapes.n_keyframes, shapes.n_pts_per_kf, num_iter, min_points, table_size, lambda_diag, step_length,
        max_step, epsilon, use_gravity, use_odometry, tuple(grid_factors),
    )


def flatten_problem(data: kfm.KeyframeMapData):
    """(flat_pts [K*P, 3], flat_mask, flat_rings, aux) from problem data."""
    flat_pts = data.local_pts.reshape(-1, 3)
    flat_mask = (data.pt_mask & data.kf_mask[:, None]).reshape(-1)
    flat_rings = data.pt_ring.reshape(-1)
    return flat_pts, flat_mask, flat_rings, aux_from_data(data)


def distributed_keyframe_optimize(
    mesh: pmesh.Mesh,
    data: kfm.KeyframeMapData,
    shapes: kfm.MapShapes,
    params0,
    num_iter: int = 10,
    min_grid: float = 0.2,
    grid_factors=(2.0, 5.0),
    use_gravity: bool = False,
    use_odometry: bool = False,
    **step_kwargs,
):
    """Run the distributed keyframe adjustment over `data` (builds or
    reuses the cached loop).  Returns (params, final_error)."""
    opt_fn = make_keyframe_dist_optimize(
        mesh, shapes, num_iter=num_iter, use_gravity=use_gravity, use_odometry=use_odometry,
        grid_factors=grid_factors, **step_kwargs,
    )
    flat_pts, flat_mask, flat_rings, aux = flatten_problem(data)
    grids = torch.tensor([f * min_grid for f in grid_factors], dtype=torch.float32, device=flat_pts.device)
    params, _, err, _ = opt_fn(params0, flat_pts, flat_mask, flat_rings, aux, grids)
    return params, err


def make_submap_optimizer(config, settings: opt.OptimSettings, mesh: pmesh.Mesh, shapes: kfm.MapShapes,
                          use_gravity: bool, use_odometry: bool):
    """The pipelines' distributed submap optimizer over `mesh` (this rank a
    member of it), for Config.dist_backend: parallel.spatial, or the hash
    backend of this module (its warning logged here, once per build).
    `settings` is the pipeline's keyframe OptimSettings: the iteration
    count, step, epsilon and grid factors come from it.

    Returns opt(params0, data: KeyframeMapData, min_grid) -> (params,
    overflow); min_grid a float or a card scalar; overflow, a card scalar,
    counts the points the spatial shuffle dropped (0 with the hash
    backend)."""
    factors = (settings.grid_size_1_factor, settings.grid_size_2_factor)
    common = dict(num_iter=settings.num_iter, min_points=settings.min_num_points_per_set,
                  step_length=settings.step_length_optim, max_step=settings.max_step, epsilon=settings.epsilon,
                  use_gravity=use_gravity, use_odometry=use_odometry, grid_factors=factors)
    is_spatial = config.dist_backend == "spatial"
    if is_spatial:
        run = spatial.make_spatial_dist_optimize(mesh, shapes, use_split=True, **common)
    else:
        log.warning(HASH_BACKEND_WARNING)
        run = make_keyframe_dist_optimize(mesh, shapes, table_size=config.dist_table_size, **common)

    def optimize(params0, data: kfm.KeyframeMapData, min_grid):
        flat_pts, flat_mask, flat_rings, aux = flatten_problem(data)
        g = torch.as_tensor(min_grid, dtype=torch.float32, device=flat_pts.device)
        grids = torch.stack([f * g for f in factors])
        if is_spatial:
            params, _, _, overflow = run(params0, flat_pts, flat_mask, flat_rings, aux, grids,
                                         flat_normals=data.local_normals.reshape(-1, 3))
            return params, overflow
        params = run(params0, flat_pts, flat_mask, flat_rings, aux, grids)[0]  # slot 3: cells, not overflow
        return params, torch.zeros((), dtype=torch.int64, device=params.device)

    return optimize
