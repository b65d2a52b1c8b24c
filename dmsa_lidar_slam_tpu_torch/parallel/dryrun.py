"""The multi-chip dry run of the distributed keyframe adjustment
(counterpart of the JAX package's __graft_entry__.py:66-217,
_flagship_keyframe_map and dryrun_multichip).

flagship_keyframe_map builds the flagship synthetic keyframe map: scans of
the room scene captured at known poses, with their true normals, plausible
gravity measurements and odometry priors, the problem class of
keyframeOptimization (reference: include/DMSA/DmsaSlam.h:212-238).  It
makes the same numpy draws from the same seed as the reference, so the
map is the reference's bit for bit.

dryrun_multichip runs both distributed backends over a mesh, on every
member, and holds each against the single-card optimizer on the same
problem: the hash backend (parallel.keyframe_dist) and the spatial one
(parallel.spatial, with the split channel of the map's normals: what both
pipelines run).  Each must bring the keyframe positions closer to the
truth than the start, land within PARITY_M of the single-card optimizer,
and the spatial shuffle must drop no point.
"""

import time

import numpy as np
import torch

from dmsa_lidar_slam_tpu_torch import convert
from dmsa_lidar_slam_tpu_torch.dmsa import optimizer as opt
from dmsa_lidar_slam_tpu_torch.io import synthetic as iosyn
from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
from dmsa_lidar_slam_tpu_torch.map.management import KeyframeMap
from dmsa_lidar_slam_tpu_torch.ops import cuda_lib
from dmsa_lidar_slam_tpu_torch.parallel import keyframe_dist, spatial
from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh

PARITY_M = 0.02  # keyframe positions, distributed vs single card (the reference's bound)
# the reference's dry-run settings (__graft_entry__.py:140-150, 177-187)
NUM_ITER, MIN_GRID = 6, 0.2
DIST_KW = dict(num_iter=NUM_ITER, min_points=6, step_length=0.3, max_step=0.1, use_gravity=True, use_odometry=True)


def flagship_keyframe_map(n_kf: int = 32, pts_per_kf: int = 2048, noise: float = 0.01, room_scale: float = 1.0,
                          device="cuda"):
    """(shapes, kf_map, rng): n_kf keyframes of pts_per_kf room points each,
    at known poses, with their true normals, gravity measurements and
    odometry priors; rng (seed 7) after the map's draws, for the caller's
    perturbation.  The map's problem goes to `device`."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(7)
    shapes = kfm.MapShapes(n_keyframes=n_kf, n_pts_per_kf=pts_per_kf)
    kf_map = KeyframeMap(shapes, device)
    planes = iosyn.room_scene(room_scale)
    for k in range(n_kf):
        pos = room_scale * np.array([-6.0 + 0.35 * k, -2.0 + 0.1 * k, 1.2])
        rv = np.array([0.0, 0.0, 0.1 + 0.04 * k])
        R = Rotation.from_rotvec(rv).as_matrix()
        world, world_nrm = iosyn.sample_scene_points(rng, pts_per_kf, planes=planes, return_normals=True)
        local = ((world - pos) @ R).astype(np.float32)
        local += rng.normal(scale=noise, size=local.shape).astype(np.float32)
        rng_norm = np.linalg.norm(local, axis=1)
        elev = np.arcsin(np.clip(local[:, 2] / np.maximum(rng_norm, 1e-9), -1, 1))
        rings = np.clip(((elev + np.pi / 4) / (np.pi / 2) * 16).astype(np.int32), 0, 15)
        # the true plane normals, keyframe-local: they drive the split
        # channel of the spatial backend's production configuration
        normals = (world_nrm @ R).astype(np.float32)
        g_meas = R.T @ np.asarray(kfm.GRAVITY_W) + rng.normal(scale=0.02, size=3)
        kf_map.add_keyframe(pos, rv, 1000.0 + k, local, normals, rings, 0.2, g_meas, True)
    return shapes, kf_map, rng


def flagship_problem(n_kf: int = 32, pts_per_kf: int = 2048, device="cuda"):
    """(shapes, data, params0, params_true) of the dry run: the flagship
    map's problem with the gravity and odometry terms, params0 the truth
    plus 0.01 of noise (0.003 on the rotations), as the reference draws
    it."""
    shapes, kf_map, rng = flagship_keyframe_map(n_kf, pts_per_kf, device=device)
    data, params_true = kf_map.to_problem_data(0, 1.0, 100.0)
    noise = rng.normal(scale=0.01, size=params_true.shape)
    noise[: 3 * (shapes.n_keyframes - 1)] *= 0.3
    params0 = torch.as_tensor(params_true + noise, dtype=torch.float64, device=data.local_pts.device)
    return shapes, data, params0, torch.as_tensor(params_true, dtype=torch.float64, device=params0.device)


def single_card_settings():
    """The reference dry run's single-chip settings (its autodiff path,
    no centralization, tangent blocks of 24)."""
    return opt.OptimSettings(num_iter=NUM_ITER, min_num_points_per_set=6, step_length_optim=0.3, max_step=0.1,
                             use_centralization=False, jacobian_chunk=24)


def backend_runs(mesh: pmesh.Mesh, shapes: kfm.MapShapes, data: kfm.KeyframeMapData, params0, grids,
                 table_size=None, **kwargs) -> dict:
    """{"hash": run, "spatial": run}: each distributed backend's
    optimisation of the problem over `mesh` as a call, with the optimizer
    keywords `kwargs`: the hash backend (parallel.keyframe_dist, at
    table_size slots where given) and the spatial one (parallel.spatial,
    with the split channel of the problem's normals)."""
    fp, fm, frs, aux = keyframe_dist.flatten_problem(data)
    hopt = keyframe_dist.make_keyframe_dist_optimize(
        mesh, shapes, **(kwargs if table_size is None else dict(kwargs, table_size=table_size)))
    sopt = spatial.make_spatial_dist_optimize(mesh, shapes, use_split=True, **kwargs)
    return {
        "hash": lambda: hopt(params0, fp, fm, frs, aux, grids),
        "spatial": lambda: sopt(params0, fp, fm, frs, aux, grids, flat_normals=data.local_normals.reshape(-1, 3)),
    }


def counted_collectives(run):
    """(run(), collectives): parallel.mesh's collective counter zeroed just
    before; collectives = dict(rows: the iteration loop's rows, setup: the
    rows outside it, iterations: the iterations run)."""
    pmesh.reset_collectives()
    res = run()
    return res, dict(rows=pmesh.collective_rows("iteration"), setup=pmesh.collective_rows(None),
                     iterations=pmesh.SCOPES.get("iteration", 0))


def dryrun_multichip(mesh: pmesh.Mesh, n_kf: int = 32, pts_per_kf: int = 2048, device="cuda") -> dict:
    """Both distributed backends over `mesh` (every member calls this)
    against the single-card optimizer on the flagship problem.  The
    single-card run is the mesh's first rank's, replicated to the others.
    Raises if a check fails; returns the keyframe position errors (RMS, m),
    the parities (largest keyframe distance, m), cells, iterations and
    overflow, each backend's parameters (for the caller's comparison of
    the ranks) and the collectives each backend issued on this rank
    (parallel.mesh's counter, zeroed before each: rows of the iteration
    loop and outside it, iterations run)."""
    shapes, data, params0, params_true = flagship_problem(n_kf, pts_per_kf, device)
    n_total = shapes.n_keyframes * shapes.n_pts_per_kf
    if n_total % mesh.size:
        raise ValueError(f"{n_total} points do not shard evenly over {mesh.size} ranks")
    grids = torch.tensor([2.0 * MIN_GRID, 5.0 * MIN_GRID], dtype=torch.float32, device=params0.device)
    runs = backend_runs(mesh, shapes, data, params0, grids, **DIST_KW)
    (p_hash, iters, _, ncells), hash_coll = counted_collectives(runs["hash"])
    (p_sp, _, ncells_sp, overflow), sp_coll = counted_collectives(runs["spatial"])
    collectives = dict(hash=hash_coll, spatial=sp_coll)

    # the single-card reference (exact sorted cells), on the first rank
    if mesh.rank == 0:
        fwd = kfm.make_forward(shapes, True, True, True)
        p_single = opt.optimize(fwd, params0, data, single_card_settings(), MIN_GRID).params
    else:
        p_single = torch.empty_like(params0)
    p_single = pmesh.replicated(mesh, p_single)

    def positions(params):
        return kfm.global_chain(params, data, shapes)[1].transl

    def rms(params):
        return float(torch.sqrt(torch.mean(torch.sum((positions(params) - positions(params_true)) ** 2, dim=1))))

    def parity(params):
        return float(torch.max(torch.linalg.norm(positions(params) - positions(p_single), dim=1)))

    out = dict(keyframes=shapes.n_keyframes, points=n_total, params=params0.shape[0], ranks=mesh.size,
               err_start_m=rms(params0), err_single_m=rms(p_single), err_hash_m=rms(p_hash),
               err_spatial_m=rms(p_sp), parity_hash_m=parity(p_hash), parity_spatial_m=parity(p_sp),
               cells_hash=int(ncells), iterations_hash=int(iters), cells_spatial=int(ncells_sp),
               overflow=int(overflow), parity_bound_m=PARITY_M)
    assert bool(p_hash.isfinite().all()) and bool(p_sp.isfinite().all()), "non-finite parameters"
    assert out["err_hash_m"] < out["err_start_m"], f"hash backend did not improve: {out}"
    assert out["parity_hash_m"] < PARITY_M, f"hash backend parity {out['parity_hash_m']} m above {PARITY_M}"
    assert out["overflow"] == 0, f"spatial shuffle overflow {out['overflow']}"
    assert out["err_spatial_m"] < out["err_start_m"], f"spatial backend did not improve: {out}"
    assert out["parity_spatial_m"] < PARITY_M, f"spatial parity {out['parity_spatial_m']} m above {PARITY_M}"
    out.update(params_hash=p_hash.cpu(), params_spatial=p_sp.cpu(), collectives=collectives)
    return out


# --------------------------------------------------------------------------
# rank functions (parallel.launch.Ranks): fn(rank, world, device, *args)
# --------------------------------------------------------------------------


def collective_counts(rank, world, device, data: kfm.KeyframeMapData, params0, grids, num_iter: int,
                      min_points: int, table_size: int) -> dict:
    """Both backends on the problem (data's fields and params0 as numpy
    arrays or CPU tensors, taken to `device`) over the full mesh, each with
    the collective counter zeroed just before (counted_collectives):
    {backend: collectives, with wall_s, the run's wall time}."""
    data = convert.map_data_from_numpy(data, device)
    shapes = kfm.MapShapes(*data.local_pts.shape[:2])
    params0 = torch.as_tensor(params0, dtype=torch.float64, device=device)
    grids = torch.tensor(grids, dtype=torch.float32, device=device)
    runs = backend_runs(pmesh.make_mesh(), shapes, data, params0, grids, table_size=table_size, num_iter=num_iter,
                        min_points=min_points)
    out = {}
    for name, run in runs.items():
        t0 = time.perf_counter()
        _, out[name] = counted_collectives(run)
        out[name]["wall_s"] = time.perf_counter() - t0
    return out


def dryrun_rank(rank, world, device, n_kf: int, pts_per_kf: int) -> dict:
    """dryrun_multichip over the full mesh at n_kf x pts_per_kf, the kernel
    launch counters zeroed just before and read just after (the card
    synchronised on both sides): its dict with mesh (size, rank, backend),
    wall_s and launches (ops.cuda_lib.launch_counts)."""
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        cuda_lib.library()  # loaded (or built) before the timed run
    mesh = pmesh.make_mesh()
    sync()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    out = dryrun_multichip(mesh, n_kf, pts_per_kf, device=device)
    sync()
    out.update(mesh=(mesh.size, mesh.rank, mesh.backend), wall_s=time.perf_counter() - t0,
               launches=cuda_lib.launch_counts())
    return out
