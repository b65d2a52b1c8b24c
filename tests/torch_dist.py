"""Run a function on N gloo ranks on the CPU, for the port's distributed
tests (tests/test_torch_parallel_*.py and the dry-run and collective
tests), and the rank functions they run.

The ranks are the port's own (parallel/launch.py's Ranks, which the
multi-chip tools and chip_smoke.py use too): processes started with the
spawn method, each importing torch, the port and this module only (never
jax, never tests/conftest.py), joined over gloo through a file store in
the caller's temporary directory (no TCP port, so tests under
pytest-xdist cannot race), running fn(rank, world, device, *args) with
device "cpu".  Ranks joins them with a timeout of its own, so a rank that
hangs fails its test instead of the suite; a rank that raises fails the
run, and the others are stopped.  Inputs are numpy arrays made by the
caller, so every rank sees the same problem.  Tier-1 runs pytest with
several workers, so torch keeps to one thread here and in every rank.
"""

import dataclasses
import functools
import os

import numpy as np
import torch

from dmsa_lidar_slam_tpu_torch.parallel import launch

torch.set_num_threads(1)

TIMEOUT_S = 150.0  # one multi-rank run, start-up included


# `world` CPU ranks running fn(rank, world, "cpu", *args): Ranks starts
# them and the caller may work meanwhile, then reads results(); run_ranks
# waits for them
Ranks = functools.partial(launch.Ranks, device="cpu", timeout_s=TIMEOUT_S)
run_ranks = functools.partial(launch.run_local_ranks, device="cpu", timeout_s=TIMEOUT_S)


# --------------------------------------------------------------------------
# problems (numpy, from a seed), shared by the tests and the rank functions
# --------------------------------------------------------------------------


def keyframe_problem(seed: int, s: int = 4, ppk: int = 512, with_normals: bool = False, extras: bool = False,
                     shared: bool = True, pose_noise=None):
    """tests/test_spatial_dist.py's _make_problem as numpy: s keyframes
    seeing the room scene (all the same ppk points when `shared`, else a
    sample each with 5 mm of noise), true poses 0.05 rad / 0.4 m steps,
    params0 the truth plus 0.03 of noise on every relative parameter, or,
    with pose_noise = (rad, m), the truth's global poses each perturbed by
    that much.  With `extras`, plausible gravity measurements and odometry
    priors at the truth, with the pipelines' covariances.  Returns (data:
    dict of the KeyframeMapData fields, params0, params_true), float64
    poses."""
    from scipy.spatial.transform import Rotation

    from dmsa_lidar_slam_tpu_torch.core import poses as cp
    from dmsa_lidar_slam_tpu_torch.io.synthetic import sample_scene_points

    rng = np.random.default_rng(seed)

    def sample():
        if with_normals:
            return sample_scene_points(rng, ppk, return_normals=True)
        return sample_scene_points(rng, ppk), np.zeros((ppk, 3))

    pts, world_nrm = sample()
    rings = rng.integers(0, 8, size=ppk).astype(np.int32)
    local = np.zeros((s, ppk, 3), np.float32)
    normals = np.zeros((s, ppk, 3), np.float32)
    true_o = 0.05 * rng.standard_normal((s, 3))
    true_t = np.cumsum(0.4 * rng.standard_normal((s, 3)), axis=0)
    grav = np.zeros((s, 3))
    for k in range(s):
        if not shared and k:
            pts, world_nrm = sample()
            pts = pts + 0.005 * rng.standard_normal(pts.shape)
        R = Rotation.from_rotvec(true_o[k]).as_matrix()
        local[k] = (pts.astype(np.float32) - true_t[k]) @ R
        grav[k] = R.T @ np.array([0.0, 0.0, -9.805])
        normals[k] = (world_nrm @ R).astype(np.float32)

    def params_of(orient, transl):
        gp = cp.GlobalPoses(orient=torch.as_tensor(orient), transl=torch.as_tensor(transl))
        return cp.global2relative(gp), cp.params_from_chain(cp.global2relative(gp)).numpy()

    chain, params_true = params_of(true_o, true_t)
    if pose_noise is None:
        params0 = params_true + 0.03 * rng.standard_normal(params_true.shape)
    else:
        noisy_o = true_o + pose_noise[0] * rng.standard_normal((s, 3))
        noisy_t = true_t + pose_noise[1] * rng.standard_normal((s, 3))
        noisy_o[0], noisy_t[0] = true_o[0], true_t[0]  # the anchor stays
        params0 = params_of(noisy_o, noisy_t)[1]
    data = dict(
        local_pts=local,
        local_normals=normals,
        pt_mask=np.ones((s, ppk), bool),
        pt_ring=np.stack([rings] * s),
        grid_size=np.full((s,), 0.25, np.float32),
        kf_mask=np.ones((s,), bool),
        anchor_orient=true_o[0].copy(),
        anchor_transl=true_t[0].copy(),
        stamps=np.arange(s, dtype=np.float64),
        grav_meas=grav + (0.02 * rng.standard_normal((s, 3)) if extras else 0.0),
        grav_plausible=np.full((s,), extras),
        odom_rel_transl=chain.transl.numpy(),
        odom_rel_orient=chain.orient.numpy(),
        gravity=np.array([0.0, 0.0, -9.805]),
        cov_grav_inv=np.eye(3) / 0.3**2,
        odom_transl_cov_inv=np.eye(3) / 0.01**2,
        odom_orient_cov_inv=np.eye(3) / 0.01**2,
        balancing_grav=np.asarray(1.0 if extras else 0.0),
        balancing_odom=np.asarray(1.0 if extras else 0.0),
    )
    return data, params0, params_true


def as_port(data: dict, device="cpu"):
    from dmsa_lidar_slam_tpu_torch import convert
    from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm

    return convert.map_data_from_numpy(kfm.KeyframeMapData(**data), device=device)


# --------------------------------------------------------------------------
# rank functions
# --------------------------------------------------------------------------


def shuffle_and_elect(rank, world, device, pts, mask, grid, small_cap, table_size):
    """On this rank's shard of (pts, mask), with the grid as an f32 scalar:
    the owner shuffle of the points themselves over the full mesh and over
    the 2-rank subgroup of ranks 0 and 1 at the default bucket cap
    (received rows, their mask, the overflow over the mesh), the same over
    the full mesh at a small cap, and the slot owners' keep mask (hash
    backend)."""
    from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh
    from dmsa_lidar_slam_tpu_torch.parallel import sharded, spatial

    full = pmesh.make_mesh()
    pair = pmesh.make_mesh(ranks=[0, 1])
    p, m, g = torch.as_tensor(pts), torch.as_tensor(mask), torch.tensor(grid, dtype=torch.float32)
    out = dict(mesh=(full.ranks, full.rank, full.backend, pair.ranks, pair.rank))
    n = len(pts)
    for name, mesh, c in (("full", full, spatial.bucket_cap(n, full.size)),
                          ("pair", pair, spatial.bucket_cap(n, pair.size)), ("small_cap", full, small_cap)):
        if mesh.member:
            lp, lm = pmesh.shard_leading(mesh, p), pmesh.shard_leading(mesh, m)
            owner = spatial.owner_of_voxels(lp, lm, g, mesh.size)
            recv, rmask, ov = spatial.shuffle_to_owners(lp, owner, mesh.size, c, mesh)
            out[name] = dict(recv=recv, rmask=rmask, overflow=int(pmesh.psum(ov, mesh)))
    lp, lm = pmesh.shard_leading(full, p), pmesh.shard_leading(full, m)
    out["keep"] = sharded.elect_slot_owners(lp, lm, sharded.hash_cell_ids(lp, lm, g, table_size), g, table_size, full)
    # the 2 x 2 grid: each rank's data and model meshes, a psum over each,
    # and the model mesh's first rank's value replicated over it
    grid = pmesh.make_mesh_2d(2, 2)
    mine = torch.tensor([float(rank)])
    out["grid"] = [(m.ranks, m.rank, float(pmesh.psum(mine, m)), float(pmesh.replicated(m, mine)))
                   for m in (grid.data, grid.model)]
    return out


def spatial_cases(rank, world, device, cases):
    """The spatial optimizer on each case: {name: (data, params0,
    use_split, kwargs)} -> {name: (params, err, cells, overflow)}; and, for
    the first case, the keys of the cells each rank builds (voxel key and
    split channel of every received point at each grid)."""
    from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
    from dmsa_lidar_slam_tpu_torch.ops import voxel
    from dmsa_lidar_slam_tpu_torch.parallel import keyframe_dist, spatial
    from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh()
    out = {}
    for name, (data, params0, use_split, kwargs) in cases.items():
        d = as_port(data)
        s, ppk = d.local_pts.shape[:2]
        sopt = spatial.make_spatial_dist_optimize(mesh, kfm.MapShapes(s, ppk), use_split=use_split, **kwargs)
        fp, fm, frs, aux = keyframe_dist.flatten_problem(d)
        grids = torch.tensor([0.5, 1.25])
        res = sopt(torch.as_tensor(params0), fp, fm, frs, aux, grids, flat_normals=d.local_normals.reshape(-1, 3))
        out[name] = tuple(x.clone() for x in res)
        if "keys" not in out:
            # the cells of the initial iteration: every received point's
            # exact voxel key, as K1 keys it
            tab, _ = kfm.make_tabular(kfm.MapShapes(s, ppk), False, False).tables(torch.as_tensor(params0), aux)
            tidx = torch.arange(s).repeat_interleave(ppk)
            xs, lm, lt = (pmesh.shard_leading(mesh, x) for x in (fp, fm, tidx))
            world_pts = spatial.world_points(tab, xs, lt)
            cap = spatial.bucket_cap(s * ppk, mesh.size)
            keys = []
            for g in grids:
                owner = spatial.owner_of_voxels(world_pts, lm, g, mesh.size)
                recv, rmask, _ = spatial.shuffle_to_owners(torch.cat([xs, lt[:, None].float()], 1), owner,
                                                           mesh.size, cap, mesh)
                rw = spatial.world_points(tab, recv[:, :3].contiguous(), recv[:, 3].long())
                keys.append(torch.unique(voxel.combined_key(*voxel.voxel_keys(rw, rmask, g))[rmask]))
            out["keys"] = keys
    return out


def hash_optimize(rank, world, device, data, params0, runs):
    """The hash backend (keyframe_dist.distributed_keyframe_optimize) over
    the mesh of the ranks among which the points divide evenly, once per
    keyword set in `runs`; the ranks left out take each result by
    broadcast.  Returns (mesh size, [params of each run])."""
    from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm
    from dmsa_lidar_slam_tpu_torch.parallel import keyframe_dist, launch
    from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh

    d = as_port(data)
    s, ppk = d.local_pts.shape[:2]
    mesh = launch.global_keyframe_mesh(n_points=s * ppk)
    out = []
    for kwargs in runs:
        params = torch.as_tensor(params0)
        if mesh.member:
            params, _ = keyframe_dist.distributed_keyframe_optimize(mesh, d, kfm.MapShapes(s, ppk), params, **kwargs)
        out.append(pmesh.broadcast_from_mesh(mesh, params))
    return mesh.size, out


def pipeline_runs(rank, world, device, config: dict, n_scans: int, pts: int, runner_overrides: dict, out_dirs):
    """FusedDmsaSlam and DmsaSlam with the flag on, over n_scans of the
    port's test sequence (seed 11) on every rank, then the CLI runner with
    the flag over a bag, each rank told to write into out_dirs[rank].
    Returns each pipeline's keyframes, its mesh size and max submap span,
    and the files in this rank's directory."""
    from dmsa_lidar_slam_tpu_torch.config import Config
    from dmsa_lidar_slam_tpu_torch.pipeline import runner
    from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam
    from dmsa_lidar_slam_tpu_torch.pipeline.slam import DmsaSlam

    out = {}
    for name, cls in (("fused", FusedDmsaSlam), ("host", DmsaSlam)):
        slam = cls(Config(**config), device="cpu")
        drive(slam, n_scans, pts)
        mesh = slam.mesh if name == "fused" else slam._dist_kf_mesh
        out[name] = dict(keyframes=keyframes(slam), mesh_size=mesh.size,
                         max_submap_span=getattr(slam, "max_submap_span", None),
                         shuffle_overflow=getattr(slam, "shuffle_overflow", None))
    runner.run([], overrides=dict(runner_overrides, result_dir=out_dirs[rank]), pipeline="host", device="cpu")
    out["files"] = sorted(os.listdir(out_dirs[rank]))
    return out


def drive(slam, n_scans: int, pts: int, seed: int = 11):
    """tests/test_torch_fused.py's drive: each scan's IMU, then the scan."""
    from dmsa_lidar_slam_tpu_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(rng=np.random.default_rng(seed), noise_std=0.01, room_scale=0.45)
    imu_cursor = seq.t_start - 0.2
    for i in range(n_scans):
        t_end = seq.t_start + (i + 1) * seq.sweep
        ts, acc, gyr = seq.imu_samples(imu_cursor, t_end)
        slam.process_imu_batch(acc, gyr, ts)
        imu_cursor = t_end
        slam.process_scan(*seq.scan(i, pts))
    if hasattr(slam, "_flush_events"):
        slam._flush_events()
    return seq


def keyframes(slam):
    """(positions [n, 3], orientations [n, 3]) of either pipeline's
    keyframes."""
    if hasattr(slam, "kf_map"):
        n = slam.kf_map.count
        return slam.kf_map.transl_w[:n].copy(), slam.kf_map.orient_w[:n].copy()
    _, transl, orient = slam.keyframe_poses()
    return transl, orient


def config_dict(cfg) -> dict:
    """A Config of either package as the port's Config's keyword arguments
    (a rank must not unpickle the reference's Config: that imports jax)."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}

