"""The submap problem of K7's tests and chip_smoke.py's K7 rows (no jax):
keyframe_problem builds a submap's shapes, data and params in one of the
regimes whose branches K7 mirrors; scene_submap one whose keyframes see a
room, for a solve; FLAGS the four combinations of the gravity and
odometry terms.  tests/torch_window.py's candidates,
check_tables and check_batch serve both pose-table kernels."""

import numpy as np
import torch

from dmsa_lidar_slam_tpu_torch.core import poses as cp
from dmsa_lidar_slam_tpu_torch.core import rotations as rot
from dmsa_lidar_slam_tpu_torch.io.synthetic import room_scene, sample_scene_points
from dmsa_lidar_slam_tpu_torch.map import keyframes as kfm

REGIMES = ("random", "zero_rotation", "identity", "across_pi", "inactive", "implausible")
FLAGS = ((True, False), (True, True), (False, True), (False, False))  # (use_gravity, use_odometry)


def keyframe_problem(seed, regime="random", s=48, ppk=64, device="cpu"):
    """(shapes, data, params [6 (s - 1)]) of a submap of s keyframes in
    `regime`; params and data in f64 as the fused step holds them.

      random         keyframes ~0.5 m and ~0.05 rad apart, every term active
      zero_rotation  relative orientations 0 (axang2quat's series)
      identity       the anchor's and every relative orientation 0, and the
                     odometry priors' (quat2axang's small-|v| branch, the
                     series of axang2quat and axang2rotm, rotm2quat's w pivot)
      across_pi      global orientations passing pi about x (quat2axang's
                     sign), odometry priors up to ~3 rad off (rotm2quat's
                     x, y and z pivots)
      inactive       the last third of the ring empty (kf_mask), as
                     device_map.submap_view_capped pads a short ring
      implausible    half the gravity measurements implausible

    Gravity measurements and odometry priors lie near the truth with noise,
    so no residual sits at sqrt's kink."""
    rng = np.random.default_rng(seed)
    e = s - 1
    anchor_o = 0.4 * rng.standard_normal(3)
    orient = 0.05 * rng.standard_normal((e, 3))
    transl = 0.3 * rng.standard_normal((e, 3)) + np.array([0.5, 0.0, 0.0])
    if regime in ("zero_rotation", "identity"):
        orient[:] = 0.0
    if regime == "identity":
        anchor_o[:] = 0.0
    if regime == "across_pi":
        anchor_o = np.array([3.0, 0.0, 0.0])
        orient[:] = [0.06, 0.0, 0.0]
    params = np.concatenate([orient.ravel(), transl.ravel()])
    f64 = dict(dtype=torch.float64, device=device)

    def t64(x):
        return torch.as_tensor(np.asarray(x), **f64)

    shapes = kfm.MapShapes(n_keyframes=s, n_pts_per_kf=ppk)
    rel_o = torch.as_tensor(np.concatenate([anchor_o[None], orient]))
    g_orient = cp.relative2global(cp.PoseChain(orient=rel_o, transl=torch.zeros_like(rel_o))).orient
    grav = np.asarray(kfm.GRAVITY_W)
    grav_meas = np.einsum("kji,j->ki", rot.axang2rotm(g_orient).numpy(), grav) + 0.05 * rng.standard_normal((s, 3))
    odom_o = np.concatenate([np.zeros((1, 3)), orient + 0.01 * rng.standard_normal((e, 3))])
    if regime == "identity":
        odom_o[:] = 0.0
    if regime == "across_pi":
        odom_o[1:] = rng.uniform(-1.8, 1.8, (e, 3))
    odom_t = np.concatenate([np.zeros((1, 3)), transl + 0.02 * rng.standard_normal((e, 3))])
    kf_mask = np.ones(s, dtype=bool)
    if regime == "inactive":
        kf_mask[s - max(1, s // 3):] = False
    plausible = np.ones(s, dtype=bool)
    if regime == "implausible":
        plausible[rng.permutation(s)[: s // 2]] = False
    data = kfm.KeyframeMapData(
        local_pts=torch.as_tensor(rng.standard_normal((s, ppk, 3)), dtype=torch.float32, device=device),
        local_normals=torch.as_tensor(rng.standard_normal((s, ppk, 3)), dtype=torch.float32, device=device),
        pt_mask=torch.as_tensor(rng.uniform(size=(s, ppk)) < 0.9, device=device),
        pt_ring=torch.as_tensor(rng.integers(0, 16, (s, ppk)), dtype=torch.int32, device=device),
        grid_size=torch.full((s,), 0.5, dtype=torch.float32, device=device),
        kf_mask=torch.as_tensor(kf_mask, device=device),
        anchor_orient=t64(anchor_o),
        anchor_transl=t64(rng.standard_normal(3)),
        stamps=t64(np.arange(s) * 0.4),
        grav_meas=t64(grav_meas),
        grav_plausible=torch.as_tensor(plausible, device=device),
        odom_rel_transl=t64(odom_t),
        odom_rel_orient=t64(odom_o),
        gravity=t64(grav),
        cov_grav_inv=t64(np.linalg.inv(kfm.STD_DEV_ACC**2 * np.eye(3))),
        odom_transl_cov_inv=t64(np.linalg.inv(kfm.ODOM_STD**2 * np.eye(3))),
        odom_orient_cov_inv=t64(np.linalg.inv(kfm.ODOM_STD**2 * np.eye(3))),
        balancing_grav=t64(0.1),
        balancing_odom=t64(0.01),
    )
    return shapes, data, t64(params)


def to_device(data, device):
    return kfm.KeyframeMapData(*(x.to(device) for x in data))


def scene_submap(seed, s=5, ppk=600, device="cpu"):
    """A submap of room points (scaled room, enough cells for P = 6 (s - 1))
    seen from the tables at known params, and params perturbed from them."""
    shapes, data, params = keyframe_problem(seed, s=s, ppk=ppk)
    rng = np.random.default_rng(seed)
    world = torch.as_tensor(sample_scene_points(rng, s * ppk, planes=room_scene(0.45)), dtype=torch.float32)
    world = world + 0.005 * torch.as_tensor(rng.standard_normal(world.shape), dtype=torch.float32)
    tab, _ = kfm._kf_tables(params, data, shapes, True, True)
    tidx = torch.arange(s).repeat_interleave(ppk)
    q = tab[tidx, 0:4]
    local = rot.quat_rotate(torch.cat([q[:, :1], -q[:, 1:]], dim=1), world - tab[tidx, 4:7])
    data = data._replace(local_pts=local.reshape(s, ppk, 3), pt_mask=torch.ones(s, ppk, dtype=torch.bool))
    params0 = params + 0.004 * torch.as_tensor(rng.standard_normal(params.shape[0]))
    return shapes, to_device(data, device), params0.to(device)
