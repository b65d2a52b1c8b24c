"""The benchmark's traffic generator: a frozen copy of the synthetic
LiDAR-inertial sequence of dmsa_lidar_slam_tpu_torch/io/synthetic.py (the
room scene, SyntheticSequence), with the JAX package's bench.py stream
helpers (pregenerate, apply_long_stressors) and one entry point that a
traffic file drives.

A room scene (20 x 14 x 4 m, two boxes) is sampled as spinning-LiDAR scans:
points drawn uniformly on the surfaces, ring ids from elevation, per-point
azimuth stamps, motion distortion along an analytic trajectory, plus IMU
samples consistent with the motion, with noise and biases.  It samples the
surfaces and casts no rays: no occlusion, no range limit.

The sensor rig (Rig, from a configuration file by `rig`): the analytic pose
is the IMU's (the body frame the program estimates); points are emitted in
the LiDAR frame through the LiDAR-to-IMU extrinsic; a vertical field and a
ring table select and label them; the accelerometer may read in g.  A
configuration without those keys gives the identity rig and the streams
of before, bit for bit.
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

GRAVITY = np.array([0.0, 0.0, -9.805])
G_UNIT = 9.81  # m/s^2 a reading in g stands for: what the program multiplies it back by (pipeline/fused.py)


class Rig(NamedTuple):
    """A sensor rig.  R_l2i, t_l2i: the LiDAR frame in the IMU frame,
    p_imu = R_l2i p_lidar + t_l2i.  ring_elev (rad, one entry a ring id) and
    fov (rad, lo <= elevation <= hi): None for rings binned over +-45
    degrees and every point kept.  acc_in_g: the accelerometer reads in g."""

    R_l2i: np.ndarray
    t_l2i: np.ndarray
    ring_elev: Optional[np.ndarray] = None
    fov: Optional[Tuple[float, float]] = None
    acc_in_g: bool = False


IDENTITY_RIG = Rig(np.eye(3), np.zeros(3))


def rig(cfg: dict) -> Rig:
    """The rig of a configuration file: the extrinsic and the IMU's units from
    its "pipeline" keys, as the program reads them (lidar_to_imu_quat as w, x,
    y, z; lidar_to_imu_transl; acceleration_in_g), so the stream and the
    program cannot disagree; the field and rings from its "stream" keys:
    ring_elevations_deg (one entry a ring), or vertical_fov_deg [lo, hi] with
    `rings` rings spaced evenly from lo to hi; the field of a table alone
    spans its entries."""
    st, pl = cfg["stream"], cfg["pipeline"]
    w, x, y, z = pl.get("lidar_to_imu_quat", (1.0, 0.0, 0.0, 0.0))
    R = Rotation.from_quat([x, y, z, w]).as_matrix()  # scipy's order is x, y, z, w
    t = np.asarray(pl.get("lidar_to_imu_transl", (0.0, 0.0, 0.0)), dtype=np.float64)
    table, fov = st.get("ring_elevations_deg"), st.get("vertical_fov_deg")
    if table is not None:
        table = np.deg2rad(np.asarray(table, dtype=np.float64))
        if len(table) != st["rings"]:
            raise ValueError(f"ring_elevations_deg has {len(table)} entries, the stream {st['rings']} rings")
    elif fov is not None:
        table = np.deg2rad(np.linspace(fov[0], fov[1], st["rings"]))
    if fov is not None:
        fov = (float(np.deg2rad(fov[0])), float(np.deg2rad(fov[1])))
    elif table is not None:
        fov = (float(table.min()), float(table.max()))
    return Rig(R, t, table, fov, bool(pl.get("acceleration_in_g", False)))


def elevation(local):
    """Each point's elevation above the sensor's xy plane, rad."""
    rng_norm = np.linalg.norm(local, axis=1)
    return np.arcsin(np.clip(local[:, 2] / np.maximum(rng_norm, 1e-9), -1, 1))


def nearest_ring(elev, table):
    """The index of the entry of `table` nearest to each elevation."""
    order = np.argsort(table, kind="stable")
    srt = table[order]
    i = np.clip(np.searchsorted(srt, elev), 1, len(srt) - 1)
    lower = elev - srt[i - 1] <= srt[i] - elev
    return order[np.where(lower, i - 1, i)].astype(np.int32)


def room_scene(scale: float = 1.0):
    """Plane list [(point, normal, extent_u, extent_v)]: a 20x14x4 room with
    two interior boxes, optionally scaled (small rooms make the adaptive
    preprocessing ladder pick fine grids at small test point budgets)."""
    planes = []

    def add_box(center, size):
        cx, cy, cz = center
        sx, sy, sz = size
        planes.extend(
            [
                ((cx - sx / 2, cy, cz), (-1, 0, 0), sy / 2, sz / 2),
                ((cx + sx / 2, cy, cz), (1, 0, 0), sy / 2, sz / 2),
                ((cx, cy - sy / 2, cz), (0, -1, 0), sx / 2, sz / 2),
                ((cx, cy + sy / 2, cz), (0, 1, 0), sx / 2, sz / 2),
                ((cx, cy, cz + sz / 2), (0, 0, 1), sx / 2, sy / 2),
            ]
        )

    planes.append(((0, 0, 0), (0, 0, 1), 10, 7))
    planes.append(((0, 0, 4), (0, 0, -1), 10, 7))
    planes.append(((-10, 0, 2), (1, 0, 0), 7, 2))
    planes.append(((10, 0, 2), (-1, 0, 0), 7, 2))
    planes.append(((0, -7, 2), (0, 1, 0), 10, 2))
    planes.append(((0, 7, 2), (0, -1, 0), 10, 2))
    add_box((4, 2, 0.75), (1.5, 1.5, 1.5))
    add_box((-3, -3, 1.0), (2.0, 1.0, 2.0))
    if scale != 1.0:
        planes = [
            (tuple(scale * np.asarray(p0)), nrm, scale * eu, scale * ev)
            for (p0, nrm, eu, ev) in planes
        ]
    return planes


def _plane_frame(normal):
    n = np.asarray(normal, dtype=float)
    n = n / np.linalg.norm(n)
    a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    u = np.cross(n, a)
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    return u, v


def sample_scene_points(rng, n_points, planes=None, return_normals=False):
    planes = planes or room_scene()
    areas = np.array([4.0 * eu * ev for (_, _, eu, ev) in planes])
    counts = rng.multinomial(n_points, areas / areas.sum())
    pts, nrms = [], []
    for (p0, nrm, eu, ev), c in zip(planes, counts):
        u, v = _plane_frame(nrm)
        uu = rng.uniform(-eu, eu, size=c)
        vv = rng.uniform(-ev, ev, size=c)
        pts.append(np.asarray(p0)[None, :] + uu[:, None] * u[None, :] + vv[:, None] * v[None, :])
        nrms.append(np.broadcast_to(np.asarray(nrm, float), (c, 3)))
    pts = np.concatenate(pts, axis=0)
    perm = rng.permutation(len(pts))
    if return_normals:
        return pts[perm], np.concatenate(nrms, axis=0)[perm]
    return pts[perm]


class TruePose(NamedTuple):
    position: np.ndarray
    rotvec: np.ndarray


class SyntheticSequence:
    """Ramped-twist trajectory with scans + IMU.

    The platform stays AT REST for `t_still` data-seconds, then ramps
    linearly to (v_lin, yaw_rate) over `t_ramp` seconds — like real
    handheld/robot datasets, whose static start is what makes the
    reference's init stack viable (gyro bias and gravity direction are
    both estimated from the first IMU samples under a static-start
    assumption, ImuBuffer.h:59-63 / ContinuousTrajectory.h:263-299; IMU
    before the first scan is dropped, DmsaSlam.h:104-107, so the still
    phase must cover the first scans, not just precede them).
    pose(t): the body's (IMU's) pose; position integrates v(t) (world),
    orientation is yaw about z, then pitch about y, then roll about x
    (R = Rz Ry Rx; yaw alone unless a roll or pitch key is set).
    IMU, at the body's origin: body rates w_B, accel = R^T * (a_world - g).
    Points: in the LiDAR frame of `rig` at their stamps.
    """

    def __init__(
        self,
        rng: Optional[np.random.Generator] = None,
        v_lin=(1.2, 0.4, 0.0),
        yaw_rate: float = 0.4,
        p0=(-4.0, -1.0, 1.2),
        yaw0: float = 0.15,
        sweep: float = 0.1,
        t_start: float = 1000.0,
        t_ramp: float = 1.0,
        t_still: float = 0.0,
        noise_std: float = 0.0,
        room_scale: float = 1.0,
        mode: str = "twist",
        loop_amp=(6.0, 4.0, 0.3),
        loop_omega: float = 0.35,
        imu_noise_acc: float = 0.0,
        imu_noise_gyr: float = 0.0,
        imu_bias_acc=(0.0, 0.0, 0.0),
        imu_bias_gyr=(0.0, 0.0, 0.0),
        yaw_wobble=(0.0, 0.0),
        roll0: float = 0.0,
        roll_wobble=(0.0, 0.0, 0.0),
        pitch_wobble=(0.0, 0.0, 0.0),
        rig: Rig = IDENTITY_RIG,
    ):
        self.rng = rng or np.random.default_rng(0)
        self.v_lin = np.asarray(v_lin, float) * room_scale
        self.yaw_rate = yaw_rate
        self.p0 = np.asarray(p0, float) * room_scale
        self.yaw0 = yaw0
        self.sweep = sweep
        self.t_start = t_start
        self.t_ramp = t_ramp
        self.t_still = t_still
        self.noise_std = noise_std
        self.planes = room_scene(room_scale)
        # trajectory mode: "twist" = constant-twist ramp (r1-r3 behavior);
        # "loop" = closed Lissajous circuit that LEAVES and RE-ENTERS mapped
        # space (keyframe retirement + deep minRelatedKeyId submap spans,
        # DmsaSlam.h:212-238) — period 2*pi/loop_omega progress-seconds
        self.mode = mode
        self.loop_amp = np.asarray(loop_amp, float) * room_scale
        self.loop_omega = loop_omega
        # IMU imperfections (VERDICT r3 #3: the analytic IMU was noise- and
        # bias-free, so the static-start estimators were only validated in
        # the regime where they have nothing to do)
        self.imu_noise_acc = imu_noise_acc
        self.imu_noise_gyr = imu_noise_gyr
        self.imu_bias_acc = np.asarray(imu_bias_acc, float)
        self.imu_bias_gyr = np.asarray(imu_bias_gyr, float)
        # (amplitude rad, frequency rad/progress-s): sinusoidal yaw term on
        # top of the constant yaw rate — periodic ROTATION-DOMINANT
        # stretches where the angular rate doubles while translation is
        # unchanged (VERDICT r4 #6: aggressive rotation was untested)
        self.yaw_wobble = (float(yaw_wobble[0]), float(yaw_wobble[1]))
        # roll: a constant (a rig mounted upside down); roll and pitch:
        # (amplitude rad, frequency rad/progress-s[, phase rad]) of sway, as
        # a handheld rig moves
        self.roll0 = float(roll0)
        self.roll_wobble = tuple(float(v) for v in roll_wobble) + (0.0,) * (3 - len(roll_wobble))
        self.pitch_wobble = tuple(float(v) for v in pitch_wobble) + (0.0,) * (3 - len(pitch_wobble))
        # yaw alone keeps scipy's rotation (and the bits) of the streams before
        self.tilted = bool(self.roll0 or self.roll_wobble[0] or self.pitch_wobble[0])
        self.rig = rig

    # ---- path functions over progress u (ramp-integral seconds) ---------
    def _P(self, u):
        u = np.asarray(u, float)
        if self.mode == "twist":
            return self.p0 + u[..., None] * self.v_lin
        a, w = self.loop_amp, self.loop_omega
        return self.p0 + np.stack(
            [a[0] * np.sin(w * u), a[1] * np.sin(2 * w * u), a[2] * np.sin(3 * w * u)],
            axis=-1,
        )

    def _dP(self, u):
        u = np.asarray(u, float)
        if self.mode == "twist":
            return np.broadcast_to(self.v_lin, u.shape + (3,)).copy()
        a, w = self.loop_amp, self.loop_omega
        return np.stack(
            [
                a[0] * w * np.cos(w * u),
                a[1] * 2 * w * np.cos(2 * w * u),
                a[2] * 3 * w * np.cos(3 * w * u),
            ],
            axis=-1,
        )

    def _ddP(self, u):
        u = np.asarray(u, float)
        if self.mode == "twist":
            return np.zeros(u.shape + (3,))
        a, w = self.loop_amp, self.loop_omega
        return np.stack(
            [
                -a[0] * w * w * np.sin(w * u),
                -a[1] * 4 * w * w * np.sin(2 * w * u),
                -a[2] * 9 * w * w * np.sin(3 * w * u),
            ],
            axis=-1,
        )

    def _yaw(self, u):
        u = np.asarray(u, float)
        a, w = self.yaw_wobble
        return self.yaw0 + self.yaw_rate * u + a * np.sin(w * u)

    def _dyaw_du(self, u):
        u = np.asarray(u, float)
        a, w = self.yaw_wobble
        return self.yaw_rate + a * w * np.cos(w * u)

    @staticmethod
    def _sway(u, c, wobble):
        """c + a sin(w u + phase) and its derivative in u."""
        a, w, ph = wobble
        return c + a * np.sin(w * u + ph), a * w * np.cos(w * u + ph)

    def _rotation(self, u):
        """The body's orientation at progress u (scalar or array), as
        rotation matrices [..., 3, 3]: R = Rz(yaw) Ry(pitch) Rx(roll)."""
        yaw = self._yaw(u)
        if not self.tilted:
            rotvecs = np.zeros(np.shape(yaw) + (3,))
            rotvecs[..., 2] = yaw
            return Rotation.from_rotvec(rotvecs).as_matrix()
        pitch, roll = self._sway(u, 0.0, self.pitch_wobble)[0], self._sway(u, self.roll0, self.roll_wobble)[0]
        cz, sz, cy, sy, cx, sx = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch), np.cos(roll), np.sin(roll)
        rows = [[cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
                [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
                [-sy, cy * sx, cy * cx]]
        return np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)

    def _body_rate(self, u, du):
        """The body-frame angular rate [n, 3] at progress u and du/dt: the
        ZYX Euler rates mapped into the body frame."""
        dyaw = self._dyaw_du(u) * du
        out = np.zeros((len(u), 3))
        th, dth = self._sway(u, 0.0, self.pitch_wobble)
        ph, dph = self._sway(u, self.roll0, self.roll_wobble)
        dth, dph = dth * du, dph * du
        out[:, 0] = dph - dyaw * np.sin(th)
        out[:, 1] = dth * np.cos(ph) + dyaw * np.cos(th) * np.sin(ph)
        out[:, 2] = dyaw * np.cos(th) * np.cos(ph) - dth * np.sin(ph)
        return out

    def _ramp_integral(self, rel):
        """Integral of the ramp profile min(max(t - t_still, 0)/t_ramp, 1)
        from 0 to rel (scalar or array)."""
        rel = np.asarray(rel, float) - self.t_still
        below = 0.5 * np.clip(rel, 0.0, None) ** 2 / self.t_ramp
        above = 0.5 * self.t_ramp + (rel - self.t_ramp)
        out = np.where(rel < self.t_ramp, below, above)
        return out if out.ndim else float(out)

    def _ramp(self, rel: float) -> float:
        return float(np.clip((rel - self.t_still) / self.t_ramp, 0.0, 1.0))

    def _ramp_rate(self, rel):
        """du/dt and d2u/dt2 of the ramp envelope (arrays ok)."""
        relm = np.asarray(rel, float) - self.t_still
        du = np.clip(relm / self.t_ramp, 0.0, 1.0)
        ddu = np.where((relm >= 0) & (relm < self.t_ramp), 1.0 / self.t_ramp, 0.0)
        return du, ddu

    def pose(self, t: float) -> TruePose:
        rel = t - self.t_start
        u = self._ramp_integral(rel)
        if self.tilted:
            rotvec = Rotation.from_matrix(self._rotation(u)).as_rotvec()
        else:
            rotvec = np.array([0.0, 0.0, float(self._yaw(u))])
        return TruePose(position=np.asarray(self._P(u)), rotvec=rotvec)

    def world_accel(self, t: float) -> np.ndarray:
        rel = t - self.t_start
        u = self._ramp_integral(rel)
        du, ddu = self._ramp_rate(rel)
        return self._ddP(u) * du * du + self._dP(u) * ddu

    def to_lidar(self, world, stamps):
        """World points [n, 3] in the LiDAR frame at their stamps [n] (f64):
        p_L = R_l2i^T (R_WB^T (x_W - p_WB) - t_l2i)."""
        s = self._ramp_integral(stamps - self.t_start)
        R = self._rotation(s)  # [n,3,3]
        local = np.einsum("nji,nj->ni", R, world - self._P(s))
        return (local - self.rig.t_l2i) @ self.rig.R_l2i

    def _in_field(self, t0, n):
        """(points, stamps, elevations) of n points inside the rig's field:
        candidates drawn in batches, the first n inside kept in draw order,
        then sorted by stamp (f64, noise-free)."""
        lo, hi = self.rig.fov
        kept, have, drawn, m = [], 0, 0, 2 * n
        for _ in range(64):
            world = sample_scene_points(self.rng, m, planes=self.planes)
            stamps = t0 + self.rng.uniform(0, self.sweep, size=m)
            local = self.to_lidar(world, stamps)
            elev = elevation(local)
            inside = (elev >= lo) & (elev <= hi)
            kept.append((local[inside], stamps[inside], elev[inside]))
            have, drawn = have + int(inside.sum()), drawn + m
            if have >= n:
                break
            # the next batch sized by the share inside so far, 10% over
            m = int(1.1 * (n - have) * drawn / max(have, drawn // 64)) + 64
        else:
            raise ValueError(f"the field {np.rad2deg(self.rig.fov)} degrees sees {have} of {n} points")
        local, stamps, elev = (np.concatenate(c)[:n] for c in zip(*kept))
        order = np.argsort(stamps, kind="stable")
        return local[order], stamps[order], elev[order]

    def scan(self, scan_idx: int, pts_per_scan: int, n_rings: int = 16):
        """One motion-distorted scan: (points [n,3] f32 lidar frame,
        stamps [n] f64, rings [n] i32).  With a field, the points inside it
        and each point's ring the table's entry nearest its elevation before
        the range noise; without, every point, and rings binned over +-45
        degrees of its elevation."""
        t0 = self.t_start + scan_idx * self.sweep
        elev = None
        if self.rig.fov is None:
            world = sample_scene_points(self.rng, pts_per_scan, planes=self.planes)
            stamps = t0 + np.sort(self.rng.uniform(0, self.sweep, size=pts_per_scan))
            local = self.to_lidar(world, stamps).astype(np.float32)
        else:
            local, stamps, elev = self._in_field(t0, pts_per_scan)
            local = local.astype(np.float32)
        if self.noise_std > 0:
            local += self.rng.normal(scale=self.noise_std, size=local.shape).astype(np.float32)
        if elev is None:
            elev = elevation(local)
        if self.rig.ring_elev is not None:
            return local, stamps, nearest_ring(elev, self.rig.ring_elev)
        rings = np.clip(((elev + np.pi / 4) / (np.pi / 2) * n_rings).astype(np.int32), 0, n_rings - 1)
        return local, stamps, rings

    def imu_samples(self, t_from: float, t_to: float, rate: float = 400.0):
        """IMU (stamps, acc [n,3], gyr [n,3]) consistent with the motion,
        plus the configured constant biases and white noise (body frame) —
        measured = true + bias + noise, the model the reference's
        static-start estimators exist to absorb (ImuBuffer.h:59-63,
        ContinuousTrajectory.h:263-299)."""
        ts = np.arange(t_from, t_to, 1.0 / rate)
        rel = ts - self.t_start
        u = self._ramp_integral(rel)
        du, ddu = self._ramp_rate(rel)
        R = self._rotation(u)
        a_w = self._ddP(u) * (du * du)[:, None] + self._dP(u) * ddu[:, None]
        acc = np.einsum("nji,nj->ni", R, a_w - GRAVITY[None, :])
        gyr = self._body_rate(u, du)
        acc = acc + self.imu_bias_acc[None, :]
        gyr = gyr + self.imu_bias_gyr[None, :]
        if self.imu_noise_acc > 0:
            acc = acc + self.rng.normal(scale=self.imu_noise_acc, size=acc.shape)
        if self.imu_noise_gyr > 0:
            gyr = gyr + self.rng.normal(scale=self.imu_noise_gyr, size=gyr.shape)
        if self.rig.acc_in_g:
            acc = acc / G_UNIT
        return ts, acc, gyr


def truth(sequence: dict, rig: Rig = IDENTITY_RIG) -> SyntheticSequence:
    """The sequence a traffic file's "sequence" keys define on `rig`, for
    its analytic poses, the body's (pose(t) draws nothing from the seed)."""
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in sequence.items()}
    return SyntheticSequence(rig=rig, **kw)


def stream(seed: int, sequence: dict, n_scans: int, points_per_scan: int, rings: int, imu_rate_hz: float,
           stressors: dict, rig: Rig = IDENTITY_RIG):
    """The first `n_scans` records [(points, stamps, rings, imu stamps, acc,
    gyr)] of the sequence a traffic file's "sequence" keys define, drawn
    from `seed` on `rig`, with its stressors applied (bench.py:55-67,
    123-137)."""
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in sequence.items()}
    seq = SyntheticSequence(rng=np.random.default_rng(seed), rig=rig, **kw)
    out = []
    t_imu = seq.t_start - 0.2
    for i in range(n_scans):
        t_end = seq.t_start + (i + 1) * seq.sweep
        ts, acc, gyr = seq.imu_samples(t_imu, t_end, rate=imu_rate_hz)
        out.append((*seq.scan(i, points_per_scan, n_rings=rings), ts, acc, gyr))
        t_imu = t_end
    return apply_stressors(out, **stressors)


def apply_stressors(data, imu_dropout=(), short_every=0, short_after=0, short_keep=1.0):
    """The JAX package's bench.py:123-137: the IMU of the scans in
    `imu_dropout` dropped, and every `short_every`-th scan after scan
    `short_after` cut to `short_keep` of its points.  The truth is
    unchanged: only the sensor stream degrades."""
    out = []
    for i, (pts, stamps, rings, ts, acc, gyr) in enumerate(data):
        if i in imu_dropout:
            ts, acc, gyr = ts[:0], acc[:0], gyr[:0]
        if short_every and i > short_after and i % short_every == 0:
            n = max(1, int(len(pts) * short_keep))
            pts, stamps, rings = pts[:n], stamps[:n], rings[:n]
        out.append((pts, stamps, rings, ts, acc, gyr))
    return out
