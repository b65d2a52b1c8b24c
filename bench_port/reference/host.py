"""The host half of the fused pipeline in plain NumPy: a frozen copy of the
bookkeeping of dmsa_lidar_slam_tpu_torch/pipeline/fused.py FusedDmsaSlam
(process_imu_batch, process_scan's one-scan buffer, pack_scan and the
priority seed).  Fed the same stream as the program, it works out again
the int16 wire pack, the f32 aux block and the seed of every step.
"""

import numpy as np

from bench_port.reference.imu.buffer import ImuBuffer
from bench_port.reference.step import PT_INV_SCALE


class HostHalf:
    """Replays the wrapper's host state; `scan` returns the (pack, aux,
    seed) of the step it dispatches, or None while it buffers."""

    def __init__(self, config, shapes):
        self.config = config
        self.shapes = shapes
        self.imu_buffer = ImuBuffer()
        self.time_initialized = False
        self.received_imu = False
        self.buffered_scan = None
        self.scan_counter = 0
        self._scan_minmax = []
        self._prev_window_t0 = None
        self._stamp_base = None

    def imu_batch(self, acc, gyr, stamps):
        if not self.time_initialized or len(stamps) == 0:
            return
        self.received_imu = True
        acc = np.asarray(acc, float)
        if self.config.acceleration_in_g:
            acc = acc * 9.81
        self.imu_buffer.add_batch(acc, gyr, np.asarray(stamps, float) + self.config.timeshift_to_imu)

    def scan(self, points, stamps, rings):
        self.time_initialized = True
        if self.buffered_scan is None:
            self.buffered_scan = (points, stamps, rings)
            return None
        to_process, self.buffered_scan = self.buffered_scan, (points, stamps, rings)
        pack, aux = self.pack(*to_process)
        seed = int(aux[self.shapes.n_dense + 2, 1])
        self.scan_counter += 1
        return pack, aux, seed

    def pack(self, points, stamps, rings):
        c = self.config
        sh = self.shapes
        n = min(len(points), sh.raw_cap)
        scan_t0 = float(stamps[:n].min())
        scan_t1 = float(stamps[:n].max())
        self._scan_minmax.append((scan_t0, scan_t1))
        if len(self._scan_minmax) > sh.n_clouds:
            self._scan_minmax.pop(0)
        t0_w = min(a for a, _ in self._scan_minmax)
        horizon = max(b for _, b in self._scan_minmax) - t0_w + 1e-3
        dt = horizon / (sh.n_dense - 1)
        shift_t0 = 0.0 if self._prev_window_t0 is None else t0_w - self._prev_window_t0
        self._prev_window_t0 = t0_w

        use_imu_now = c.use_imu and self.received_imu
        if self.scan_counter == 0 and c.use_imu and not self.received_imu:
            c.use_imu = False
            use_imu_now = False
        if use_imu_now and self.imu_buffer.num_updates > 0:
            dense_t = t0_w + np.arange(sh.n_dense) * dt
            acc_d, gyr_d, _ = self.imu_buffer.resample_nearest(dense_t)
        else:
            use_imu_now = False
            acc_d = np.zeros((sh.n_dense, 3))
            gyr_d = np.zeros((sh.n_dense, 3))

        pack = np.zeros((sh.raw_cap, 5), dtype=np.int16)
        aux = np.zeros((sh.aux_rows, 6), dtype=np.float32)
        qscale = max(scan_t1 - scan_t0, 1e-6) / 65535.0
        q = np.nan_to_num(np.asarray(points[:n], np.float32) * PT_INV_SCALE, nan=0.0, posinf=0.0, neginf=0.0)
        np.rint(q, out=q)
        q[np.abs(q).max(axis=1) > 32767.0] = 0.0
        pack[:n, :3] = q
        pack[:n, 3] = ((stamps[:n] - scan_t0) * (1.0 / qscale)).astype(np.uint16).view(np.int16)
        pack[:n, 4] = np.asarray(rings[:n]) & 0x7FFF
        D = sh.n_dense
        aux[:D, :3] = acc_d
        aux[:D, 3:] = gyr_d
        aux[D, :] = [
            dt,
            horizon,
            1.0 if use_imu_now else 0.0,
            c.alpha_sliding_window_imu if use_imu_now else c.alpha_sliding_window_no_imu,
            c.max_step_sliding_window_imu if use_imu_now else c.max_step_sliding_window_no_imu,
            c.imu_factor_weight_submap if use_imu_now else 0.0,
        ]
        rel = [a - t0_w for a, _ in self._scan_minmax]
        aux[D + 1, : sh.n_clouds] = [0.0] * (sh.n_clouds - len(rel)) + rel
        aux[D + 2, 0] = shift_t0
        aux[D + 2, 1] = float(self.scan_counter + 1)
        if self._stamp_base is None:
            self._stamp_base = t0_w
        t0_rel = t0_w - self._stamp_base
        t0_hi = np.float32(t0_rel)
        aux[D + 2, 2] = t0_hi
        aux[D + 2, 3] = np.float32(t0_rel - float(t0_hi))
        acc_init = self.imu_buffer.initial_acc_mean
        if acc_init is not None:
            aux[D + 3, :3] = acc_init
            aux[D + 3, 3] = 1.0
        aux[D + 3, 4] = float(n)
        aux[D + 3, 5] = qscale
        self.received_imu = False
        return pack, aux
