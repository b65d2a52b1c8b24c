# Copy of dmsa_lidar_slam_tpu/imu/buffer.py; only the imports differ.
"""Host-side IMU ring buffer.

Equivalent of the reference's ImuBuffer (reference: include/DMSA/ImuBuffer.h):
circular store of accelerometer / gyroscope samples with
- gyro bias = mean of the first 50 samples (static-start assumption,
  ImuBuffer.h:59-63), subtracted from every stored sample,
- nearest-stamp lookup for resampling onto the window's dense time grid
  (ImuBuffer.h:66-125).

This is deliberately host-side numpy: ingestion is a per-message trickle
driven by the data reader; only the resampled dense arrays go to device.
"""

import numpy as np

BIAS_ESTIMATION_SAMPLES = 50  # ImuBuffer.h:59


class ImuBuffer:
    def __init__(self, max_num_meas: int = 10000):
        self.max_num = max_num_meas
        self.acc = np.zeros((max_num_meas, 3), dtype=np.float64)
        self.gyr = np.zeros((max_num_meas, 3), dtype=np.float64)
        self.stamps = np.full(max_num_meas, -np.inf, dtype=np.float64)
        self.bias_gyr = np.zeros(3, dtype=np.float64)
        self.acc_init = None  # mean acc over the static-start window
        self.next_idx = 0
        self.num_updates = 0

    def add_measurement(self, acc, gyr, stamp: float):
        self.acc[self.next_idx] = acc
        self.gyr[self.next_idx] = np.asarray(gyr) - self.bias_gyr
        self.stamps[self.next_idx] = stamp
        self.next_idx = (self.next_idx + 1) % self.max_num
        self.num_updates += 1
        if self.num_updates == BIAS_ESTIMATION_SAMPLES:
            # estimate gyro bias from the first 50 (already stored) samples
            self.bias_gyr = self.gyr[: self.num_updates].mean(axis=0)
            # gravity direction from the SAME static-start window: the
            # reference inits gravity from one sample at window t0
            # (ContinuousTrajectory.h:266, accMeas.col(0)), which breaks if
            # motion has already begun by the first window; the mean over
            # the samples already assumed static for the gyro bias is
            # strictly more robust under the same assumption
            self.acc_init = self.acc[: self.num_updates].mean(axis=0).copy()

    def add_batch(self, acc, gyr, stamps):
        """Vectorized add_measurement for n samples — EXACT same
        semantics (the batch that straddles the 50-sample static-start
        estimation threshold falls back to the per-sample path so the
        bias application boundary is bit-identical)."""
        n = len(stamps)
        if n == 0:
            return
        if self.num_updates < BIAS_ESTIMATION_SAMPLES <= self.num_updates + n:
            for j in range(n):
                self.add_measurement(np.asarray(acc[j], float), gyr[j], float(stamps[j]))
            return
        for j0 in range(0, n, self.max_num):
            a = np.asarray(acc[j0 : j0 + self.max_num], float)
            g = np.asarray(gyr[j0 : j0 + self.max_num], float)
            t = np.asarray(stamps[j0 : j0 + self.max_num], float)
            k = len(t)
            idx = (self.next_idx + np.arange(k)) % self.max_num
            self.acc[idx] = a
            self.gyr[idx] = g - self.bias_gyr
            self.stamps[idx] = t
            self.next_idx = int((self.next_idx + k) % self.max_num)
            self.num_updates += k

    @property
    def initial_acc_mean(self):
        """Mean accelerometer over the static-start bias window, or None if
        fewer than BIAS_ESTIMATION_SAMPLES have arrived."""
        return self.acc_init

    def _chronological(self):
        """Samples in time order (valid prefix if not yet full)."""
        n = min(self.num_updates, self.max_num)
        if self.num_updates <= self.max_num:
            sl = slice(0, n)
            return self.stamps[sl], self.acc[sl], self.gyr[sl]
        idx = (np.arange(n) + self.next_idx) % self.max_num
        return self.stamps[idx], self.acc[idx], self.gyr[idx]

    def resample_nearest(self, times):
        """Nearest-stamp acc/gyro for each query time [T].

        Vectorized version of per-sample getClosestMeasurement calls in
        transferImuMeasurements (ContinuousTrajectory.h:348-365).  Returns
        (acc [T,3], gyr [T,3], max_abs_timediff).
        """
        stamps, acc, gyr = self._chronological()
        if stamps.size == 0:
            raise RuntimeError("IMU buffer empty")
        right = np.searchsorted(stamps, times, side="left")
        right = np.clip(right, 0, stamps.size - 1)
        left = np.maximum(right - 1, 0)
        choose_left = np.abs(times - stamps[left]) < np.abs(times - stamps[right])
        idx = np.where(choose_left, left, right)
        diff = np.max(np.abs(times - stamps[idx])) if len(np.atleast_1d(times)) else 0.0
        return acc[idx], gyr[idx], float(diff)

    @property
    def latest_stamp(self) -> float:
        if self.num_updates == 0:
            return -1.0
        return float(self.stamps[(self.next_idx - 1) % self.max_num])

    @property
    def oldest_stamp(self) -> float:
        if self.num_updates == 0:
            return -1.0
        if self.num_updates < self.max_num:
            return float(self.stamps[0])
        return float(self.stamps[self.next_idx])
