"""Dtype policy (counterpart of dmsa_lidar_slam_tpu/utils/dtypes.py).

Pose / IMU / trajectory math runs in float64 on every device (the H100
runs f64 natively, unlike the TPU, where the reference falls back to f32);
point coordinates and kernel operands stay float32.
"""

import torch

POSE_DTYPE = torch.float64
