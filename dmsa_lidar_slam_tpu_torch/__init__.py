"""dmsa_lidar_slam_tpu_torch — the DMSA LiDAR-inertial SLAM engine in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``dmsa_lidar_slam_tpu`` (the reference, which
stays in the repository unchanged).  Module names mirror the reference's,
so each counterpart is easy to find.  This package imports ``torch`` and
never ``jax``.

Dtype policy (the reference's ``utils/dtypes.py`` and ``__init__.py``):
  - pose, IMU and trajectory math in float64, on CPU and GPU alike;
  - points and kernel operands in float32;
  - float32 matmuls in true float32: TF32 is off for matmuls and cuDNN,
    and the matmul precision is "highest".

Every function that allocates takes its device from its inputs or from an
explicit ``device`` argument; nothing here picks a device on its own.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from dmsa_lidar_slam_tpu_torch.config import Config, load_config  # noqa: E402,F401


def __getattr__(name):
    if name == "FusedDmsaSlam":
        from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedDmsaSlam

        return FusedDmsaSlam
    raise AttributeError(name)


__version__ = "0.1.0"
