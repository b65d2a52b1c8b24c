"""State conversion between the JAX reference and the port.

Both packages' FusedState / DeviceMapState carry the same field names,
shapes and dtypes, so a reference state given as numpy arrays converts leaf
by leaf.  Config is the same dataclass in both packages.
"""

import numpy as np
import torch

from dmsa_lidar_slam_tpu_torch.map.device_map import DeviceMapState
from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedState
from dmsa_lidar_slam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve


def state_from_numpy(state, device=DEFAULT_DEVICE) -> FusedState:
    """A FusedState (with its DeviceMapState) whose leaves are numpy arrays
    -> the port's FusedState on `device` (the card unless "cpu")."""
    device = resolve(device)

    def t(x):
        return torch.as_tensor(np.array(x), device=device)

    kf = DeviceMapState(**{f: t(getattr(state.kf, f)) for f in DeviceMapState._fields})
    fields = {f: t(getattr(state, f)) for f in FusedState._fields if f != "kf"}
    return FusedState(kf=kf, **fields)


def state_to_numpy(state: FusedState) -> FusedState:
    """The port's FusedState -> the same NamedTuple with numpy leaves."""

    def n(x):
        return x.detach().cpu().numpy()

    kf = DeviceMapState(**{f: n(getattr(state.kf, f)) for f in DeviceMapState._fields})
    fields = {f: n(getattr(state, f)) for f in FusedState._fields if f != "kf"}
    return FusedState(kf=kf, **fields)
