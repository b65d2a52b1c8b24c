"""State conversion between the JAX reference and the port.

Both packages' FusedState / DeviceMapState, KeyframeMapData and KfAux
carry the same field names, shapes and dtypes, so a reference value given
as numpy arrays converts leaf by leaf, and the fused checkpoint stores the
leaves in the reference's flatten order (state_leaves).  Config is the same
dataclass in both packages.
"""

import numpy as np
import torch

from dmsa_lidar_slam_tpu_torch.map.device_map import DeviceMapState
from dmsa_lidar_slam_tpu_torch.map.keyframes import KeyframeMapData
from dmsa_lidar_slam_tpu_torch.parallel.keyframe_dist import KfAux
from dmsa_lidar_slam_tpu_torch.pipeline.fused import FusedState
from dmsa_lidar_slam_tpu_torch.utils.device import DEFAULT_DEVICE, resolve


def _named_from_numpy(cls, value, device):
    device = resolve(device)
    return cls(**{f: torch.as_tensor(np.array(getattr(value, f)), device=device) for f in cls._fields})


def map_data_from_numpy(data, device=DEFAULT_DEVICE) -> KeyframeMapData:
    """A KeyframeMapData whose fields are numpy arrays (the reference's,
    through np.asarray) -> the port's on `device` (the card unless "cpu")."""
    return _named_from_numpy(KeyframeMapData, data, device)


def kf_aux_from_numpy(aux, device=DEFAULT_DEVICE) -> KfAux:
    """A KfAux (parallel.keyframe_dist) whose fields are numpy arrays -> the
    port's on `device`."""
    return _named_from_numpy(KfAux, aux, device)


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


def state_leaves(state: FusedState) -> list:
    """The leaves of a FusedState in the order jax.tree.flatten gives the
    reference's: its fields in order, with the DeviceMapState's fields
    flattened in place at `kf` (the fused checkpoint's leaf{i} order)."""
    out = []
    for f in FusedState._fields:
        if f == "kf":
            out.extend(getattr(state.kf, g) for g in DeviceMapState._fields)
        else:
            out.append(getattr(state, f))
    return out


def state_from_leaves(leaves) -> FusedState:
    """Inverse of state_leaves: a FusedState of the given leaves, as they
    are (numpy arrays or tensors)."""
    leaves = list(leaves)
    n_kf = len(DeviceMapState._fields)
    n = len(FusedState._fields) - 1 + n_kf
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves, a FusedState has {n}")
    i = FusedState._fields.index("kf")
    kf = DeviceMapState(*leaves[i : i + n_kf])
    return FusedState(*leaves[:i], kf, *leaves[i + n_kf :])
