"""The benchmark's plain reference: a frozen copy of the PyTorch port's
fused per-scan step and host half, every kernel (K1-K5) as its plain
PyTorch version, on any device.  It imports nothing of the program.

`Reference(pipeline, device, pdt)` builds the step from a configuration
file's "pipeline" keys; the control builds it with a lower pose dtype.
"""

import dataclasses

import torch

from bench_port.reference import step as _step
from bench_port.reference.config import Config
from bench_port.reference.host import HostHalf
from bench_port.reference.map import device_map as dmap
from bench_port.reference.map import normals as _nrm

_POSE_FIELDS_KEPT_F64 = {"stamps"}  # the keyframe stamps stay float64 in every state


def config(pipeline: dict) -> Config:
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in pipeline.items()}
    return Config(**kw)


class Reference:
    """The reference step on `device`, its pose math in `pdt`.  `run`
    takes a state of the program (any NamedTuples with the FusedState
    fields) and the reference's own inputs; it returns the state after the
    step."""

    def __init__(self, pipeline: dict, device, pdt=torch.float64, flush_every: int = 16):
        self.config = config(pipeline)
        self.shapes = _step.shapes_from_config(self.config, flush_every)
        self.device = torch.device(device)
        self.pdt = pdt
        self.step = _step.make_step(self.config, self.shapes, self.device, pdt=pdt)

    def host(self) -> HostHalf:
        return HostHalf(dataclasses.replace(self.config), self.shapes)

    def priorities(self, seed: int):
        return _step.draw_priorities(seed, self.shapes, self.device)

    def state(self, program_state):
        """The program's state as the reference's FusedState, on the
        reference's device, pose leaves in its dtype."""

        def conv(name, v):
            v = v.to(self.device)
            if v.dtype == torch.float64 and name not in _POSE_FIELDS_KEPT_F64:
                v = v.to(self.pdt)
            return v

        kf = dmap.DeviceMapState(**{f: conv(f, getattr(program_state.kf, f)) for f in dmap.DeviceMapState._fields})
        fields = {f: conv(f, getattr(program_state, f)) for f in _step.FusedState._fields if f != "kf"}
        return _step.FusedState(kf=kf, **fields)

    def run(self, program_state, pack, aux, seed):
        return self.step(self.state(program_state), torch.as_tensor(pack, device=self.device),
                         torch.as_tensor(aux, device=self.device), self.priorities(seed))

    def normals(self, points, mask, grid_size, radius_scale=1.0):
        """K5's normals of a keyframe cloud, on the reference's device
        (`radius_scale` plants a fault in the neighbourhood's radius)."""
        return _nrm.estimate_normals(points.to(self.device), mask.to(self.device),
                                     grid_size.to(self.device) * radius_scale)
