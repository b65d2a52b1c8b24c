"""Simple problem adapters for the generic DMSA optimizer (counterpart of
dmsa_lidar_slam_tpu/dmsa/problems.py).

The production problems live in trajectory.continuous (sliding window) and
map.keyframes (keyframe map).  This module provides the minimal rigid
multi-scan alignment problem, the "two-scan DMSA alignment": each scan k
has one rigid pose (a consecutive relative chain, pose 0 anchored), no
deskew, no extra residuals.  The optimizer runs it on its autodiff path.
"""

import dataclasses
from functools import lru_cache
from typing import NamedTuple

import torch

from dmsa_lidar_slam_tpu_torch.core import poses as cp
from dmsa_lidar_slam_tpu_torch.core import rotations as rot
from dmsa_lidar_slam_tpu_torch.dmsa.optimizer import ForwardOut


@dataclasses.dataclass(frozen=True)
class ScanAlignShapes:
    n_scans: int
    n_pts: int  # per-scan capacity


class ScanAlignData(NamedTuple):
    local_pts: torch.Tensor  # [S, N, 3] f32, scan-local frames
    mask: torch.Tensor  # [S, N] bool
    ring: torch.Tensor  # [S, N] i32
    anchor_orient: torch.Tensor  # [3] f64
    anchor_transl: torch.Tensor  # [3] f64


@lru_cache(maxsize=None)
def make_forward(shapes: ScanAlignShapes):
    def forward(params, data: ScanAlignData) -> ForwardOut:
        rest = torch.zeros(shapes.n_scans - 1, 3, dtype=data.anchor_orient.dtype, device=params.device)
        anchor = cp.PoseChain(
            orient=torch.cat([data.anchor_orient[None], rest]),
            transl=torch.cat([data.anchor_transl[None], rest]),
        )
        chain = cp.chain_from_params(params, anchor)
        gp = cp.relative2global(chain)
        R = rot.axang2rotm(gp.orient).to(torch.float32)
        t = gp.transl.to(torch.float32)
        pts_w = torch.einsum("sij,snj->sni", R, data.local_pts) + t[:, None, :]
        return ForwardOut(
            points=pts_w.reshape(-1, 3),
            mask=data.mask.reshape(-1),
            ring_ids=data.ring.reshape(-1),
            extra=torch.zeros(0, dtype=params.dtype, device=params.device),
        )

    return forward
