"""Voxel-grid binning and random-grid downsampling (counterpart of
dmsa_lidar_slam_tpu/ops/voxel.py).

Voxel identity is the reference's pair of int32 keys, key_hi =
(ix << 16) | iy and key_lo = iz (or (iz << 3) | channel), with grid
coordinates offset by 2^14.  Where the reference sorts lexicographically on
(hi, lo), the port sorts once on the single int64 key
hi * 2^32 + (lo + 2^31), which orders exactly like (hi, lo) as signed
int32 pairs.

Random priorities are an explicit int32 argument (the reference draws them
from the jax PRNG, whose bits torch cannot reproduce), so tests can feed
the reference's own bits.
"""

from typing import NamedTuple

import torch

_COORD_OFFSET = 1 << 14
_INVALID = 2**31 - 1
_P1, _P2, _P3 = 73856093, 19349663, 83492791
_U32 = 0xFFFFFFFF


def voxel_coords(points, grid_size):
    """Integer voxel coordinates [N, 3] int32 (floor of p / grid)."""
    return torch.floor(points / grid_size).to(torch.int32) + _COORD_OFFSET


def voxel_keys(points, mask, grid_size, channel=None):
    """(hi, lo) int32 voxel keys; invalid points get the max key."""
    c = voxel_coords(points, grid_size)
    hi = (c[:, 0] << 16) | (c[:, 1] & 0xFFFF)
    lo = c[:, 2]
    if channel is not None:
        lo = (lo << 3) | (channel.to(torch.int32) & 0x7)
    inv = torch.full_like(hi, _INVALID)
    return torch.where(mask, hi, inv), torch.where(mask, lo, inv)


def combined_key(hi, lo):
    """int64 key whose order is the lexicographic order of signed (hi, lo)."""
    return (hi.to(torch.int64) << 32) + (lo.to(torch.int64) + 2**31)


def run_flags(key_sorted):
    """(new_cell, is_end) bool flags of the runs of equal sorted keys."""
    n = key_sorted.shape[0]
    new_cell = torch.ones(n, dtype=torch.bool, device=key_sorted.device)
    new_cell[1:] = key_sorted[1:] != key_sorted[:-1]
    is_end = torch.ones_like(new_cell)
    is_end[:-1] = new_cell[1:]
    return new_cell, is_end


class RunBinning(NamedTuple):
    order: torch.Tensor  # [N] permutation sorting points by key (invalid last)
    new_cell: torch.Tensor  # [N] bool, run starts
    start: torch.Tensor  # [N] run-start position per sorted point
    end: torch.Tensor  # [N] one past the run's last position
    num_cells: torch.Tensor  # [] occupied cells among valid points


def bin_runs(points, mask, grid_size, channel=None) -> RunBinning:
    """Bin points into voxel runs of the stable key sort."""
    n = points.shape[0]
    hi, lo = voxel_keys(points, mask, grid_size, channel)
    key = combined_key(hi, lo)
    key_s, order = torch.sort(key, stable=True)
    new_cell, _ = run_flags(key_s)
    iota = torch.arange(n, dtype=torch.int64, device=points.device)
    start = torch.cummax(torch.where(new_cell, iota, torch.zeros_like(iota)), dim=0).values
    bpos = torch.where(new_cell, iota, torch.full_like(iota, n))
    suffix_min = torch.flip(torch.cummin(torch.flip(bpos, [0]), dim=0).values, [0])
    end = torch.cat([suffix_min[1:], torch.full((1,), n, dtype=torch.int64, device=points.device)])
    num_cells = torch.sum(new_cell & mask[order])
    return RunBinning(order=order, new_cell=new_cell, start=start, end=end, num_cells=num_cells)


def run_sums(values, start):
    """Per-run sums of contiguous sorted runs, broadcast to every member.

    Segment sums keyed by the run start (the reference differences a global
    cumsum instead, which in f32 loses ~1e-7 of the running total: ~1 mm on
    point sums at 10^4-10^5 points)."""
    return torch.zeros_like(values).index_add_(0, start, values)[start]


def random_downsample_mask(points, mask, grid_size, prio):
    """Keep one uniformly random valid point per voxel.

    prio [N] int32 random priorities: within a voxel the member with the
    smallest priority is kept (the reference's unstable three-key sort on
    (hi, lo, prio); here a stable sort on prio, then a stable sort on the
    voxel key, gives the same order)."""
    hi, lo = voxel_keys(points, mask, grid_size)
    key = combined_key(hi, lo)
    o1 = torch.sort(prio, stable=True).indices
    o2 = torch.sort(key[o1], stable=True).indices
    order = o1[o2]
    key_s = key[order]
    new_cell, _ = run_flags(key_s)
    keep_sorted = new_cell & mask[order]
    keep = torch.zeros_like(mask)
    keep[order] = keep_sorted
    return keep & mask


def compact(mask, cap: int):
    """Pack the True entries of mask [N] to the front, capped at cap.
    Returns (indices [cap], out_mask [cap]); stable order."""
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    idx = order[:cap]
    count = torch.sum(mask)
    out_mask = torch.arange(cap, device=mask.device) < count
    return idx, out_mask


def count_voxels_ladder(points, mask, grids):
    """Occupied-voxel counts at all ladder grid sizes, with the reference's
    28-bit hash (voxel.py count_voxels_ladder).  Returns [len(grids)] int32.
    uint32 arithmetic is carried in int64 and masked to 32 bits."""
    keys = []
    sentinel = 0x0FFFFFFF
    for li, g in enumerate(grids):
        c = voxel_coords(points, g).to(torch.int64) & _U32
        h = ((c[:, 0] * _P1) & _U32) ^ ((c[:, 1] * _P2) & _U32) ^ ((c[:, 2] * _P3) & _U32)
        h = h ^ (h >> 15)
        h = h & sentinel
        h = torch.where(h == sentinel, torch.zeros_like(h), h)
        h = torch.where(mask, h, torch.full_like(h, sentinel))
        keys.append((li << 28) | h)
    k = torch.cat(keys)
    ks = torch.sort(k).values
    newc = torch.ones_like(ks, dtype=torch.bool)
    newc[1:] = ks[1:] != ks[:-1]
    valid = (ks & sentinel) != sentinel
    lid = ks >> 28
    counts = [torch.sum(newc & valid & (lid == li)) for li in range(len(grids))]
    return torch.stack(counts).to(torch.int32)
