"""Fixed-radius neighbour queries and k-nearest neighbours on a hash grid
(counterpart of dmsa_lidar_slam_tpu/ops/knn.py).

Reference points are binned at cell size = radius by a murmur-finalized
30-bit spatial hash; a query gathers the 27 adjacent cells, each truncated
to `cap` members (callers compare HashGrid.max_occupancy with cap), and
keeps the nearest or the k nearest.  Queries go in chunks of _QUERY_CHUNK,
so the [chunk, 27 * cap, 3] gather stays bounded.  uint32 arithmetic is
carried in int64 and masked to 32 bits.
"""

from typing import NamedTuple

import torch

_QUERY_CHUNK = 4096
_P1, _P2, _P3 = 73856093, 19349663, 83492791
_HASH_MASK = (1 << 30) - 1
_INVALID = 2**31 - 1
_U32 = 0xFFFFFFFF


class HashGrid(NamedTuple):
    sorted_pts: torch.Tensor  # [N, 3]
    sorted_valid: torch.Tensor  # [N]
    cell_keys: torch.Tensor  # [N] key of each cell (pad: max)
    cell_start: torch.Tensor  # [N]
    cell_count: torch.Tensor  # [N]
    num_cells: torch.Tensor  # []
    cell_size: torch.Tensor  # []
    max_occupancy: torch.Tensor  # [] largest cell's member count


def _hash_coords(c):
    c = c.to(torch.int64) & _U32
    h = (c[..., 0] * _P1 + c[..., 1] * _P2 + c[..., 2] * _P3) & _U32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _U32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _U32
    h = h ^ (h >> 16)
    return h & _HASH_MASK


def build_grid(points, mask, cell_size) -> HashGrid:
    n = points.shape[0]
    dev = points.device
    c = torch.floor(points / cell_size).to(torch.int32)
    keys = torch.where(mask, _hash_coords(c), torch.full((n,), _INVALID, dtype=torch.int64, device=dev))
    keys_s, order = torch.sort(keys, stable=True)
    pts_s = points[order]
    valid_s = mask[order]
    new_cell = torch.ones(n, dtype=torch.int64, device=dev)
    new_cell[1:] = (keys_s[1:] != keys_s[:-1]).to(torch.int64)
    seg_ids = torch.clamp(torch.cumsum(new_cell, 0) - 1, max=n - 1)
    num_cells = torch.where(
        torch.any(valid_s),
        torch.max(torch.where(valid_s, seg_ids, torch.full_like(seg_ids, -1))) + 1,
        torch.zeros((), dtype=torch.int64, device=dev),
    )
    idx = torch.arange(n, device=dev)
    big = torch.full((n,), n, dtype=torch.int64, device=dev)
    cell_start = big.scatter_reduce(0, seg_ids, idx, reduce="amin", include_self=True)
    cell_count = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(0, seg_ids, valid_s.to(torch.int64))
    kmax = torch.full((n,), _INVALID, dtype=torch.int64, device=dev)
    cell_keys = kmax.scatter_reduce(0, seg_ids, keys_s, reduce="amin", include_self=True)
    # empty segments keep the fill values (key: max, start: n), as jax's
    # segment_min fills with the dtype max; their count is 0
    return HashGrid(
        sorted_pts=pts_s,
        sorted_valid=valid_s,
        cell_keys=cell_keys,
        cell_start=cell_start,
        cell_count=cell_count,
        num_cells=num_cells,
        cell_size=torch.as_tensor(cell_size, device=dev),
        max_occupancy=torch.max(torch.where(idx < num_cells, cell_count, torch.zeros_like(cell_count))),
    )


_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


def _candidates(grid: HashGrid, q_chunk, cap: int):
    n = grid.sorted_pts.shape[0]
    dev = q_chunk.device
    c = torch.floor(q_chunk / grid.cell_size).to(torch.int32)
    off = torch.tensor(_OFFSETS, dtype=torch.int32, device=dev)
    cc = c[:, None, :] + off[None, :, :]
    nk = _hash_coords(cc)  # [C, 27]
    pos = torch.searchsorted(grid.cell_keys, nk.contiguous())
    pos = torch.clamp(pos, max=n - 1)
    hit = grid.cell_keys[pos] == nk
    start = grid.cell_start[pos]
    count = grid.cell_count[pos]
    j = torch.arange(cap, device=dev)
    idx = torch.clamp(start[..., None] + j, max=n - 1)
    ok = hit[..., None] & (j < count[..., None])
    return idx.reshape(idx.shape[0], -1), ok.reshape(ok.shape[0], -1)


def knn_indices(grid: HashGrid, queries, query_mask, k: int, cap: int = 8):
    """(idx [Q, k] into grid.sorted_pts, dist2 [Q, k], valid [Q, k])."""
    idx_out, d_out = [], []
    for a in range(0, queries.shape[0], _QUERY_CHUNK):
        qc = queries[a : a + _QUERY_CHUNK]
        idx, ok = _candidates(grid, qc, cap)
        cand = grid.sorted_pts[idx]
        d2 = torch.sum((qc[:, None, :] - cand) ** 2, dim=-1)
        d2 = torch.where(ok, d2, torch.full_like(d2, float("inf")))
        neg, sel = torch.topk(-d2, k, dim=1)
        idx_out.append(torch.gather(idx, 1, sel))
        d_out.append(-neg)
    idx = torch.cat(idx_out)
    d2 = torch.cat(d_out)
    valid = torch.isfinite(d2) & query_mask[:, None]
    return idx, d2, valid


def min_sq_dist(grid: HashGrid, queries, query_mask, cap: int = 16):
    """Squared distance [Q] f32 from each query to its nearest grid point
    among the 27 adjacent cells (exact for radii <= cell_size while no cell
    holds more than cap points); +inf where there is no candidate or the
    query is masked."""
    out = []
    for a in range(0, queries.shape[0], _QUERY_CHUNK):
        qc = queries[a : a + _QUERY_CHUNK]
        idx, ok = _candidates(grid, qc, cap)
        d2 = torch.sum((qc[:, None, :] - grid.sorted_pts[idx]) ** 2, dim=-1)
        out.append(torch.amin(torch.where(ok, d2, torch.full_like(d2, float("inf"))), dim=1))
    best = torch.cat(out) if out else queries.new_zeros(0)
    return torch.where(query_mask, best, torch.full_like(best, float("inf")))


def has_neighbor_within(grid: HashGrid, queries, query_mask, radius, cap: int = 16):
    """Boolean [Q]: the nearest grid point lies within radius (exact for
    cell_size >= radius)."""
    return min_sq_dist(grid, queries, query_mask, cap=cap) <= radius * radius


def overlap_fraction(ref_pts, ref_mask, query_pts, query_mask, max_dist, cap: int = 16):
    """Share [] f64 of the valid queries with a reference point within
    max_dist (getOverlap, DmsaSlam.h:377-414)."""
    grid = build_grid(ref_pts, ref_mask, max_dist)
    near = has_neighbor_within(grid, query_pts, query_mask, max_dist, cap=cap) & query_mask
    return torch.sum(near).to(torch.float64) / torch.clamp(torch.sum(query_mask), min=1).to(torch.float64)
