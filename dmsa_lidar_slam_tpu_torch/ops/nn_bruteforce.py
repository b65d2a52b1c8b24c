"""Exact nearest-neighbour distances by brute force: kernel K4 and its plain
version (counterpart of dmsa_lidar_slam_tpu/ops/nn_bruteforce.py,
min_sq_dist and has_neighbor_within).

The distance is |q - r|^2 computed directly (csrc/k4_nn.cu); invalid
references never win, invalid queries get +inf, as do all queries when no
reference is valid.
"""

import torch

from dmsa_lidar_slam_tpu_torch.ops import cuda_lib

_F32 = torch.float32


def min_sq_dist(ref_pts, ref_valid, queries, query_valid):
    """Squared distance [Q] from each query to the nearest valid reference.

    ref_pts [N, 3], ref_valid [N] bool, queries [Q, 3], query_valid [Q]."""
    if not queries.is_cuda:
        return min_sq_dist_ref(ref_pts, ref_valid, queries, query_valid)
    dev = queries.device
    r = ref_pts.to(_F32).contiguous()
    q = queries.to(_F32).contiguous()
    rv = ref_valid.to(torch.uint8).contiguous()
    qv = query_valid.to(torch.uint8).contiguous()
    n, nq = r.shape[0], q.shape[0]
    cuda_lib.require(r, "ref_pts", _F32, (n, 3), dev)
    cuda_lib.require(q, "queries", _F32, (nq, 3), dev)
    cuda_lib.require(rv, "ref_valid", torch.uint8, (n,), dev)
    cuda_lib.require(qv, "query_valid", torch.uint8, (nq,), dev)
    out = torch.empty(nq, dtype=_F32, device=dev)
    P = cuda_lib.ptr
    cuda_lib.LAUNCHES["min_sq_dist"] += 1
    cuda_lib.check(
        cuda_lib.library().k4_min_sq_dist(P(r), P(rv), n, P(q), P(qv), nq, P(out), cuda_lib.stream_ptr(dev)),
        "k4_min_sq_dist",
    )
    return out


def min_sq_dist_ref(ref_pts, ref_valid, queries, query_valid, pair_budget=1 << 24):
    """Plain version of min_sq_dist, over chunks of queries."""
    r = ref_pts.to(_F32)
    q = queries.to(_F32)
    inf = torch.tensor(float("inf"), dtype=_F32, device=q.device)
    pen = torch.where(ref_valid, torch.zeros((), dtype=_F32, device=q.device), inf)
    chunk = max(1, pair_budget // max(r.shape[0], 1))
    out = []
    for a in range(0, q.shape[0], chunk):
        qc = q[a : a + chunk]
        d2 = torch.sum((qc[:, None, :] - r[None, :, :]) ** 2, dim=-1) + pen[None, :]
        out.append(torch.amin(d2, dim=1) if r.shape[0] else torch.full((qc.shape[0],), float("inf"), device=q.device))
    best = torch.cat(out) if out else torch.zeros(0, dtype=_F32, device=q.device)
    return torch.where(query_valid, best, inf)


def has_neighbor_within(ref_pts, ref_valid, queries, query_valid, radius):
    """Boolean [Q]: a valid reference lies within `radius` of the query."""
    d2 = min_sq_dist(ref_pts, ref_valid, queries, query_valid)
    return d2 <= torch.as_tensor(radius, dtype=_F32, device=d2.device) ** 2
