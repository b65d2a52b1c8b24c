"""Pose containers and relative<->global chain conversion (counterpart of
dmsa_lidar_slam_tpu/core/poses.py).

Parameter vector layout as the reference: params = [orient[1:].ravel(),
transl[1:].ravel()], pose 0 is the gauge anchor.
"""

from typing import NamedTuple

import torch

from bench_port.reference.core import rotations as rot


class PoseChain(NamedTuple):
    orient: torch.Tensor  # [N, 3] axis-angle, pose k relative to pose k-1
    transl: torch.Tensor  # [N, 3] translation k expressed in frame k-1

    @property
    def n(self) -> int:
        return self.orient.shape[0]


class GlobalPoses(NamedTuple):
    orient: torch.Tensor  # [N, 3] axis-angle world <- body_k
    transl: torch.Tensor  # [N, 3]


def inclusive_scan(combine, elems, dim: int = 0):
    """Log-depth inclusive scan (Hillis-Steele) of an associative
    `combine(a, b)` over tuples of tensors sharing dimension `dim`.

    ceil(log2 N) batched rounds instead of an N-step Python loop (which
    would be N kernel launches per element on the card).  Out-of-place and
    free of data-dependent control flow, so it works under torch.func.
    """
    n = elems[0].shape[dim]
    cur = tuple(elems)
    s = 1
    while s < n:
        left = tuple(e.narrow(dim, 0, n - s) for e in cur)
        right = tuple(e.narrow(dim, s, n - s) for e in cur)
        comb = combine(left, right)
        cur = tuple(
            torch.cat([e.narrow(dim, 0, s), c], dim=dim) for e, c in zip(cur, comb)
        )
        s *= 2
    return cur


def compose_prefix(q_rel, t_rel):
    """Prefix SE(3) compositions of relative (quat [N,4], transl [N,3])."""

    def combine(a, b):
        qa, ta = a
        qb, tb = b
        return rot.quat_mul(qa, qb), ta + rot.quat_rotate(qa, tb)

    q_glob, t_glob = inclusive_scan(combine, (q_rel, t_rel))
    q_glob = q_glob / torch.linalg.norm(q_glob, dim=-1, keepdim=True)
    return q_glob, t_glob


def relative2global(chain: PoseChain) -> GlobalPoses:
    q_glob, t_glob = compose_prefix(rot.axang2quat(chain.orient), chain.transl)
    return GlobalPoses(orient=rot.quat2axang(q_glob), transl=t_glob)


def global2relative(gp: GlobalPoses) -> PoseChain:
    R = rot.axang2rotm(gp.orient)
    R_prev, R_curr = R[:-1], R[1:]
    t_prev, t_curr = gp.transl[:-1], gp.transl[1:]
    rel_R = torch.einsum("nji,njk->nik", R_prev, R_curr)
    rel_t = torch.einsum("nji,nj->ni", R_prev, t_curr - t_prev)
    rel_orient = torch.cat([gp.orient[:1], rot.rotm2axang(rel_R)], dim=0)
    rel_transl = torch.cat([gp.transl[:1], rel_t], dim=0)
    return PoseChain(orient=rel_orient, transl=rel_transl)


def params_from_chain(chain: PoseChain) -> torch.Tensor:
    return torch.cat([chain.orient[1:].reshape(-1), chain.transl[1:].reshape(-1)])


def chain_from_params(params: torch.Tensor, anchor: PoseChain) -> PoseChain:
    n = anchor.n
    m = 3 * (n - 1)
    orient_rest = params[:m].reshape(n - 1, 3)
    transl_rest = params[m : 2 * m].reshape(n - 1, 3)
    return PoseChain(
        orient=torch.cat([anchor.orient[:1], orient_rest], dim=0),
        transl=torch.cat([anchor.transl[:1], transl_rest], dim=0),
    )


