"""Rank meshes over torch.distributed and the collectives the distributed
backends use (counterpart of dmsa_lidar_slam_tpu/parallel/mesh.py).

A JAX mesh is a grid of devices that one program runs over; here every
rank is a process running the same program, and a `Mesh` is the process
group of the ranks that take part, with this rank's place in it.  The
collectives keep the names of the JAX primitives they replace (psum, pmin,
pmax, all_to_all, axis_index).  A Mesh of size 1 with no process group
(`group=None`) makes each of them the identity, as a one-device JAX mesh
does.

Transport: NCCL carries every collective on CUDA tensors.  gloo carries
all of them on CPU tensors, and all_reduce and broadcast on CUDA tensors
(gloo copies through host memory itself), but not all_to_all on CUDA
tensors: with backend "gloo" a CUDA all_to_all is staged through host
memory here.  The staging follows the mesh's backend, which the caller
named when it created the process group.

The collective counter: every call of psum, pmin, pmax, all_to_all,
replicated and broadcast_from_mesh that reaches torch.distributed adds one
to COLLECTIVES[(scope, primitive, payload shape, dtype)]; a one-rank mesh's
identity sends nothing and counts nothing.  The scope is the innermost
count_scope the call runs in (the optimizers put each Gauss-Newton
iteration in "iteration"), None outside any; SCOPES counts how often each
scope was entered.  reset_collectives zeroes both, collective_rows reads
them with the bytes of one call (the payload as the caller hands it over).
What is sent does not change.
"""

import contextlib
import dataclasses
import logging
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

log = logging.getLogger("dmsa_mesh_torch")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of one process group along one named axis.

    group    the process group (None: a one-rank mesh with no group)
    ranks    the world ranks of the members, in mesh order
    rank     this process's index in the mesh (-1: not a member)
    backend  the group's backend ("nccl", "gloo"; None without a group)
    """

    group: Optional[object]
    ranks: Tuple[int, ...]
    axis_name: str = "data"
    rank: int = 0
    backend: Optional[str] = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def member(self) -> bool:
        return self.rank >= 0


# the one-rank mesh with no process group: every collective is the identity
ONE_RANK = Mesh(group=None, ranks=(0,))

COLLECTIVES = {}  # (scope, primitive, shape, dtype) -> calls
SCOPES = {}  # scope -> times entered
_scope = [None]


def reset_collectives():
    COLLECTIVES.clear()
    SCOPES.clear()


@contextlib.contextmanager
def count_scope(name: str):
    """Count the collectives issued inside under scope `name`."""
    outer = _scope[0]
    _scope[0] = name
    SCOPES[name] = SCOPES.get(name, 0) + 1
    try:
        yield
    finally:
        _scope[0] = outer


def _count(primitive: str, x: torch.Tensor):
    key = (_scope[0], primitive, tuple(x.shape), str(x.dtype).replace("torch.", ""))
    COLLECTIVES[key] = COLLECTIVES.get(key, 0) + 1


def collective_rows(scope=None):
    """The counted collectives of `scope` as dicts (primitive, shape, dtype,
    calls, bytes: of one call), most calls first."""
    rows = []
    for (sc, prim, shape, dtype), calls in COLLECTIVES.items():
        if sc == scope:
            itemsize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
            numel = 1
            for d in shape:
                numel *= d
            rows.append(dict(primitive=prim, shape=shape, dtype=dtype, calls=calls, bytes=numel * itemsize))
    return sorted(rows, key=lambda r: (-r["calls"], r["primitive"], r["shape"]))


class Mesh2D(NamedTuple):
    """The data x model grid of make_mesh_2d, seen from one rank: its data
    mesh (the ranks that share its model index) and its model mesh (those
    that share its data index); rank -1 in both outside the grid."""

    data: Mesh
    model: Mesh


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _group_mesh(ranks: Sequence[int], axis_name: str) -> Mesh:
    """A Mesh over `ranks`; every world rank must call this in the same
    order (dist.new_group is collective over the world)."""
    ranks = tuple(int(r) for r in ranks)
    if not dist.is_initialized():
        if ranks != (0,):
            raise ValueError(f"ranks {ranks}: no process group is initialized, so the only rank is 0")
        return dataclasses.replace(ONE_RANK, axis_name=axis_name)
    group = dist.group.WORLD if ranks == tuple(range(world_size())) else dist.new_group(list(ranks))
    me = world_rank()
    rank = ranks.index(me) if me in ranks else -1
    backend = dist.get_backend(group) if rank >= 0 else None
    if backend == "gloo" and torch.cuda.is_available():
        log.info("rank %d: mesh over ranks %s on gloo; all_to_all of CUDA tensors is staged through host memory",
                 me, ranks)
    return Mesh(group=group, ranks=ranks, axis_name=axis_name, rank=rank, backend=backend)


def make_mesh(axis_name: str = "data", ranks: Optional[Sequence[int]] = None) -> Mesh:
    """1-D mesh over all (or the given) world ranks; without a process
    group, the one-rank mesh."""
    if ranks is None:
        ranks = range(world_size())
    return _group_mesh(ranks, axis_name)


def make_mesh_2d(n_data: int, n_model: int) -> Mesh2D:
    """The first n_data * n_model ranks as a data x model grid (rank = d *
    n_model + m): data meshes shard points/keyframes, model meshes the
    Jacobian's tangent blocks.  Every world rank creates every subgroup."""
    n = world_size()
    if n < n_data * n_model:
        raise ValueError(f"{n_data} x {n_model} mesh needs {n_data * n_model} ranks, the world has {n}")
    outside = Mesh(group=None, ranks=(), rank=-1)
    data = model = outside
    for m in range(n_model):
        mesh = _group_mesh([d * n_model + m for d in range(n_data)], "data")
        data = mesh if mesh.member else data
    for d in range(n_data):
        mesh = _group_mesh([d * n_model + m for m in range(n_model)], "model")
        model = mesh if mesh.member else model
    return Mesh2D(data, model)


def shard_leading(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's slice of the leading axis (a view): rows
    [rank * n / size, (rank + 1) * n / size)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not shard evenly over {mesh.size} ranks")
    m = n // mesh.size
    return x.narrow(0, mesh.rank * m, m)


def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """`x` as the mesh's first rank holds it, on every member."""
    if mesh.group is None:
        return x
    _count("replicated", x)
    out = x.clone().contiguous()
    dist.broadcast(out, src=mesh.ranks[0], group=mesh.group)
    return out


def broadcast_from_mesh(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """`x` as the mesh's first rank holds it, on every rank of the world.
    The mesh's members already hold it; the ranks left out of the mesh pass
    a tensor of the same shape and dtype and receive it.  Every world rank
    calls this."""
    if mesh.size == world_size():
        return x
    _count("broadcast_from_mesh", x)
    out = x.clone().contiguous()
    dist.broadcast(out, src=mesh.ranks[0])
    return out


def axis_index(mesh: Mesh) -> int:
    return mesh.rank


def _all_reduce(x: torch.Tensor, mesh: Mesh, op, primitive: str) -> torch.Tensor:
    if mesh.group is None:
        return x
    _count(primitive, x)
    out = x.clone().contiguous()
    dist.all_reduce(out, op=op, group=mesh.group)
    return out


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over the mesh, the same bits on every member (ring all-reduce:
    each chunk is reduced once and then copied to every rank)."""
    return _all_reduce(x, mesh, dist.ReduceOp.SUM, "psum")


def pmin(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _all_reduce(x, mesh, dist.ReduceOp.MIN, "pmin")


def pmax(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _all_reduce(x, mesh, dist.ReduceOp.MAX, "pmax")


def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x [size, ...] -> out [size, ...]: out[d] is rank d's x[rank] (JAX's
    all_to_all over axis 0, untiled).  bool rides as uint8."""
    if mesh.group is None:
        return x
    if x.shape[0] != mesh.size:
        raise ValueError(f"all_to_all: leading axis {x.shape[0]}, mesh size {mesh.size}")
    _count("all_to_all", x)
    src = x.contiguous()
    if src.dtype == torch.bool:
        src = src.view(torch.uint8)
    staged = mesh.backend == "gloo" and src.is_cuda
    send = src.cpu() if staged else src
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    if staged:
        recv = recv.to(x.device)
    return recv.view(torch.bool) if x.dtype == torch.bool else recv
