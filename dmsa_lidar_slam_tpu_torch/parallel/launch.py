"""Multi-process launch helpers (counterpart of
dmsa_lidar_slam_tpu/parallel/launch.py).

Each rank runs this same program (`torchrun --nproc_per_node=N -m
dmsa_lidar_slam_tpu_torch.pipeline.runner ...`); initialize_distributed
joins the ranks into one torch.distributed process group, and the
distributed keyframe adjustment (parallel.spatial, parallel.keyframe_dist)
spreads one submap problem over them.

The JAX package's names map onto torchrun's environment:
JAX_COORDINATOR_ADDRESS is MASTER_ADDR:MASTER_PORT, JAX_NUM_PROCESSES is
WORLD_SIZE and JAX_PROCESS_ID is RANK; LOCAL_RANK, which JAX has no name
for, picks the rank's card (cuda:LOCAL_RANK), where a JAX process owns
all of its host's devices.
"""

import datetime
import logging
import os
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as dist

from dmsa_lidar_slam_tpu_torch.parallel import mesh as pmesh

log = logging.getLogger("dmsa_launch_torch")

# a rank left waiting in a collective raises after this long instead of
# hanging (torch.distributed's process-group timeout)
TIMEOUT_S = 120.0


def initialize_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
    timeout_s: float = TIMEOUT_S,
):
    """Join the process group from the arguments or torchrun's environment
    (MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK / LOCAL_RANK).  Returns
    the rank's device.

    Without a world size in either, this is a single process and a no-op
    but for the device.  The device defaults to cuda:LOCAL_RANK (also for
    "cuda" without an index) and becomes the current CUDA device; the
    backend defaults to NCCL on a card and gloo on the CPU.  NCCL takes
    one card per rank: ranks that share a card name backend="gloo" and
    their device.  Called again once the group exists, it returns the
    device and changes nothing.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", _int_env("LOCAL_RANK") or 0)
    if device.type == "cuda":
        if not torch.cuda.is_available() or (device.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"{device} requested but the process sees {torch.cuda.device_count()} CUDA cards; "
                               "pass device='cpu', or backend='gloo' with a shared card")
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    world_size = world_size or _int_env("WORLD_SIZE")
    if world_size is None:
        log.info("single-process mode on %s", device)
        return device
    rank = rank if rank is not None else _int_env("RANK")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    log.info("torch.distributed initialized: rank %d/%d on %s over %s", rank, world_size, device, backend)
    return device


def _int_env(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def global_keyframe_mesh(axis_name: str = "data", n_points: Optional[int] = None) -> pmesh.Mesh:
    """Mesh over all ranks of the world for the distributed keyframe
    adjustment.  With n_points, over the first ranks only, dropped from the
    end until n_points shard evenly; the ranks left out are not members and
    take the result through mesh.broadcast_from_mesh."""
    n_use = pmesh.world_size()
    while n_points is not None and n_points % n_use:
        n_use -= 1
    if n_use < pmesh.world_size():
        log.warning("distributed keyframe opt uses %d/%d ranks", n_use, pmesh.world_size())
    return pmesh.make_mesh(axis_name, ranks=range(n_use))


# one spawned run of ranks (Ranks), start-up included
RANKS_TIMEOUT_S = 600.0


def _local_rank_main(rank, world, store_dir, device, fn, args):
    torch.set_num_threads(1)
    device = initialize_distributed(backend="gloo", init_method=f"file://{store_dir}/store", world_size=world,
                                    rank=rank, device=device)
    try:
        torch.save(fn(rank, world, device, *args), os.path.join(store_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


class Ranks:
    """fn(rank, world, device, *args) on `world` processes of this host,
    started at once with the spawn method and joined over gloo through a
    file store in a new directory under work_dir (no TCP port), all on
    `device` (ranks on one card share it), one torch thread each.  fn must
    be a module-level function; it may return anything torch.save takes.
    The caller may work meanwhile, then reads results()."""

    def __init__(self, fn, world: int, work_dir, *args, device="cuda", timeout_s: float = RANKS_TIMEOUT_S):
        import torch.multiprocessing as mp

        self.dir = tempfile.mkdtemp(prefix=f"{fn.__name__}_", dir=str(work_dir))
        self.world, self.timeout_s = world, timeout_s
        self.deadline = time.monotonic() + timeout_s
        self.ctx = mp.start_processes(_local_rank_main, args=(world, self.dir, str(device), fn, args), nprocs=world,
                                      join=False, start_method="spawn")

    def results(self) -> list:
        """The ranks' values in rank order.  Raises if a rank failed (the
        others are stopped), or if the ranks have not finished by the
        deadline; no rank outlives the call."""
        try:
            while not self.ctx.join(timeout=max(1.0, self.deadline - time.monotonic())):
                if time.monotonic() >= self.deadline:
                    raise TimeoutError(f"{self.world} ranks did not finish within {self.timeout_s} s")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()
        return [torch.load(os.path.join(self.dir, f"rank{r}.pt"), weights_only=False) for r in range(self.world)]


def run_local_ranks(fn, world: int, work_dir, *args, device="cuda", timeout_s: float = RANKS_TIMEOUT_S) -> list:
    """Ranks(...).results(): the blocking form."""
    return Ranks(fn, world, work_dir, *args, device=device, timeout_s=timeout_s).results()
