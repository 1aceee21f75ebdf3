"""Process contexts: the consensus ring as ranks of a gloo group.

Counterpart of ``repro.launch.mesh``.  The reference builds a device mesh
and runs one consensus node per device under ``shard_map``; the port runs
one node per process and moves the ring payloads over a
``torch.distributed`` gloo group (``models.sharding.StagedRing``).

``make_process_context`` binds a process started by ``torch.distributed.
run`` (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``) to its node::

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --process-ring ...

Its device is ``cuda:<LOCAL_RANK>`` unless the caller names one device
(``cuda:0``) that every rank then shares, or the CPU.  NCCL refuses two
ranks on one card, so the group is gloo, and a CUDA payload is staged
through pinned host memory.  ``run_ranks`` starts N ranks of a function
from Python (tests, ``chip_smoke.py``) with a ``file://`` rendezvous in a
temporary directory: no TCP port is chosen or held; a function that
returns with a ring transfer still in flight fails its rank (the transfer
is waited first, so the group is never torn down under it).

The production meshes (16 x 16, 2 x 16 x 16) need tensor parallelism and
FSDP over NCCL: not yet ported.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import resolve_device
from repro_torch.models.sharding import (ParallelContext, drain_rings,
                                         make_context)

__all__ = ["make_process_context", "run_ranks"]

#: the variables ``torch.distributed.run`` sets for each rank
RANK_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
#: seconds that bound every wait on a group this module joins
GROUP_TIMEOUT_S = 600.0


def make_process_context(device=None) -> ParallelContext:
    """This process's node of the ring: a gloo group over ``WORLD_SIZE``
    ranks (joined here unless the process already has its default group)
    and the rank's device, ``cuda:<LOCAL_RANK>`` by default or ``device``
    (one that every rank shares, such as ``cuda:0``, or ``cpu``).
    ``GROUP_TIMEOUT_S`` bounds every wait on the group.  Raises when the
    launcher's variables are missing or the world has fewer than two
    ranks."""
    missing = [k for k in RANK_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"the process ring needs {', '.join(missing)} in the "
            "environment: start it with python -m torch.distributed.run "
            "--nproc-per-node N (or launch.mesh.run_ranks)")
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    if world < 2:
        raise ValueError(f"WORLD_SIZE={world}: a consensus ring over "
                         "processes needs at least 2 ranks")
    dev = resolve_device(f"cuda:{local}" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    elif (dist.get_rank(), dist.get_world_size()) != (rank, world):
        raise RuntimeError(
            f"the default group is rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, the environment says {rank} of "
            f"{world}")
    return make_context(world, group=dist.group.WORLD, rank=rank,
                        device=dev)


def _rank_main(local_rank: int, fn, n: int, tmp: str, args: tuple,
               timeout_s: float) -> None:
    os.environ.update(RANK=str(local_rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(local_rank))
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
        rank=local_rank, world_size=n,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(*args)
        # a transfer left in flight would be cut by the teardown
        if drain_rings():
            raise RuntimeError(f"{getattr(fn, '__name__', fn)} returned "
                               "with ring transfers still in flight")
        torch.save(result, os.path.join(tmp, f"rank{local_rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n: int, *args, timeout_s: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``n`` new processes, one rank each of a gloo
    default group (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` set, so
    :func:`make_process_context` binds to it), and return each rank's
    result in rank order (``fn`` must be importable, its result
    picklable).  A rank that raises or exits non-zero fails the call; the
    others are then stopped.  Past ``timeout_s`` every rank is killed and
    ``TimeoutError`` raised."""
    with tempfile.TemporaryDirectory(prefix="ring-") as tmp:
        procs = mp.start_processes(_rank_main,
                                   args=(fn, n, tmp, args, timeout_s),
                                   nprocs=n, join=False,
                                   start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not procs.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{n} ranks of {getattr(fn, '__name__', fn)} "
                        f"still running after {timeout_s:.0f} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
