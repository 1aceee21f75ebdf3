"""ParallelContext: the consensus node axis, stacked or over processes.

Counterpart of ``repro.models.sharding``.  The reference runs one
consensus node per device under ``shard_map`` and moves a ring payload
with ``ppermute``.  The port has two contexts:

* :func:`local_context` — every node on one device, a leading axis of
  every tensor (the stacked runtime); a ring shift is an index.
* a process context (:func:`make_context` with a ``torch.distributed``
  group, made by ``launch.mesh.make_process_context``) — one node per
  rank; a ring shift sends the rank's tensor to its neighbour over the
  group.

On the gloo group a CUDA tensor crosses the wire staged through pinned
host memory (:class:`StagedRing`): a device-to-host copy into a pinned
send buffer, ``batch_isend_irecv`` to the peers, and a host-to-device copy
into a preallocated device receive buffer.  Buffers are allocated once
per (slot, shape, dtype), never per step.

Tensor parallelism (``tp``) and FSDP (``data_size > n_nodes``) need
collectives across several cards (NCCL): not yet ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch
import torch.distributed as dist

__all__ = ["ParallelContext", "StagedRing", "local_context", "make_context"]

_TP_FSDP = ("tensor parallelism and FSDP are not yet ported: they need "
            "NCCL collectives across several cards (a later slice)")


class RingFlight:
    """One posted ring transfer: :meth:`wait` blocks until every message
    has landed and returns the received tensors on the sender's device,
    in the order the transfer named its sources.  They are the slot's
    receive buffers: the slot's next transfer overwrites them."""

    def __init__(self, ring: "StagedRing", key, works, recv_host, recv_dev):
        self._ring, self._key, self._works = ring, key, works
        self._stats = ring._kind_stats(key[0])
        self._recv_host, self._recv_dev = recv_host, recv_dev
        self._out = None

    def wait(self) -> list[torch.Tensor]:
        if self._out is not None:
            return self._out
        t0 = time.perf_counter()
        for w in self._works:
            w.wait()
        t1 = time.perf_counter()
        ring, stats = self._ring, self._stats
        stats["wait_s"] += t1 - t0
        stats["last_done"] = t1
        if self._recv_dev is None:              # host tensors: no staging
            self._out = list(self._recv_host)
        else:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            for dev, host in zip(self._recv_dev, self._recv_host):
                dev.copy_(host, non_blocking=True)
            ev1.record()
            # the pinned receive buffers are free once this copy has run
            ring._copied[self._key] = ev1
            ring._h2d.append((stats, ev0, ev1))
            self._out = list(self._recv_dev)
        ring._pending.discard(self._key)
        return self._out


class StagedRing:
    """Point-to-point transfers of one rank over a gloo group.

    ``start(x, sends, recvs, slot)`` posts ``x`` to each rank of
    ``sends`` and a receive from each rank of ``recvs``; message ``j`` of a
    transfer carries tag ``slot_index * size + j``, so two transfers in
    flight at once never match each other's messages (at two ranks both
    ring neighbours are one rank, and its two messages are told apart by
    tag).  A CUDA ``x`` is copied into a pinned host buffer (the copy is
    waited for before the sends are posted), and the received bytes are
    copied into device buffers of ``x``'s shape; a CPU ``x`` is sent as it
    is.  Every buffer belongs to its ``(slot, shape, dtype)`` and is
    allocated at its first use.

    ``stats`` accumulates per kind of transfer (the slot's name, or its
    first item), until :meth:`reset_stats`: ``d2h_s`` and ``h2d_s`` (the
    staging copies, CUDA events; :meth:`read_stats` adds them after a
    synchronize), ``wire_s`` (host clock from posting the kind's first
    transfer to the return of its last wait), ``wait_s`` (the time the
    host spent blocked in the waits) and ``bytes_sent``."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size
        self._bufs: dict = {}
        self._tags: dict = {}
        self._copied: dict = {}
        self._pending: set = set()
        self._d2h: list = []
        self._h2d: list = []
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats: dict[str, dict] = {}
        self._d2h, self._h2d = [], []

    def _kind_stats(self, slot) -> dict:
        kind = slot[0] if isinstance(slot, tuple) else slot
        return self.stats.setdefault(kind, {
            "d2h_s": 0.0, "h2d_s": 0.0, "wait_s": 0.0, "bytes_sent": 0,
            "first_post": None, "last_done": None})

    def read_stats(self) -> dict:
        """``{kind: stats}`` with the staging copies' CUDA event times
        added (call after the device has run them)."""
        for name, copies in (("d2h_s", self._d2h), ("h2d_s", self._h2d)):
            for stats, a, b in copies:
                stats[name] += a.elapsed_time(b) / 1e3
            copies.clear()
        out = {}
        for kind, v in self.stats.items():
            v = dict(v)
            first, last = v.pop("first_post"), v.pop("last_done")
            v["wire_s"] = (0.0 if first is None or last is None
                           else last - first)
            out[kind] = v
        return out

    def _buffers(self, key, x: torch.Tensor, n_recv: int):
        bufs = self._bufs.get(key)
        if bufs is None:
            if x.device.type == "cuda":
                send = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                recv_host = [torch.empty(x.shape, dtype=x.dtype,
                                         pin_memory=True)
                             for _ in range(n_recv)]
                recv_dev = [torch.empty_like(x) for _ in range(n_recv)]
            else:
                send = None
                recv_host = [torch.empty_like(x) for _ in range(n_recv)]
                recv_dev = None
            bufs = self._bufs[key] = (send, recv_host, recv_dev)
            self._tags[key] = len(self._tags)
        return bufs

    def start(self, x: torch.Tensor, sends: list[int], recvs: list[int],
              slot: Any = 0) -> RingFlight:
        key = (slot, tuple(x.shape), x.dtype, x.device.type, len(sends),
               len(recvs))
        if key in self._pending:
            raise RuntimeError(f"ring slot {slot!r} is still in flight: "
                               "wait for it before reusing its buffers")
        send, recv_host, recv_dev = self._buffers(key, x, len(recvs))
        x = x.contiguous()
        if send is not None:
            done = self._copied.pop(key, None)
            if done is not None:             # the last receive was copied
                done.synchronize()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            send.copy_(x, non_blocking=True)
            ev1.record()
            ev1.synchronize()                 # the bytes are on the host
            self._d2h.append((self._kind_stats(slot), ev0, ev1))
        else:
            send = x
        base = self._tags[key] * self.size
        ops = [dist.P2POp(dist.isend, send, peer, self.group, tag=base + j)
               for j, peer in enumerate(sends)]
        ops += [dist.P2POp(dist.irecv, buf, peer, self.group, tag=base + j)
                for j, (peer, buf) in enumerate(zip(recvs, recv_host))]
        posted = time.perf_counter()
        works = dist.batch_isend_irecv(ops)
        nbytes = x.numel() * x.element_size()
        stats = self._kind_stats(slot)
        if stats["first_post"] is None:
            stats["first_post"] = posted
        stats["bytes_sent"] += nbytes * len(sends)
        self._pending.add(key)
        return RingFlight(self, key, works, recv_host, recv_dev)


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """The node axis of the consensus ring: ``n_nodes`` consensus nodes on
    the data axis of ``data_size`` devices (``fsdp = data_size /
    n_nodes``), ``pods`` times over.  ``group`` is the ``torch.
    distributed`` group of a process context (None: every node stacked on
    one device), ``rank`` this process's node and ``device`` its device;
    ``ring`` is the group's :class:`StagedRing`."""

    tp: int = 1
    data_size: int = 1
    n_nodes: int = 1
    pods: int = 1
    group: Any = None
    rank: int = 0
    device: torch.device | None = None
    ring: StagedRing | None = dataclasses.field(default=None, compare=False,
                                                repr=False)

    def __post_init__(self):
        if self.tp != 1 or self.fsdp != 1:
            raise NotImplementedError(
                f"tp={self.tp}, data_size={self.data_size}, n_nodes="
                f"{self.n_nodes}: {_TP_FSDP}")
        if self.group is not None and self.ring is None:
            object.__setattr__(self, "ring", StagedRing(
                self.group, self.rank, self.total_consensus_nodes))

    # -- the reference's node-axis sizes ----------------------------------
    @property
    def fsdp(self) -> int:
        return self.data_size // self.n_nodes

    @property
    def dp(self) -> int:
        """Total data-parallel ways (microbatch shards)."""
        return self.data_size * self.pods

    @property
    def total_consensus_nodes(self) -> int:
        return self.n_nodes * self.pods

    @property
    def process_ring(self) -> bool:
        """One node per rank of ``group`` (else every node stacked)."""
        return self.group is not None

    # -- collectives over the node ring -----------------------------------
    def neighbours(self, shift: int = 1) -> tuple[int, int]:
        """(the rank whose tensor ``ppermute_ring(x, shift)`` delivers
        here, the rank this one's goes to): ``rank - shift`` and ``rank +
        shift`` on the ring."""
        n = self.total_consensus_nodes
        return (self.rank - shift) % n, (self.rank + shift) % n

    def ring_start(self, x: torch.Tensor, slot: Any = 0) -> RingFlight:
        """Post ``x`` to both ring neighbours at stride 1 and receive
        theirs: ``wait()`` gives ``[left, right]``, the tensors of ranks
        ``rank - 1`` (``ppermute(+1)``) and ``rank + 1``
        (``ppermute(-1)``): the slot's receive buffers, valid until its
        next transfer.  Process context only."""
        left, right = self.neighbours(1)
        return self.ring.start(x, [right, left], [left, right], slot)

    def ppermute_ring(self, x: torch.Tensor, shift: int,
                      slot: Any = "ppermute") -> torch.Tensor:
        """The reference's ``_ppermute_ring`` at stride ``shift``: node i
        gets node ``i - shift``'s ``x``.  Stacked, ``x`` has a leading node
        axis (its length is the ring's) and the shift is an index; over
        processes, ``x`` is this
        rank's tensor and crosses the wire."""
        n = (self.total_consensus_nodes if self.process_ring
             else x.shape[0])
        if n <= 1:
            return x
        if not self.process_ring:
            idx = torch.tensor([(i - shift) % n for i in range(n)],
                               device=x.device)
            return x.index_select(0, idx)
        src, dst = self.neighbours(shift)
        # a copy: the receive buffer is the slot's, reused by its next use
        return self.ring.start(x, [dst], [src], slot).wait()[0].clone()

    def node_group_sum(self, x: torch.Tensor,
                       slot: Any = "sum") -> torch.Tensor:
        """Sum over the nodes in the reference's rotation order
        (``_node_group_sum``): node i accumulates x_i + x_{i-1} + x_{i-2}
        + ..., so a process context gives the stacked sum's row bit for
        bit.  Over processes each rank receives every other rank's ``x``
        in one transfer and adds them in that order."""
        return next(self.node_group_sums([x], slot))

    def node_group_sums(self, xs, slot: Any = "sum"):
        """Yield :meth:`node_group_sum` of each tensor of ``xs``.  Stacked,
        one at a time as ``xs`` yields them; over processes every
        transfer is posted before the first sum."""
        if not self.process_ring:
            for x in xs:
                n, acc = x.shape[0], x
                for r in range(1, n):
                    idx = torch.tensor([(i - r) % n for i in range(n)],
                                       device=x.device)
                    acc = acc + x.index_select(0, idx)
                yield acc
            return
        n = self.total_consensus_nodes
        srcs = [(self.rank - r) % n for r in range(1, n)]
        dsts = [(self.rank + r) % n for r in range(1, n)]
        xs = list(xs)
        flights = [self.ring.start(x, dsts, srcs, (slot, i))
                   for i, x in enumerate(xs)]
        for x, flight in zip(xs, flights):
            acc = x
            for t in flight.wait():    # x_{i-1}, x_{i-2}, ...: the rotation
                acc = acc + t
            yield acc

    def gather_nodes(self, x: torch.Tensor) -> torch.Tensor:
        """Every node's ``x`` stacked in node order, on ``x``'s device:
        ``(total_consensus_nodes, *x.shape[1:])`` from each rank's
        ``(1, ...)`` (small tensors: metrics).  Stacked, ``x`` itself."""
        if not self.process_ring:
            return x
        host = x.detach().to("cpu").contiguous()
        # as bytes: every dtype crosses gloo bit for bit
        flat = host.reshape(-1).view(torch.uint8)
        parts = [torch.empty_like(flat)
                 for _ in range(self.total_consensus_nodes)]
        dist.all_gather(parts, flat, group=self.group)
        return torch.cat([p.view(x.dtype).reshape(host.shape)
                          for p in parts]).to(x.device)


def local_context() -> ParallelContext:
    """The stacked context: every node a row of one device's tensors."""
    return ParallelContext()


def make_context(n_nodes: int, *, tp: int = 1, data_size: int | None = None,
                 group: Any = None, rank: int = 0,
                 device=None) -> ParallelContext:
    """A context of ``n_nodes`` consensus nodes; with ``group`` one node
    per rank (``rank`` this process's).  ``tp > 1`` or ``data_size >
    n_nodes`` (FSDP) raise ``NotImplementedError``."""
    data_size = n_nodes if data_size is None else data_size
    if group is not None:
        size = dist.get_world_size(group)
        if size != n_nodes:
            raise ValueError(f"the group has {size} ranks, the ring "
                             f"{n_nodes} nodes")
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside the group of {size}")
    return ParallelContext(tp=tp, data_size=data_size, n_nodes=n_nodes,
                           group=group, rank=rank,
                           device=None if device is None
                           else torch.device(device))
