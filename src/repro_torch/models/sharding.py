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
into a preallocated device receive buffer, or into the tensors the caller
names (``into``: the async transport lands each flight in tensors of its
own step, which no later transfer reuses).  Buffers are allocated once
per (slot, shape, dtype), never per step.  A ring shift goes to the
neighbours at any stride (``ring_start(..., stride=s)``: the time-varying
ring), or to the two peers the caller names (``ring_start(...,
peers=(left, right))``: a ring compacted by a membership mask, or the pod
ring under hierarchy, where member j of pod p talks to member j of the
neighbouring pods).  :meth:`ParallelContext.pod_sums` adds a tensor over
the ranks of one pod in member order (the hierarchy's inner level).  A
transfer may stay in flight across calls (the async transport posts one
step's payload and waits for it in the next); every flight a rank posted
is waited before its group is torn down (:func:`drain_rings`, called by
``launch.mesh.run_ranks``).

Tensor parallelism (``tp = T``) runs over a process grid of ``N x T``
ranks, data-major as the reference's ``(data, model)`` mesh: rank ``r`` is
consensus node ``r // T`` and model index ``r % T``.  ``rank`` is the
node, ``tp_rank`` the model index, and ``tp_group`` the gloo group of the
node's ``T`` ranks (:class:`TPComm`).  Every ring transfer goes to the
rank of the neighbouring node that has the same model index (the
reference's ``ppermute_node_ring``), so each model index runs its own ring
over its shards.  The tensor-parallel collectives (:meth:`ParallelContext.
psum_tp`, :meth:`~ParallelContext.copy_tp`, :meth:`~ParallelContext.
ag_tp`, :meth:`~ParallelContext.pmax_tp`) are ``torch.autograd.Function``
s whose backward is written out: a tensor is either replicated (the same
bits on every rank of the node, its cotangent complete on each) or
rank-partial (each rank its own part), and every collective states which
it turns into which.  FSDP (``data_size > n_nodes``) and a stacked context
with ``tp > 1`` are not yet ported.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
import weakref
from typing import Any

import torch
import torch.distributed as dist

__all__ = ["ParallelContext", "StagedRing", "TPComm", "drain_rings",
           "local_context", "make_context"]

_FSDP = ("FSDP (data_size > n_nodes) is not yet ported (ROADMAP Queue 1 "
         "item 5d)")
_STACKED_TP = ("tensor parallelism on a stacked context is not yet ported: "
               "tp > 1 runs over a process grid of n_nodes x tp ranks "
               "(launch.mesh.make_process_context(tp=...); ROADMAP Queue 1 "
               "item 5d)")


#: gloo's tags are non-negative 32-bit ints
_MAX_TAG = 2 ** 31 - 1

#: every StagedRing of this process (``drain_rings``)
_RINGS: "weakref.WeakSet[StagedRing]" = weakref.WeakSet()


class RingFlight:
    """One posted ring transfer: :meth:`wait` blocks until every message
    has landed and returns the received tensors on the sender's device,
    in the order the transfer named its sources: the tensors the transfer
    was given (``into``), else the slot's receive buffers, which the
    slot's next transfer overwrites.  Waiting twice returns the same
    tensors."""

    def __init__(self, ring: "StagedRing", key, works, recv_host, recv_dev,
                 posted: float):
        self._ring, self._key, self._works = ring, key, works
        self._recv_host, self._recv_dev = recv_host, recv_dev
        self._posted, self._window = posted, ring._window
        self._out = None

    def wait(self) -> list[torch.Tensor]:
        if self._out is not None:
            return self._out
        t0 = time.perf_counter()
        for w in self._works:
            w.wait()
        t1 = time.perf_counter()
        ring = self._ring
        # the stats of the window the wait falls in (reset_stats may have
        # opened a new one since the post)
        stats = ring._kind_stats(self._key[0])
        stats["wait_s"] += t1 - t0
        if self._window == ring._window:
            stats["last_done"] = t1
        else:                        # posted in an earlier window
            stats["carried_s"] += t1 - self._posted
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
        ring._pending.pop(self._key, None)
        return self._out


class StagedRing:
    """Point-to-point transfers of one rank over a gloo group.

    ``start(x, sends, recvs, slot)`` posts ``x`` to each rank of
    ``sends`` and a receive from each rank of ``recvs``; message ``j`` of a
    transfer carries tag ``base + j``, so two transfers in flight at once
    never match each other's messages (at two ranks both ring neighbours
    are one rank, and its two messages are told apart by tag).  ``base``
    is derived from the transfer's key (slot, shape, dtype, device type,
    peer counts) alone (:meth:`tag`), never from the order of use, so the
    ranks agree on it whatever slots each rank skipped before (a rank out
    of the ring for an epoch of elastic membership makes none of its
    transfers, and first uses the resync's slot epochs after the others).
    A CUDA ``x`` is copied into a pinned host buffer (the copy is waited
    for before the sends are posted), and the received bytes are copied
    into device buffers of ``x``'s shape, or into ``into``; a CPU ``x`` is
    sent as it is and received into host buffers, or straight into
    ``into``.  Every buffer belongs to its ``(slot, shape, dtype)`` and is
    allocated at its first use.

    ``stats`` accumulates per kind of transfer (the slot's name, or its
    first item) over a window that :meth:`reset_stats` opens: ``d2h_s``
    and ``h2d_s`` (the staging copies, CUDA events; :meth:`read_stats`
    adds them after a synchronize), ``wire_s`` (host clock from posting
    the kind's first transfer of the window to the return of the last wait
    of a transfer posted in it), ``wait_s`` (the time the host spent
    blocked in the window's waits), ``carried_s`` (posted-to-landed of the
    transfers posted in an earlier window and waited in this one: the
    async transport's flight) and ``bytes_sent`` (posted in the
    window)."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size
        self._bufs: dict = {}
        self._tags: dict = {}
        self._tag_keys: dict = {}
        self._copied: dict = {}
        self._pending: dict = {}
        self._d2h: list = []
        self._h2d: list = []
        self._window = 0
        self.reset_stats()
        _RINGS.add(self)

    def reset_stats(self) -> None:
        self.stats: dict[str, dict] = {}
        self._d2h, self._h2d = [], []
        self._window += 1

    @property
    def pending(self) -> int:
        """Transfers posted and not yet waited."""
        return len(self._pending)

    def drain(self) -> None:
        """Wait every transfer still in flight."""
        for flight in list(self._pending.values()):
            flight.wait()

    def _kind_stats(self, slot) -> dict:
        kind = slot[0] if isinstance(slot, tuple) else slot
        return self.stats.setdefault(kind, {
            "d2h_s": 0.0, "h2d_s": 0.0, "wait_s": 0.0, "carried_s": 0.0,
            "bytes_sent": 0, "first_post": None, "last_done": None})

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

    def tag(self, key) -> int:
        """The first tag of a transfer of ``key``: a multiple of ``size``
        drawn from the SHA-1 of the key's ``repr`` (the same on every rank
        and in every process), so the tags of its ``size - 1`` or fewer
        messages stay below the next key's.  Two keys of this ring whose
        tags collide raise (each rank sees the collision the same way)."""
        tag = self._tags.get(key)
        if tag is None:
            digest = hashlib.sha1(repr(key).encode()).digest()
            tag = (int.from_bytes(digest[:8], "little")
                   % (_MAX_TAG // self.size)) * self.size
            other = self._tag_keys.get(tag)
            if other is not None:
                raise RuntimeError(f"ring transfers {other!r} and {key!r} "
                                   f"derive the same gloo tag {tag}")
            self._tags[key], self._tag_keys[tag] = tag, key
        return tag

    def _buffers(self, key, x: torch.Tensor, n_recv: int, own_dev: bool):
        bufs = self._bufs.get(key)
        if bufs is None:
            if x.device.type == "cuda":
                send = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                recv_host = [torch.empty(x.shape, dtype=x.dtype,
                                         pin_memory=True)
                             for _ in range(n_recv)]
            else:
                send, recv_host = None, None    # made when first needed
            bufs = self._bufs[key] = [send, recv_host, None]
        if x.device.type == "cpu" and own_dev and bufs[1] is None:
            bufs[1] = [torch.empty_like(x) for _ in range(n_recv)]
        if x.device.type == "cuda" and own_dev and bufs[2] is None:
            bufs[2] = [torch.empty_like(x) for _ in range(n_recv)]
        return bufs

    def start(self, x: torch.Tensor, sends: list[int], recvs: list[int],
              slot: Any = 0, into: list | None = None) -> RingFlight:
        key = (slot, tuple(x.shape), x.dtype, x.device.type, len(sends),
               len(recvs))
        if key in self._pending:
            raise RuntimeError(f"ring slot {slot!r} is still in flight: "
                               "wait for it before reusing its buffers")
        if into is not None and (
                len(into) != len(recvs)
                or any(t.shape != x.shape or t.dtype != x.dtype
                       or t.device != x.device or not t.is_contiguous()
                       for t in into)):
            raise ValueError("into: one contiguous tensor of x's shape, "
                             "dtype and device per source")
        send, recv_host, recv_dev = self._buffers(key, x, len(recvs),
                                                  into is None)
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
            if into is not None:
                recv_dev = list(into)
        else:
            send = x
            if into is not None:
                recv_host = list(into)
        base = self.tag(key)
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
        flight = RingFlight(self, key, works, recv_host, recv_dev, posted)
        self._pending[key] = flight
        return flight


def drain_rings() -> int:
    """Wait every transfer still in flight on every ring of this process
    (before its group is torn down); returns how many there were."""
    n = 0
    for ring in list(_RINGS):
        n += ring.pending
        ring.drain()
    return n


class TPComm:
    """The collectives of one node's tensor-parallel group (``T`` gloo
    ranks, ``index`` this one's model index).

    :meth:`all_gather` gives every rank's tensor, in model-index order, on
    the caller's device; a sum or a max is then taken in that order on
    every rank, so each rank holds the same bits.  A CUDA tensor is staged
    through pinned host memory, as :class:`StagedRing` stages ring
    payloads: a device-to-host copy into a pinned send buffer, gloo's
    ``all_gather`` into pinned receive buffers, and host-to-device copies
    into new device tensors.  The pinned buffers belong to their ``(slot,
    shape, dtype)`` and are allocated at their first use; a buffer's next
    use waits for the last copy out of it.  Every dtype crosses as bytes,
    bit for bit.

    ``stats`` counts since :meth:`reset_stats`: ``wire_s`` (host seconds
    inside the collectives, staging included), ``bytes_sent`` (the bytes
    this rank's tensors owe the other ``T - 1`` ranks) and ``calls``."""

    def __init__(self, group, index: int, size: int):
        self.group, self.index, self.size = group, index, size
        self._bufs: dict = {}
        self._copied: dict = {}
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats = {"wire_s": 0.0, "bytes_sent": 0, "calls": 0}

    def all_gather(self, x: torch.Tensor, slot: str) -> list[torch.Tensor]:
        t0 = time.perf_counter()
        x = x.contiguous()
        if x.device.type == "cuda":
            key = (slot, tuple(x.shape), x.dtype)
            bufs = self._bufs.get(key)
            if bufs is None:
                bufs = self._bufs[key] = [
                    torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    for _ in range(self.size + 1)]
            done = self._copied.pop(key, None)
            if done is not None:         # the last copies out have run
                done.synchronize()
            send, recv = bufs[0], bufs[1:]
            send.copy_(x)                # synchronous: the bytes are here
            dist.all_gather([_bytes(r) for r in recv], _bytes(send),
                            group=self.group)
            out = [torch.empty_like(x) for _ in recv]
            for dev, host in zip(out, recv):
                dev.copy_(host, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self._copied[key] = ev
        else:
            out = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather([_bytes(r) for r in out], _bytes(x),
                            group=self.group)
        st = self.stats
        st["wire_s"] += time.perf_counter() - t0
        st["bytes_sent"] += x.numel() * x.element_size() * (self.size - 1)
        st["calls"] += 1
        return out

    def sum(self, x: torch.Tensor, slot: str) -> torch.Tensor:
        """The sum over the group, added in model-index order."""
        parts = self.all_gather(x, slot)
        acc = parts[0]
        for t in parts[1:]:
            acc = acc + t
        return acc

    def max(self, x: torch.Tensor, slot: str) -> torch.Tensor:
        parts = self.all_gather(x, slot)
        acc = parts[0]
        for t in parts[1:]:
            acc = torch.maximum(acc, t)
        return acc


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)


class _PsumTP(torch.autograd.Function):
    """Rank-partial -> replicated: the sum over the group.  The cotangent
    of the replicated sum is complete on every rank, and each part enters
    the sum once, so it passes to each part unchanged."""

    @staticmethod
    def forward(fctx, x, comm):
        return comm.sum(x, "psum")

    @staticmethod
    def backward(fctx, g):
        return g, None


class _CopyTP(torch.autograd.Function):
    """Replicated -> rank-partial: the identity.  Each rank's compute
    downstream adds its own part of the cotangent, so the backward sums
    the parts over the group (Megatron's ``f``)."""

    @staticmethod
    def forward(fctx, x, comm):
        fctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return fctx.comm.sum(g, "copy"), None


class _GatherTP(torch.autograd.Function):
    """Rank-partial chunks -> replicated: the tiled all-gather along
    ``dim``.  The replicated result's cotangent is complete on every rank,
    so each rank takes its own chunk of it."""

    @staticmethod
    def forward(fctx, x, comm, dim):
        fctx.comm, fctx.dim, fctx.n = comm, dim, x.shape[dim]
        return torch.cat(comm.all_gather(x, "gather"), dim=dim)

    @staticmethod
    def backward(fctx, g):
        return (g.narrow(fctx.dim, fctx.comm.index * fctx.n,
                         fctx.n).contiguous(), None, None)


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """The node axis of the consensus ring: ``n_nodes`` consensus nodes on
    the data axis of ``data_size`` devices (``fsdp = data_size /
    n_nodes``), ``pods`` times over, each node ``tp`` ranks wide.
    ``group`` is the ``torch.distributed`` group of a process context
    (None: every node stacked on one device), ``rank`` this process's
    node, ``tp_rank`` its model index, ``tp_group`` the group of its
    node's ``tp`` ranks, and ``device`` its device; ``ring`` is the
    group's :class:`StagedRing` and ``tp_comm`` the node group's
    :class:`TPComm`."""

    tp: int = 1
    data_size: int = 1
    n_nodes: int = 1
    pods: int = 1
    group: Any = None
    rank: int = 0
    device: torch.device | None = None
    tp_rank: int = 0
    tp_group: Any = None
    ring: StagedRing | None = dataclasses.field(default=None, compare=False,
                                                repr=False)
    tp_comm: TPComm | None = dataclasses.field(default=None, compare=False,
                                               repr=False)

    def __post_init__(self):
        if self.fsdp != 1:
            raise NotImplementedError(
                f"data_size={self.data_size}, n_nodes={self.n_nodes}: "
                f"{_FSDP}")
        if self.tp > 1 and self.group is None:
            raise NotImplementedError(f"tp={self.tp}: {_STACKED_TP}")
        if not 0 <= self.tp_rank < self.tp:
            raise ValueError(f"model index {self.tp_rank} outside tp="
                             f"{self.tp}")
        if self.tp > 1 and self.tp_comm is None:
            if self.tp_group is None:
                raise ValueError("a process grid with tp > 1 needs the "
                                 "node's tp_group")
            object.__setattr__(self, "tp_comm", TPComm(
                self.tp_group, self.tp_rank, self.tp))
        if self.group is not None and self.ring is None:
            object.__setattr__(self, "ring", StagedRing(
                self.group, self.global_rank,
                self.total_consensus_nodes * self.tp))

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

    @property
    def global_rank(self) -> int:
        """This process's rank in ``group``: ``rank * tp + tp_rank``."""
        return self.rank * self.tp + self.tp_rank

    def grid_rank(self, node: int) -> int:
        """The rank of ``node`` that has this process's model index."""
        return node * self.tp + self.tp_rank

    def _ranks(self, nodes) -> list[int]:
        return [self.grid_rank(n) for n in nodes]

    # -- tensor parallel (the node's tp group) ----------------------------
    def psum_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of the ranks' parts (rank-partial -> replicated)."""
        return x if self.tp == 1 else _PsumTP.apply(x, self.tp_comm)

    def copy_tp(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated tensor entering rank-partial compute: the
        identity, whose backward sums the ranks' cotangents."""
        return x if self.tp == 1 else _CopyTP.apply(x, self.tp_comm)

    def ag_tp(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Tiled all-gather of the ranks' chunks along ``axis``
        (rank-partial -> replicated; backward: the rank's chunk).  A
        gathered tensor that feeds rank-partial compute again goes through
        :meth:`copy_tp`, which together make the reference's
        reduce-scatter transpose."""
        return x if self.tp == 1 else _GatherTP.apply(x, self.tp_comm, axis)

    def pmax_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Maximum over the group (no gradient: the reference's inputs
        are stop-gradient or integers)."""
        return x if self.tp == 1 else self.tp_comm.max(x.detach(), "pmax")

    def reset_tp_stats(self) -> None:
        if self.tp_comm is not None:
            self.tp_comm.reset_stats()

    def tp_stats(self) -> dict:
        """``tp_wire_s`` and ``tp_bytes_sent`` of the tp collectives since
        :meth:`reset_tp_stats` (0 at tp = 1)."""
        st = (self.tp_comm.stats if self.tp_comm is not None
              else {"wire_s": 0.0, "bytes_sent": 0})
        return {"tp_wire_s": st["wire_s"],
                "tp_bytes_sent": st["bytes_sent"]}

    # -- collectives over the node ring -----------------------------------
    def neighbours(self, shift: int = 1) -> tuple[int, int]:
        """(the rank whose tensor ``ppermute_ring(x, shift)`` delivers
        here, the rank this one's goes to): ``rank - shift`` and ``rank +
        shift`` on the ring."""
        n = self.total_consensus_nodes
        return (self.rank - shift) % n, (self.rank + shift) % n

    def ring_start(self, x: torch.Tensor, slot: Any = 0, stride: int = 1,
                   into: list | None = None,
                   peers: tuple[int, int] | None = None) -> RingFlight:
        """Post ``x`` to both ring neighbours at ``stride`` and receive
        theirs: ``wait()`` gives ``[left, right]``, the tensors of ranks
        ``rank - stride`` (``ppermute(+stride)``) and ``rank + stride``
        (``ppermute(-stride)``): the two tensors of ``into`` when given,
        else the slot's receive buffers, valid until its next transfer.
        ``peers`` names the (left, right) ranks instead of the shift ring
        (a compacted or pod ring, whose tables every rank reads alike).
        Process context only."""
        left, right = self._ranks(self.neighbours(stride) if peers is None
                                  else peers)
        return self.ring.start(x, [right, left], [left, right], slot, into)

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
        src, dst = self._ranks(self.neighbours(shift))
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
        srcs = self._ranks((self.rank - r) % n for r in range(1, n))
        dsts = self._ranks((self.rank + r) % n for r in range(1, n))
        xs = list(xs)
        flights = [self.ring.start(x, dsts, srcs, (slot, i))
                   for i, x in enumerate(xs)]
        for x, flight in zip(xs, flights):
            acc = x
            for t in flight.wait():    # x_{i-1}, x_{i-2}, ...: the rotation
                acc = acc + t
            yield acc

    def pod_sums(self, xs, m: int, slot: Any = "pod"):
        """Yield, for each tensor of ``xs``, the sum over each pod of ``m``
        consecutive nodes, added in member order (member 0, then 1, ...):
        stacked, ``(N / m, ...)`` from ``(N, ...)``, one pod per row;
        over processes ``(1, ...)``, this rank's pod, the same bits on
        every member.  Over processes member j sends its tensor to the
        other ``m - 1`` members (j + 1, j + 2, ... around the pod, on the
        group's point-to-point transfers) and every transfer is posted
        before the first sum."""
        if not self.process_ring:
            for x in xs:
                s = x[::m].clone()
                for j in range(1, m):
                    s.add_(x[j::m])
                yield s
            return
        base, me = self.rank - self.rank % m, self.rank % m
        dsts = self._ranks(base + (me + r) % m for r in range(1, m))
        srcs = self._ranks(base + (me - r) % m for r in range(1, m))
        xs = list(xs)
        flights = [self.ring.start(x, dsts, srcs, (slot, i))
                   for i, x in enumerate(xs)]
        for x, flight in zip(xs, flights):
            parts = {me: x}
            for r, t in enumerate(flight.wait(), start=1):
                parts[(me - r) % m] = t
            s = parts[0].clone()
            for j in range(1, m):
                s.add_(parts[j])
            yield s

    def mean_metric(self, x: torch.Tensor,
                    over_tp: bool = False) -> torch.Tensor:
        """The reference's ``mean_metric`` of a metric: per-node values
        ``(n_local,)`` meaned over the nodes, and over the model indices
        too with ``over_tp`` (a value each rank computed on its own
        shards); a scalar, the same on every rank, as it is."""
        return x if x.dim() == 0 else self.gather_nodes(x, over_tp).mean()

    def gather_nodes(self, x: torch.Tensor,
                     over_tp: bool = False) -> torch.Tensor:
        """Every node's ``x`` stacked in node order, on ``x``'s device:
        ``(total_consensus_nodes, *x.shape[1:])`` from each rank's
        ``(1, ...)`` (small tensors: metrics), read from the ranks of this
        model index; with ``over_tp`` every rank's, ``(total_consensus_nodes
        * tp, ...)`` in rank order (a value that differs across the model
        indices).  Stacked, ``x`` itself."""
        if not self.process_ring:
            return x
        host = x.detach().to("cpu").contiguous()
        # as bytes: every dtype crosses gloo bit for bit
        flat = host.reshape(-1).view(torch.uint8)
        parts = [torch.empty_like(flat)
                 for _ in range(self.total_consensus_nodes * self.tp)]
        dist.all_gather(parts, flat, group=self.group)
        if not over_tp:
            parts = [parts[r] for r in
                     self._ranks(range(self.total_consensus_nodes))]
        return torch.cat([p.view(x.dtype).reshape(host.shape)
                          for p in parts]).to(x.device)


def local_context() -> ParallelContext:
    """The stacked context: every node a row of one device's tensors."""
    return ParallelContext()


def make_context(n_nodes: int, *, tp: int = 1, data_size: int | None = None,
                 group: Any = None, rank: int = 0, device=None,
                 tp_rank: int = 0, tp_group: Any = None) -> ParallelContext:
    """A context of ``n_nodes`` consensus nodes; with ``group`` one node
    per ``tp`` ranks (``rank`` this process's node, ``tp_rank`` its model
    index, ``tp_group`` its node's group).  ``data_size > n_nodes`` (FSDP)
    and ``tp > 1`` without a group raise ``NotImplementedError``."""
    data_size = n_nodes if data_size is None else data_size
    if group is not None:
        size = dist.get_world_size(group)
        if size != n_nodes * tp:
            raise ValueError(f"the group has {size} ranks, the grid "
                             f"{n_nodes} nodes x tp {tp}")
        if not 0 <= rank < n_nodes:
            raise ValueError(f"node {rank} outside the ring of {n_nodes}")
    return ParallelContext(tp=tp, data_size=data_size, n_nodes=n_nodes,
                           group=group, rank=rank,
                           device=None if device is None
                           else torch.device(device),
                           tp_rank=tp_rank, tp_group=tp_group)
