"""Flat wire packing: one ``(n_rows, BLOCK)`` buffer for a parameter tree.

Port of ``repro.core.wire`` (``LeafSlot``, ``WireLayout``,
``ChunkedLayout``, the async exchange's in-flight buffers).  A
:class:`WireLayout` maps every leaf of a per-node parameter tree to a row
range of one float32 buffer: each leaf is padded to whole ``BLOCK`` rows
(quantization blocks never span leaves) and the buffer height to a
``TILE_N`` multiple.  Leaves are taken in JAX's flattening
order (``core.tree``), so ``row_start``/``n_rows`` equal the reference's.

``pack``/``unpack`` also take trees whose leaves carry leading batch
dimensions (the port stacks consensus nodes on a leading axis): leaves of
shape ``lead + slot.shape`` pack to ``lead + (n_rows, BLOCK)``.

Padding invariant: padding rows quantize to code 0 (an exact zero
differential never rounds away from 0), so the zero padding of the packed
shadows survives every exchange step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core import tree as T
from repro_torch.kernels import ops as kops

__all__ = ["LeafSlot", "WireLayout", "ChunkedLayout", "INFLIGHT_KEYS",
           "inflight_init"]

#: consensus-state keys of the async (one-step-stale) exchange's in-flight
#: payload triple: each node's own transmitted payload and its two ring
#: arrivals, carried across the step boundary (core.distributed)
INFLIGHT_KEYS = ("fly_self", "fly_up", "fly_dn")


def inflight_init(n_nodes: int, payload_bytes: int, device=None,
                  trailer: torch.Tensor | None = None) -> torch.Tensor:
    """The initial ``(n_nodes, payload_bytes)`` uint8 in-flight payloads:
    all zero bytes, which every codec decodes to a zero differential, so
    retiring them at step 1 is an exact no-op gossip; with ``trailer``
    ``(n_nodes, t)`` uint8 (the push-sum weight 1, which must not decode
    to 0) appended to each row."""
    buf = torch.zeros((n_nodes, int(payload_bytes)), dtype=torch.uint8,
                      device=device)
    if trailer is None:
        return buf
    return torch.cat([buf, trailer.to(device, torch.uint8)], dim=1)


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one leaf lives inside the packed buffer (all static)."""

    shape: tuple[int, ...]
    dtype: Any                 # original leaf dtype (unpack casts back)
    size: int                  # number of real elements
    row_start: int             # first block row of this leaf
    n_rows: int                # whole BLOCK-rows owned by this leaf (ceil)
    path: str = ""             # keystr-style leaf path

    @property
    def row_end(self) -> int:
        return self.row_start + self.n_rows


@dataclasses.dataclass(frozen=True)
class WireLayout:
    """Static packing plan for a per-node parameter tree (hashable).

    ``n_rows`` (the buffer height) = ``n_data_rows`` (leaf-owned rows)
    rounded up to a ``TILE_N`` multiple; the tail rows belong to no leaf.
    ``placement`` is a buffer-order permutation of leaf indices (``()`` =
    leaf order); ``slots`` stay in leaf order with absolute row starts.
    """

    slots: tuple[LeafSlot, ...]
    treedef: Any
    n_rows: int
    n_data_rows: int
    block: int = kops.BLOCK
    placement: tuple[int, ...] = ()

    @classmethod
    def for_tree(cls, tree: Any, block: int = kops.BLOCK) -> "WireLayout":
        """Layout of a tree of tensors (``meta`` tensors will do: only
        shapes and dtypes are read)."""
        pairs, treedef = T.tree_flatten_with_path(tree)
        slots, row = [], 0
        for path, leaf in pairs:
            shape = tuple(int(s) for s in leaf.shape)
            size = math.prod(shape)
            n_rows = math.ceil(max(size, 1) / block)
            slots.append(LeafSlot(shape=shape, dtype=leaf.dtype, size=size,
                                  row_start=row, n_rows=n_rows, path=path))
            row += n_rows
        total = math.ceil(max(row, 1) / kops.TILE_N) * kops.TILE_N
        return cls(slots=tuple(slots), treedef=treedef, n_rows=total,
                   n_data_rows=row, block=block)

    @property
    def buffer_order(self) -> tuple[int, ...]:
        return self.placement or tuple(range(len(self.slots)))

    def with_placement(self, placement) -> "WireLayout":
        """The same leaves re-packed in ``placement`` order (row starts
        recomputed; total geometry unchanged)."""
        placement = tuple(int(i) for i in placement)
        if sorted(placement) != list(range(len(self.slots))):
            raise ValueError(f"placement {placement} is not a permutation "
                             f"of {len(self.slots)} leaf indices")
        slots = list(self.slots)
        row = 0
        for i in placement:
            slots[i] = dataclasses.replace(slots[i], row_start=row)
            row += slots[i].n_rows
        identity = placement == tuple(range(len(self.slots)))
        return dataclasses.replace(self, slots=tuple(slots),
                                   placement=() if identity else placement)

    @property
    def n_leaves(self) -> int:
        return len(self.slots)

    @property
    def n_elements(self) -> int:
        """Real (un-padded) element count across the tree."""
        return sum(s.size for s in self.slots)

    def describe(self) -> dict:
        """JSON-able geometry snapshot (telemetry ``wire_plan`` events)."""
        return {"n_leaves": self.n_leaves, "n_elements": self.n_elements,
                "n_rows": self.n_rows, "n_data_rows": self.n_data_rows,
                "block": self.block,
                "reordered": bool(self.placement)}

    def _leaves_and_lead(self, tree: Any) -> tuple[list, tuple[int, ...]]:
        leaves, treedef = T.tree_flatten(tree)
        if treedef != self.treedef:
            raise ValueError("tree structure does not match layout")
        lead = None
        for leaf, slot in zip(leaves, self.slots):
            nd = leaf.dim() - len(slot.shape)
            if nd < 0 or tuple(leaf.shape[nd:]) != slot.shape:
                raise ValueError(f"leaf {slot.path} shape "
                                 f"{tuple(leaf.shape)} does not end in "
                                 f"{slot.shape}")
            here = tuple(leaf.shape[:nd])
            if lead is not None and here != lead:
                raise ValueError(f"leading dims {here} != {lead}")
            lead = here
        return leaves, lead or ()

    def pack(self, tree: Any) -> torch.Tensor:
        """Tree -> ``lead + (n_rows, block)`` float32 buffer, zero padded
        per leaf to whole rows plus the TILE_N tail."""
        leaves, lead = self._leaves_and_lead(tree)
        width = self.n_rows * self.block
        out = torch.empty(lead + (width,), dtype=torch.float32,
                          device=leaves[0].device)
        for leaf, slot in zip(leaves, self.slots):
            start = slot.row_start * self.block
            out[..., start:start + slot.size] = leaf.reshape(lead + (-1,))
            # zero_(), not ``= 0``: a scalar assignment lowers to other ops
            # on the meta device than on the CPU and the card, and a dry
            # run counts the same ops as a real step (launch.op_cost)
            out[..., start + slot.size:start + slot.n_rows * self.block] \
                .zero_()
        out[..., self.n_data_rows * self.block:].zero_()
        return out.view(lead + (self.n_rows, self.block))

    def unpack(self, packed: torch.Tensor, cast: bool = True) -> Any:
        """Packed buffer -> tree of views (cast back to each leaf's dtype
        when ``cast``)."""
        if tuple(packed.shape[-2:]) != (self.n_rows, self.block):
            raise ValueError(f"packed shape {tuple(packed.shape)} does not "
                             f"end in {(self.n_rows, self.block)}")
        lead = tuple(packed.shape[:-2])
        flat = packed.reshape(lead + (-1,))
        leaves = []
        for slot in self.slots:
            start = slot.row_start * self.block
            seg = flat[..., start:start + slot.size].reshape(
                lead + slot.shape)
            leaves.append(seg.to(slot.dtype) if cast else seg)
        return T.tree_unflatten(self.treedef, leaves)

    def leaf_rows(self, packed: torch.Tensor, i: int) -> torch.Tensor:
        """The ``(n_rows_i, block)`` row range of leaf ``i``."""
        slot = self.slots[i]
        return packed[..., slot.row_start:slot.row_end, :]

    def from_leaf_rows(self, rows: list) -> torch.Tensor:
        """Reassemble a packed buffer from per-leaf row blocks, given in
        leaf order, each ``lead + (n_rows_i, block)`` (the TILE_N-alignment
        tail is re-zeroed)."""
        if len(rows) != len(self.slots):
            raise ValueError(f"{len(rows)} row blocks != {len(self.slots)}")
        for r, slot in zip(rows, self.slots):
            if tuple(r.shape[-2:]) != (slot.n_rows, self.block):
                raise ValueError(f"leaf {slot.path}: rows {tuple(r.shape)} "
                                 f"do not end in {(slot.n_rows, self.block)}")
        rows = [rows[i] for i in self.buffer_order]
        lead = tuple(rows[0].shape[:-2])
        tail = self.n_rows - self.n_data_rows
        if tail:
            rows.append(rows[0].new_zeros(lead + (tail, self.block)))
        return torch.cat(rows, dim=-2)


@dataclasses.dataclass(frozen=True)
class ChunkedLayout:
    """Static split of a packed buffer into pipeline chunks on ``TILE_N``
    row boundaries; the chunk count is clamped to the tile count and the
    leading chunks carry the remainder tiles."""

    n_rows: int
    block: int
    bounds: tuple[tuple[int, int], ...]   # per chunk: (row_start, n_rows)

    @classmethod
    def split(cls, layout: WireLayout, pipeline_chunks: int,
              tile: int = kops.TILE_N) -> "ChunkedLayout":
        if pipeline_chunks < 1:
            raise ValueError(f"pipeline_chunks must be >= 1, got "
                             f"{pipeline_chunks}")
        n_tiles = layout.n_rows // tile
        if n_tiles * tile != layout.n_rows:
            raise ValueError(f"{layout.n_rows} rows are not a multiple of "
                             f"{tile}")
        n_chunks = max(1, min(pipeline_chunks, n_tiles))
        base, rem = divmod(n_tiles, n_chunks)
        bounds, row = [], 0
        for c in range(n_chunks):
            rows = (base + (1 if c < rem else 0)) * tile
            bounds.append((row, rows))
            row += rows
        return cls(n_rows=layout.n_rows, block=layout.block,
                   bounds=tuple(bounds))

    @property
    def n_chunks(self) -> int:
        return len(self.bounds)
