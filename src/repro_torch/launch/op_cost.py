"""The cost of a step, counted as it runs: FLOPs, HBM bytes and launches.

Counterpart of ``repro.launch.hlo_cost``.  The reference walks the
post-optimisation HLO of a jitted step; eager PyTorch has no such module,
and every aten op is its own launch, so the port counts the ops of a step
while it runs, under :class:`CostCounter` (a ``TorchDispatchMode``).  On
the ``meta`` device the step allocates nothing and computes nothing, so a
dry run prices a configuration that does not fit the card
(``launch.dryrun``).  The rules are the reference's:

* **FLOPs**: ``2 * n_out * k`` for each matrix product (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, ``addbmm``, ``mv``, ``addmv``, ``dot``; ``einsum``,
  ``matmul`` and ``linear`` reach the counter as these), ``2 * n_out * 4``
  for a convolution (``hlo_cost.py``'s depthwise rule); nothing else;
* **HBM bytes**: the bytes of the tensor inputs and outputs of every op
  but the free ones: views, reshapes, allocations and metadata reads (the
  reference's ``_FREE_OPS``).  A tensor's bytes are its logical size;
* **launches**: one per counted op, by its aten name.

The hand-written kernels are loaded through ``ctypes`` (``kernels/_build``),
so no dispatch mode sees them.  Each kernel entry point reports its own
call through :func:`kernel_call` instead: its bytes (every input read once,
every output written once: the formula of the bound column of ``PERF.md``)
and its matrix-product FLOPs (only the flash-decode kernel has any), and the
ops inside the call (its plain version on the CPU, its output allocations)
are left uncounted.  So a step counts the same on the card, on the CPU and
on ``meta``.

Usage::

    with CostCounter() as counter:
        state, metrics = train_step(setup, state, batch, noise=noise)
    cost = counter.cost          # OpCost(flops, hbm_bytes, launches, ...)
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["OpCost", "CostCounter", "kernel_call"]

_aten = torch.ops.aten

#: matrix products: (op, index of the operand whose last dim is contracted)
_PRODUCTS = {_aten.mm.default: 0, _aten.addmm.default: 1,
             _aten.bmm.default: 0, _aten.baddbmm.default: 1,
             _aten.addbmm.default: 1, _aten.mv.default: 0,
             _aten.addmv.default: 1, _aten.dot.default: 0}
_CONVOLUTIONS = {_aten.convolution.default}
#: ops that move no HBM bytes of their own (besides every view op):
#: allocations, scalar reads to the host and metadata
_FREE = {"_unsafe_view", "empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_local_scalar_dense", "lift_fresh",
         "set_", "resize_", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "is_same_size", "record_stream"}


@dataclasses.dataclass
class OpCost:
    """What a counted region did: matrix-product FLOPs, HBM bytes, launches
    per aten op, and per hand-written kernel its calls, bytes and FLOPs
    (the kernels' bytes and FLOPs are in the totals too)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    launches: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    kernels: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    kernel_bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    kernel_flops: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    @property
    def n_launches(self) -> int:
        """Every launch: the aten ops' and the kernels'."""
        return sum(self.launches.values()) + sum(self.kernels.values())

    def as_dict(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "n_launches": self.n_launches,
                "launches": dict(sorted(self.launches.items())),
                "kernels": dict(sorted(self.kernels.items())),
                "kernel_bytes": dict(sorted(self.kernel_bytes.items())),
                "kernel_flops": dict(sorted(self.kernel_flops.items()))}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _bytes(tree) -> int:
    """Bytes of the tensors of an op's arguments or outputs: a tensor, or
    flat tuples and lists of them and of other values (nested ones through
    the pytree)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    total = 0
    for t in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, (tuple, list, dict)):
            total += sum(_nbytes(x) for x in tree_flatten(t)[0]
                         if isinstance(x, torch.Tensor))
    return total


def _op_flops(func, args, out) -> float:
    if func in _PRODUCTS:
        k = args[_PRODUCTS[func]].shape[-1]
        return 2.0 * out.numel() * k
    if func in _CONVOLUTIONS:
        return 2.0 * out.numel() * 4
    return 0.0


#: per op: (decomposes, free, name), looked up once
_KINDS: dict = {}


def _kind(func) -> tuple[bool, bool, str]:
    kind = _KINDS.get(func)
    if kind is None:
        kind = _KINDS[func] = (
            torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"),
            func.is_view or func.overloadpacket.__name__ in _FREE,
            str(func))
    return kind


class CostCounter(TorchDispatchMode):
    """Counts every aten op run under it into :attr:`cost` (the module's
    rules); kernel entry points report themselves (:func:`kernel_call`).
    Counters nest: each counts what runs under it."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self._paused = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        composite, free, name = _kind(func)
        if composite:
            # under inference_mode a composite op (matmul, einsum, to,
            # reshape, ...) reaches the mode whole; count the ops it is
            # made of, as autograd mode counts them
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self._paused or free:
            return out
        c = self.cost
        c.launches[name] += 1
        if func in _PRODUCTS or func in _CONVOLUTIONS:
            c.flops += _op_flops(func, args, out)
        c.hbm_bytes += _bytes(args) + _bytes(out)
        if kwargs:
            c.hbm_bytes += _bytes(kwargs)
        return out

    def _kernel(self, name: str, nbytes: float, flops: float) -> None:
        c = self.cost
        c.kernels[name] += 1
        c.kernel_bytes[name] += nbytes
        c.kernel_flops[name] += flops
        c.hbm_bytes += nbytes
        c.flops += flops


#: the counters entered and not yet left, innermost last
_ACTIVE: list[CostCounter] = []


class _KernelCall:
    """Reports one kernel call to every active counter on entry and pauses
    them until exit: the ops inside are the kernel's, not the step's."""

    __slots__ = ("counters",)

    def __init__(self, name: str, nbytes: float, flops: float):
        self.counters = list(_ACTIVE)
        for c in self.counters:
            c._kernel(name, float(nbytes), float(flops))

    def __enter__(self):
        for c in self.counters:
            c._paused += 1
        return self

    def __exit__(self, *exc):
        for c in self.counters:
            c._paused -= 1
        return False


_IDLE = contextlib.nullcontext()


def kernel_call(name: str, nbytes: float, flops: float = 0.0):
    """Context of one call of the hand-written kernel ``name``: reports
    ``nbytes`` and ``flops`` to the active counters and leaves the ops
    inside uncounted.  Free when no counter is active."""
    if not _ACTIVE:
        return _IDLE
    return _KernelCall(name, nbytes, flops)
