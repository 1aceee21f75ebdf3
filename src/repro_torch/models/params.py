"""Parameter declarations, initialisation and the weight carry from JAX.

Counterpart of ``repro.models.params``: a :class:`ParamDef` declares one
tensor's logical per-node shape (tp-global) and initialiser, and, as the
reference's, ``tp_dim`` (the dimension split over the ``tp`` ranks of a
node, None: replicated on each) and ``fsdp_dim`` (the dimension on which
the reference's storage layout concatenates the nodes' replicas, which the
weight carry reads).  A rank of a tensor-parallel grid holds
:func:`logical_shape_local` of each leaf: its slice ``tp_rank`` of the tp
dimension.  The declared shapes are the grid's: a padded vocabulary
(``layers.padded_vocab``) and a padded expert axis
(``moe.padded_experts``, whose dead experts are drawn and carried like
the others), so the carry copies the reference's padded leaves as they
are.  Consensus nodes are a leading axis.  A
parameter's ``dtype`` is the model's compute dtype (float32 or bfloat16,
``transformer.build_defs(cfg, dtype=)``), as in the reference, where the
parameters are stored in the compute dtype; a few leaves are float32 at
every compute dtype (Mamba2's ``a_log``, ``d_skip`` and ``dt_bias``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import tree as T

__all__ = ["ParamDef", "init_params", "params_from_jax", "meta_params",
           "consensus_state_from_jax", "logical_shape_local", "tp_slice"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declaration of one parameter tensor (logical, per node, tp-global)."""

    shape: tuple[int, ...]
    init: str = "normal"            # normal | zeros | ones
    scale: float = 1.0              # stddev multiplier for 'normal'
    dtype: torch.dtype = torch.float32
    tp_dim: int | None = None       # dim split over a node's tp ranks
    fsdp_dim: int = 0               # dim carrying the nodes in storage

    def __post_init__(self):
        if self.tp_dim is not None and self.tp_dim == self.fsdp_dim:
            raise ValueError(f"tp_dim == fsdp_dim == {self.tp_dim} for "
                             f"shape {self.shape}")


def logical_shape_local(d: ParamDef, tp: int) -> tuple[int, ...]:
    """The shape a model index holds: the tp dim divided by ``tp``."""
    s = list(d.shape)
    if d.tp_dim is not None:
        if s[d.tp_dim] % tp:
            raise ValueError(f"tp dim {d.tp_dim} of {d.shape} not "
                             f"divisible by {tp}")
        s[d.tp_dim] //= tp
    return tuple(s)


def tp_slice(x: torch.Tensor, d: ParamDef, tp: int, tp_rank: int,
             lead: int = 0) -> torch.Tensor:
    """Model index ``tp_rank``'s slice of the full leaf ``x`` (a view;
    ``lead`` leading axes come before ``d``'s dimensions)."""
    if tp == 1 or d.tp_dim is None:
        return x
    n = d.shape[d.tp_dim] // tp
    return x.narrow(lead + d.tp_dim, tp_rank * n, n)

#: float32 elements of one draw of a leaf stored in another dtype: the
#: draw is made this many elements (whole slices of the leading axis) at a
#: time and cast into the leaf, so that no float32 copy of a whole leaf
#: ever exists (chameleon-34b's stacked ``w_gate`` would be 34.6 GB)
DRAW_ELEMENTS = 1 << 26


def _init_tensor(d: ParamDef, gen: torch.Generator, device,
                 n_nodes: int | None = None) -> torch.Tensor:
    """One leaf, with a leading axis of ``n_nodes`` identical replicas
    when given.  The draw is scaled in place and copied into the replicas,
    so no second copy of the leaf is ever allocated (deepseek-moe-16b's
    stacked expert weights are 19.9 GB each).  A leaf of another dtype
    than float32 is drawn in float32 and cast, as the reference's is,
    slices of its leading axis at a time (``DRAW_ELEMENTS``)."""
    lead = () if n_nodes is None else (n_nodes,)
    if d.init == "zeros":
        return torch.zeros(lead + d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(lead + d.shape, dtype=d.dtype, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = d.scale / math.sqrt(max(fan_in, 1))
    x = torch.empty(lead + d.shape, dtype=d.dtype, device=device)
    first = x if n_nodes is None else x[0]
    if d.dtype == torch.float32:
        torch.randn(d.shape, generator=gen, out=first)
        first.mul_(std)
    else:
        rows = max(1, DRAW_ELEMENTS // max(math.prod(d.shape[1:]), 1))
        for r0 in range(0, d.shape[0], rows):
            part = first[r0:r0 + rows]
            draw = torch.randn(part.shape, generator=gen, device=device)
            part.copy_(draw.mul_(std))
            del draw
    if n_nodes is not None:
        x[1:] = first
    return x


def init_params(defs: Any, seed: int, device,
                n_nodes: int | None = None, tp: int = 1,
                tp_rank: int = 0) -> Any:
    """Random parameters from ``defs`` (normal(0, scale/sqrt(fan_in)),
    zeros or ones where declared; only normal leaves draw), drawn from
    one ``torch.Generator`` on ``device`` seeded with ``seed``, leaves in
    JAX order.  With ``n_nodes`` every leaf
    gets a leading node axis holding identical replicas: all consensus
    nodes start from the same x0, as in the reference.  With ``tp`` > 1
    each leaf is drawn whole and model index ``tp_rank``'s slice kept, so
    every ``tp`` draws the same model wherever its shapes are the same
    (a padded vocabulary is another shape)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    leaves, treedef = T.tree_flatten(defs)
    if tp == 1:
        return T.tree_unflatten(treedef, [
            _init_tensor(d, gen, device, n_nodes) for d in leaves])
    out = []
    for d in leaves:
        x = tp_slice(_init_tensor(d, gen, device), d, tp, tp_rank)
        if n_nodes is not None:
            x = x.unsqueeze(0).expand((n_nodes,) + x.shape)
        out.append(x.contiguous())
    return T.tree_unflatten(treedef, out)


def meta_params(defs: Any, tp: int = 1) -> Any:
    """Shape-only (``meta`` device) parameters: layouts without memory
    (a model index's shapes at ``tp`` > 1)."""
    return T.tree_map(lambda d: torch.empty(logical_shape_local(d, tp),
                                            dtype=d.dtype, device="meta"),
                      defs)


def params_from_jax(tree_of_numpy: Any, defs: Any, device=None,
                    n_nodes: int | None = None, *, tp: int = 1,
                    tp_rank: int = 0, node: int | None = None) -> Any:
    """The weight carry: the JAX package's single-node logical parameter
    tree (its arrays converted to numpy) -> the port's tree of tensors on
    ``device`` (``cuda`` unless ``device="cpu"``).  With ``node`` the tree
    is the reference's storage layout instead (every node's replica
    concatenated on each leaf's ``fsdp_dim``, FSDP 1, the tp dim whole),
    and node ``node``'s replica is carried.  At ``tp`` > 1 model index
    ``tp_rank``'s slice of each leaf is kept.

    Both packages flatten in the same order and use the same layouts, so
    the carry is a checked leaf-for-leaf copy; with ``n_nodes`` the leaves
    are replicated along a leading node axis.  Each leaf takes its
    ParamDef's dtype; a bfloat16 leaf (numpy's ``ml_dtypes.bfloat16``,
    which the port does not import) must be declared bfloat16, and goes
    through float32, exactly, and back to bfloat16."""
    device = resolve_device(device)
    arrays, treedef = T.tree_flatten(tree_of_numpy)
    dleaves, dtreedef = T.tree_flatten(defs)
    if treedef != dtreedef:
        raise ValueError("JAX parameter tree does not match the port's "
                         "ParamDef tree")
    out = []
    for a, d in zip(arrays, dleaves):
        if node is not None:
            f = d.shape[d.fsdp_dim]
            if a.shape[d.fsdp_dim] % f:
                raise ValueError(f"JAX storage leaf {a.shape} holds no "
                                 f"whole replicas of {d.shape}")
            a = np.take(a, np.arange(node * f, (node + 1) * f),
                        axis=d.fsdp_dim)
        if tuple(a.shape) != tuple(d.shape):
            raise ValueError(f"JAX leaf shape {a.shape} != {d.shape}")
        if (str(a.dtype) == "bfloat16") != (d.dtype == torch.bfloat16):
            raise ValueError(f"JAX leaf dtype {a.dtype} != {d.dtype}")
        x = torch.from_numpy(np.array(a, np.float32))
        x = tp_slice(x, d, tp, tp_rank).contiguous().to(device, d.dtype)
        if n_nodes is not None:
            x = x.unsqueeze(0).repeat((n_nodes,) + (1,) * x.dim())
        out.append(x)
    return T.tree_unflatten(treedef, out)


#: dtypes of the reference's consensus-state entries: the packed shadows,
#: the push-sum weights, and the async exchange's in-flight payloads (with
#: the push-sum trailer when there is one)
_CONSENSUS_DTYPES = {"x_tilde": torch.float32, "m_agg": torch.float32,
                     "ps_w": torch.float32, "ps_nbr": torch.float32,
                     "fly_self": torch.uint8, "fly_up": torch.uint8,
                     "fly_dn": torch.uint8}


def consensus_state_from_jax(state_of_numpy: dict, n_nodes: int,
                             device=None) -> dict:
    """The reference's consensus state (its arrays converted to numpy) ->
    the port's, on ``device`` (``cuda`` unless ``device="cpu"``).

    The reference keeps it device-major: the packed shadows ``(n_dev,
    n_rows, BLOCK)`` float32, the push-sum weights ``ps_w`` ``(n_dev, 1)``
    and ``ps_nbr`` ``(n_dev, 2)`` float32, and the async in-flight
    payloads ``(n_dev, nbytes)`` uint8.  With one device per node, as the port's stacked
    nodes are, the device axis is the node axis ``N``."""
    device = resolve_device(device)
    out = {}
    for key, a in state_of_numpy.items():
        if key not in _CONSENSUS_DTYPES:
            raise ValueError(f"consensus state entry {key!r} is not ported; "
                             f"have {sorted(_CONSENSUS_DTYPES)}")
        dtype = _CONSENSUS_DTYPES[key]
        if a.shape[0] != n_nodes:
            raise ValueError(f"{key}: {a.shape[0]} devices != {n_nodes} "
                             "nodes (one device per node)")
        out[key] = torch.from_numpy(np.array(a)).to(device, dtype)
    return out
