"""Parameter declarations, initialisation and the weight carry from JAX.

Counterpart of ``repro.models.params`` on one device: a :class:`ParamDef`
declares one tensor's logical per-node shape and initialiser.  There is no
tensor or FSDP parallelism here, so the reference's ``tp_dim``/``fsdp_dim``
have no counterpart; consensus nodes are a leading axis instead.  A
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
           "consensus_state_from_jax"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declaration of one parameter tensor (logical, per node)."""

    shape: tuple[int, ...]
    init: str = "normal"            # normal | zeros | ones
    scale: float = 1.0              # stddev multiplier for 'normal'
    dtype: torch.dtype = torch.float32

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
                n_nodes: int | None = None) -> Any:
    """Random parameters from ``defs`` (normal(0, scale/sqrt(fan_in)),
    zeros or ones where declared; only normal leaves draw), drawn from
    one ``torch.Generator`` on ``device`` seeded with ``seed``, leaves in
    JAX order.  With ``n_nodes`` every leaf
    gets a leading node axis holding identical replicas: all consensus
    nodes start from the same x0, as in the reference."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    leaves, treedef = T.tree_flatten(defs)
    return T.tree_unflatten(treedef, [_init_tensor(d, gen, device, n_nodes)
                                      for d in leaves])


def meta_params(defs: Any) -> Any:
    """Shape-only (``meta`` device) parameters: layouts without memory."""
    return T.tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                            device="meta"), defs)


def params_from_jax(tree_of_numpy: Any, defs: Any, device=None,
                    n_nodes: int | None = None) -> Any:
    """The weight carry: the JAX package's single-node logical parameter
    tree (its arrays converted to numpy) -> the port's tree of tensors on
    ``device`` (``cuda`` unless ``device="cpu"``).

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
        if tuple(a.shape) != tuple(d.shape):
            raise ValueError(f"JAX leaf shape {a.shape} != {d.shape}")
        if (str(a.dtype) == "bfloat16") != (d.dtype == torch.bfloat16):
            raise ValueError(f"JAX leaf dtype {a.dtype} != {d.dtype}")
        x = torch.from_numpy(np.array(a, np.float32)).to(device, d.dtype)
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
