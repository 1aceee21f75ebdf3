"""Optimizers over parameter trees (counterpart of ``repro.optim``).

Functional, like the reference: ``step(state, params, grads, lr)`` returns
new parameter and state trees and leaves its inputs untouched.  Leaves may
carry a leading consensus-node axis; every update is elementwise.
``Sgd`` is the paper-faithful choice (DGD/ADC-DGD are plain gradient
descent); ``Momentum`` and ``Adam`` are the production extensions.

Leaves of another dtype than float32 (bfloat16 parameters) follow the
reference as XLA compiles it: a Python constant (``beta``,
``weight_decay``) is weakly typed, so it is rounded to the leaf's dtype
and each product or sum of such leaves is rounded; the learning rate is a
float32 array, so the update ``p - lr * d`` is float32 arithmetic, which
XLA contracts into one fused multiply-add, then rounded once to the
leaf's dtype; and a bfloat16 result whose only use is that float32 update
(the direction ``d``) is never rounded, because XLA drops a rounding that
is followed by a cast back to float32.  Float32 leaves take the float32
arithmetic they always did.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import tree as T

__all__ = ["Optimizer", "Sgd", "Momentum", "Adam", "by_name"]


def _weak(c: float, like: torch.Tensor) -> float:
    """A weakly typed Python constant as the reference's arithmetic sees it
    beside ``like``: rounded to ``like``'s dtype."""
    return float(torch.tensor(c, dtype=like.dtype))


def _update(p: torch.Tensor, lr: float, d: torch.Tensor) -> torch.Tensor:
    """``p - lr * d`` of a leaf stored in another dtype than float32, with
    ``d`` float32: one float32 fused multiply-add (the float64 product of
    two float32 values is exact), rounded to ``p``'s dtype."""
    return (p.double() - lr * d.double()).float().to(p.dtype)


def _map_n(fn, n_out: int, *trees):
    """tree_map for a function returning ``n_out`` values: a tuple of
    ``n_out`` result trees."""
    flats = [T.tree_flatten(t) for t in trees]
    treedef = flats[0][1]
    outs = [fn(*leaves) for leaves in zip(*[f[0] for f in flats])]
    return tuple(T.tree_unflatten(treedef, [o[i] for o in outs])
                 for i in range(n_out))


class Optimizer:
    """init(params) -> state; step(state, params, grads, lr) ->
    (new_params, new_state)."""

    def init(self, params: Any) -> Any:
        raise NotImplementedError

    def step(self, state: Any, params: Any, grads: Any,
             lr: float) -> tuple[Any, Any]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Sgd(Optimizer):
    """x <- x - lr * g  (the gradient step of paper Algorithm 1/2)."""

    weight_decay: float = 0.0

    def init(self, params):
        return ()

    def step(self, state, params, grads, lr):
        def upd(p, g):
            if p.dtype == torch.float32:
                if self.weight_decay:
                    g = g + self.weight_decay * p
                return (p - lr * g).to(p.dtype)
            d = g.float()
            if self.weight_decay:
                d = d + (_weak(self.weight_decay, p) * p).float()
            return _update(p, lr, d)
        return T.tree_map(upd, params, grads), state


@dataclasses.dataclass(frozen=True)
class Momentum(Optimizer):
    beta: float = 0.9
    nesterov: bool = False
    weight_decay: float = 0.0

    def init(self, params):
        return {"m": T.tree_map(torch.zeros_like, params)}

    def step(self, state, params, grads, lr):
        def upd(p, g, m):
            if p.dtype == torch.float32:
                if self.weight_decay:
                    g = g + self.weight_decay * p
                m_new = self.beta * m + g
                d = g + self.beta * m_new if self.nesterov else m_new
                return (p - lr * d).to(p.dtype), m_new
            # m keeps the parameters' dtype; d is float32 (module doc)
            if self.weight_decay:
                g = g + _weak(self.weight_decay, p) * p
            beta = _weak(self.beta, m)
            m32 = (beta * m).float() + g.float()
            m_new = m32.to(m.dtype)
            d = (g.float() + (beta * m_new).float() if self.nesterov
                 else m32)
            return _update(p, lr, d), m_new
        new_p, new_m = _map_n(upd, 2, params, grads, state["m"])
        return new_p, {"m": new_m}


@dataclasses.dataclass(frozen=True)
class Adam(Optimizer):
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                      device=p.device)
        return {"m": T.tree_map(zeros, params),
                "v": T.tree_map(zeros, params), "t": 0}

    def step(self, state, params, grads, lr):
        t = state["t"] + 1
        b1t = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(t))
        b2t = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(t))

        def upd(p, g, m, v):
            g32 = g.to(torch.float32)
            m_new = self.b1 * m + (1 - self.b1) * g32
            v_new = self.b2 * v + (1 - self.b2) * g32 * g32
            step = (m_new / b1t) / (torch.sqrt(v_new / b2t) + self.eps)
            if self.weight_decay:
                step = step + self.weight_decay * p.to(torch.float32)
            return ((p.to(torch.float32) - lr * step).to(p.dtype), m_new,
                    v_new)

        new_p, new_m, new_v = _map_n(upd, 3, params, grads, state["m"],
                                     state["v"])
        return new_p, {"m": new_m, "v": new_v, "t": t}


def by_name(name: str, **kw) -> Optimizer:
    reg = {"sgd": Sgd, "momentum": Momentum, "adam": Adam}
    if name not in reg:
        raise KeyError(f"unknown optimizer {name!r}; have {sorted(reg)}")
    return reg[name](**kw)
