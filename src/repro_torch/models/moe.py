"""Mixture-of-experts FFN on one device.

Counterpart of ``repro.models.moe`` at tensor-parallel degree 1: the
router is a ``(d, E)`` matrix, every routed expert a gated MLP of width
``moe_d_ff`` stacked on a leading expert axis, and the optional shared
experts (deepseek) one dense gated MLP of width ``n_shared_experts *
moe_d_ff``.  There is no expert axis to shard over, so no expert is
padded and there is no psum.

The semantics are the reference's, step by step (:func:`route`, then
:func:`moe_forward`):

* the router logits as one product with a float32 result (the
  reference casts the compute-dtype product to float32, which XLA
  computes so: ``layers.dot_f32``), a float32 softmax over them, and its
  top ``top_k``
  probabilities renormalised by ``max(sum, 1e-9)``; equal probabilities
  go to the lower expert id first, as ``lax.top_k`` takes them;
* the Switch auxiliary loss ``E * sum_e f_e * P_e`` (``f_e`` the share of
  assignments to expert e, ``P_e`` its mean probability);
* a capacity of ``max(1, ceil(t * top_k / E * capacity_factor))`` slots
  per expert, reckoned in Python floats; each (token, k) assignment, in
  token-major order, takes the next slot of its expert, and assignments
  past the capacity are dropped;
* every expert's gated FFN on its ``(C, d)`` slots, empty ones included
  (zero rows), so every expert weight gets a gradient, in the compute
  dtype, its output scaled by the routing weight rounded to that dtype;
* the weighted combine: each token's kept contributions added in
  ascending expert id, ``((0 + c_e1) + c_e2) + ...``, the order of the
  reference's expert-major scatter-add, in the experts' output dtype and
  rounded at each add (XLA's CPU scatter-add keeps no excess precision in
  bfloat16).  The port forms that sum by gathers, never by atomics, so
  it is the same on every run;
* the shared experts added after it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _act, dot_f32
from repro_torch.models.params import ParamDef

__all__ = ["Routing", "moe_defs", "route", "moe_forward"]


def moe_defs(cfg: ModelConfig, dtype=torch.float32) -> dict:
    d, ffe, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    if ffe <= 0 or cfg.top_k <= 0:
        raise ValueError(f"{cfg.arch_id}: an MoE block needs moe_d_ff > 0 "
                         f"and top_k > 0, got {ffe} and {cfg.top_k}")
    out = {"router": ParamDef((d, e), dtype=dtype),
           "w_gate": ParamDef((e, d, ffe), dtype=dtype),
           "w_up": ParamDef((e, d, ffe), dtype=dtype),
           "w_down": ParamDef((e, ffe, d), dtype=dtype)}
    if cfg.n_shared_experts > 0:
        ffs = cfg.n_shared_experts * ffe
        out["shared"] = {"w_gate": ParamDef((d, ffs), dtype=dtype),
                         "w_up": ParamDef((d, ffs), dtype=dtype),
                         "w_down": ParamDef((ffs, d), dtype=dtype)}
    return out


@dataclasses.dataclass
class Routing:
    """The router's decisions for ``t`` tokens (``k`` = top_k, ``E``
    experts, ``C`` = ``capacity``).  ``top_e``, ``top_p``, ``keep`` and
    ``slot`` are ``(t, k)`` in the router's order (descending probability);
    ``slot`` is ``e * C + rank`` for a kept assignment and ``E * C`` (no
    slot) for a dropped one."""

    probs: torch.Tensor         # (t, E) float32 softmax
    top_e: torch.Tensor         # (t, k) int64 expert ids
    top_p: torch.Tensor         # (t, k) float32, renormalised
    capacity: int
    keep: torch.Tensor          # (t, k) bool: rank < capacity
    slot: torch.Tensor          # (t, k) int64
    aux: torch.Tensor           # () float32 load-balance loss


def route(router: torch.Tensor, xf: torch.Tensor,
          cfg: ModelConfig) -> Routing:
    """Top-k routing of tokens ``xf`` (t, d) with capacity-limited slots."""
    t = xf.shape[0]
    n_exp, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(dot_f32(xf, router), dim=-1)
    # a stable descending sort: among equal probabilities the lower expert
    # id comes first (torch.topk promises no order for ties)
    srt_p, srt_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = srt_p[:, :k], srt_e[:, :k]
    top_p = top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9)

    flat_e = top_e.reshape(-1)                             # token-major
    counts = torch.zeros(n_exp, dtype=torch.float32, device=xf.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e,
                                                   dtype=torch.float32))
    aux = n_exp * torch.sum(counts / t * probs.mean(dim=0))

    capacity = max(1, int(math.ceil(t * k / n_exp * cfg.capacity_factor)))
    # rank of each assignment within its expert, counted in the flat
    # (token, k) order: a stable sort by expert keeps that order
    order = torch.argsort(flat_e, stable=True)
    n_per = counts.to(torch.int64)
    starts = torch.cumsum(n_per, 0) - n_per
    rank = torch.empty_like(flat_e)
    rank[order] = (torch.arange(flat_e.numel(), device=xf.device)
                   - starts[flat_e[order]])
    keep = rank < capacity
    slot = torch.where(keep, flat_e * capacity + rank, n_exp * capacity)
    return Routing(probs=probs, top_e=top_e, top_p=top_p, capacity=capacity,
                   keep=keep.view(t, k), slot=slot.view(t, k), aux=aux)


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d).  Returns (out (b, s, d), the auxiliary loss)."""
    b, s, d = x.shape
    t = b * s
    n_exp, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(t, d)
    r = route(p["router"], xf, cfg)
    cap = r.capacity
    n_slots = n_exp * cap

    # the slot tables; dropped assignments land on one spare slot at the
    # end, which is cut off
    slot = r.slot.reshape(-1)
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    tok_s = torch.zeros(n_slots + 1, dtype=torch.int64,
                        device=x.device).index_put_((slot,), tok)[:-1]
    used = torch.zeros(n_slots + 1, dtype=x.dtype,
                       device=x.device).index_put_(
        (slot,), torch.ones_like(tok, dtype=x.dtype))[:-1]
    w_s = torch.zeros(n_slots + 1, dtype=r.top_p.dtype,
                      device=x.device).index_put(
        (slot,), r.top_p.reshape(-1))[:-1]

    xe = xf[tok_s].mul_(used[:, None]).view(n_exp, cap, d)
    h = _act(cfg.mlp_act, xe @ p["w_gate"]) * (xe @ p["w_up"])
    del xe          # without autograd, the slots' rows are freed here
    ye = (h @ p["w_down"]) * w_s.to(x.dtype).view(n_exp, cap, 1)
    del h

    # each token's kept contributions, in ascending expert id
    order = torch.argsort(r.top_e, dim=1)
    kept = r.keep.gather(1, order)
    idx = torch.where(kept, r.slot.gather(1, order), 0)
    contrib = torch.where(kept[..., None], ye.reshape(n_slots, d)[idx], 0.0)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]

    if "shared" in p:
        sp = p["shared"]
        hs = _act(cfg.mlp_act, xf @ sp["w_gate"]) * (xf @ sp["w_up"])
        out = out + hs @ sp["w_down"]
    return out.reshape(b, s, d), r.aux
