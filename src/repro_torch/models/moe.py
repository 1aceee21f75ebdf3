"""Mixture-of-experts FFN, on one device or expert-parallel over a node's
ranks.

Counterpart of ``repro.models.moe``: the router is a ``(d, E_pad)``
matrix, every routed expert a gated MLP of width ``moe_d_ff`` stacked on
a leading expert axis, and the optional shared experts (deepseek) one
dense gated MLP of width ``n_shared_experts * moe_d_ff``.  On one device
``E_pad`` is ``E``; at ``ctx.tp`` > 1 the expert axis is split over the
ranks and padded to :func:`padded_experts` with dead experts, whose router
columns are drawn like the others and masked to -1e30 before the softmax
(granite's 40 experts are 48 at tp 16, reduced granite's 4 are 6 at tp 3).

The semantics are the reference's, step by step (:func:`route`, then
:func:`moe_forward`):

* the router logits as one product with a float32 result (the
  reference casts the compute-dtype product to float32, which XLA
  computes so: ``layers.dot_f32``), a float32 softmax over them, and its
  top ``top_k``
  probabilities renormalised by ``max(sum, 1e-9)``; equal probabilities
  go to the lower expert id first, as ``lax.top_k`` takes them;
* the Switch auxiliary loss ``E * sum_e f_e * P_e`` (``f_e`` the share of
  assignments to expert e, ``P_e`` its mean probability; ``E`` the real
  count);
* a capacity of ``max(1, ceil(t * top_k / E * capacity_factor))`` slots
  per expert (``E`` the real count), reckoned in Python floats; each
  (token, k) assignment, in token-major order, takes the next slot of its
  expert, and assignments past the capacity are dropped;
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

Expert parallelism (``ctx.tp`` > 1, the reference's): every rank routes
every token over all ``E_pad`` experts (replicated compute, the same bits
on each rank, so the drop count :func:`route` leaves is the node's, the
sum of what each rank's own experts drop), runs its ``E_pad / tp`` local
experts, ids ``[r * E_local, (r + 1) * E_local)``, on their slots (a rank
whose experts received no token still runs them on zero rows, so that
every rank issues the same collectives), adds each token's kept rows of
its experts in ascending id and sums the ranks' partial outputs
(``psum_tp``: the reference's per-rank scatter-add, then its psum).  The
shared experts split their width as a dense MLP does and are summed over
the ranks after it.  The router's gradient has two parts: the routing
weights the rank's experts read give a rank-partial cotangent, so they
enter the experts through ``copy_tp`` (its backward sums the ranks'),
while the auxiliary loss is taken on the replicated probabilities and
gives a complete one on every rank.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ONE_DEVICE, _act, dot_f32
from repro_torch.models.params import ParamDef

__all__ = ["Routing", "moe_defs", "route", "assign", "moe_forward",
           "padded_experts"]

#: router logit of a dead (padding) expert (the reference's)
DEAD = -1e30


def padded_experts(cfg: ModelConfig, tp: int) -> int:
    """The expert axis at ``tp``: ``n_experts`` rounded up to a multiple of
    ``tp`` (reference ``moe.py``)."""
    tp = max(tp, 1)
    return int(math.ceil(cfg.n_experts / tp) * tp)


def moe_defs(cfg: ModelConfig, dtype=torch.float32, ctx=ONE_DEVICE) -> dict:
    """The router (replicated), the routed experts split on the expert
    axis, padded to :func:`padded_experts`, and the shared experts split
    as a dense MLP, at ``ctx.tp`` (reference ``moe_defs``)."""
    d, ffe = cfg.d_model, cfg.moe_d_ff
    e = padded_experts(cfg, ctx.tp)
    if ffe <= 0 or cfg.top_k <= 0:
        raise ValueError(f"{cfg.arch_id}: an MoE block needs moe_d_ff > 0 "
                         f"and top_k > 0, got {ffe} and {cfg.top_k}")
    out = {"router": ParamDef((d, e), dtype=dtype),
           "w_gate": ParamDef((e, d, ffe), dtype=dtype, tp_dim=0, fsdp_dim=1),
           "w_up": ParamDef((e, d, ffe), dtype=dtype, tp_dim=0, fsdp_dim=1),
           "w_down": ParamDef((e, ffe, d), dtype=dtype, tp_dim=0,
                              fsdp_dim=1)}
    if cfg.n_shared_experts > 0:
        ffs = cfg.n_shared_experts * ffe
        if ffs % ctx.tp:
            raise ValueError(f"{cfg.arch_id}: the shared experts' width {ffs} "
                             f"does not split over tp={ctx.tp}")
        out["shared"] = {"w_gate": ParamDef((d, ffs), dtype=dtype, tp_dim=1),
                         "w_up": ParamDef((d, ffs), dtype=dtype, tp_dim=1),
                         "w_down": ParamDef((ffs, d), dtype=dtype, tp_dim=0,
                                            fsdp_dim=1)}
    return out


@dataclasses.dataclass
class Routing:
    """The router's decisions for ``t`` tokens (``k`` = top_k, ``E``
    experts with the dead ones of the padded axis, ``C`` = ``capacity``).
    ``top_e``, ``top_p``, ``keep`` and ``slot`` are ``(t, k)`` in the
    router's order (descending probability); ``slot`` is ``e * C + rank``
    for a kept assignment and ``E * C`` (no slot) for a dropped one."""

    probs: torch.Tensor         # (t, E) float32 softmax
    top_e: torch.Tensor         # (t, k) int64 expert ids
    top_p: torch.Tensor         # (t, k) float32, renormalised
    capacity: int
    keep: torch.Tensor          # (t, k) bool: rank < capacity
    slot: torch.Tensor          # (t, k) int64
    aux: torch.Tensor           # () float32 load-balance loss


def route(router: torch.Tensor, xf: torch.Tensor,
          cfg: ModelConfig) -> Routing:
    """Top-k routing of tokens ``xf`` (t, d) with capacity-limited slots
    over the router's columns (the experts past ``cfg.n_experts`` are
    dead: masked to :data:`DEAD`), its slots by :func:`assign`."""
    n_real, k = cfg.n_experts, cfg.top_k
    n_exp = router.shape[-1]
    logits = dot_f32(xf, router)
    if n_exp > n_real:
        dead = torch.arange(n_exp, device=xf.device) >= n_real
        logits = torch.where(dead, DEAD, logits)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: among equal probabilities the lower expert
    # id comes first (torch.topk promises no order for ties)
    srt_p, srt_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    return assign(probs, srt_p[:, :k], srt_e[:, :k], cfg)


def assign(probs: torch.Tensor, top_p: torch.Tensor, top_e: torch.Tensor,
           cfg: ModelConfig) -> Routing:
    """The routing of tokens whose experts ``top_e`` (t, k) were chosen,
    with their probabilities ``top_p`` out of ``probs`` (t, E): the
    weights renormalised, the auxiliary loss, the capacity and each
    assignment's slot."""
    t, n_exp = probs.shape
    n_real, k = cfg.n_experts, cfg.top_k
    top_p = top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9)

    flat_e = top_e.reshape(-1)                             # token-major
    counts = torch.zeros(n_exp, dtype=torch.float32, device=probs.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e,
                                                   dtype=torch.float32))
    aux = n_real * torch.sum(counts / t * probs.mean(dim=0))

    capacity = max(1, int(math.ceil(t * k / n_real * cfg.capacity_factor)))
    # rank of each assignment within its expert, counted in the flat
    # (token, k) order: a stable sort by expert keeps that order
    order = torch.argsort(flat_e, stable=True)
    n_per = counts.to(torch.int64)
    starts = torch.cumsum(n_per, 0) - n_per
    rank = torch.empty_like(flat_e)
    rank[order] = (torch.arange(flat_e.numel(), device=probs.device)
                   - starts[flat_e[order]])
    keep = rank < capacity
    slot = torch.where(keep, flat_e * capacity + rank, n_exp * capacity)
    return Routing(probs=probs, top_e=top_e, top_p=top_p, capacity=capacity,
                   keep=keep.view(t, k), slot=slot.view(t, k), aux=aux)


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig, ctx=ONE_DEVICE
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d), the same on every rank.  Returns (out (b, s, d), the
    auxiliary loss); at ``ctx.tp`` > 1 on the rank's experts, summed over
    the ranks (module docstring)."""
    b, s, d = x.shape
    t = b * s
    k = cfg.top_k
    xf = x.reshape(t, d)
    r = route(p["router"], xf, cfg)
    cap = r.capacity
    n_loc = p["w_gate"].shape[0]
    first = ctx.tp_rank * n_loc
    n_slots = n_loc * cap

    # the slot tables of the rank's experts; other ranks' assignments and
    # dropped ones land on one spare slot at the end, which is cut off
    kept = r.keep & (r.top_e >= first) & (r.top_e < first + n_loc)
    slot_l = torch.where(kept, r.slot - first * cap, n_slots)
    slot = slot_l.reshape(-1)
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    tok_s = torch.zeros(n_slots + 1, dtype=torch.int64,
                        device=x.device).index_put_((slot,), tok)[:-1]
    used = torch.zeros(n_slots + 1, dtype=x.dtype,
                       device=x.device).index_put_(
        (slot,), torch.ones_like(tok, dtype=x.dtype))[:-1]
    # the routing weights' cotangent is the rank's experts' part
    w_s = torch.zeros(n_slots + 1, dtype=r.top_p.dtype,
                      device=x.device).index_put(
        (slot,), ctx.copy_tp(r.top_p).reshape(-1))[:-1]

    xin = ctx.copy_tp(xf)
    xe = xin[tok_s].mul_(used[:, None]).view(n_loc, cap, d)
    h = _act(cfg.mlp_act, xe @ p["w_gate"]) * (xe @ p["w_up"])
    del xe          # without autograd, the slots' rows are freed here
    ye = (h @ p["w_down"]) * w_s.to(x.dtype).view(n_loc, cap, 1)
    del h

    # each token's kept contributions, in ascending expert id
    order = torch.argsort(r.top_e, dim=1)
    kept = kept.gather(1, order)
    idx = torch.where(kept, slot_l.gather(1, order), 0)
    contrib = torch.where(kept[..., None], ye.reshape(n_slots, d)[idx], 0.0)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    out = ctx.psum_tp(out)

    if "shared" in p:
        sp = p["shared"]
        hs = _act(cfg.mlp_act, xin @ sp["w_gate"]) * (xin @ sp["w_up"])
        out = out + ctx.psum_tp(hs @ sp["w_down"])
    return out.reshape(b, s, d), r.aux
