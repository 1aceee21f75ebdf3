"""Transformer layers, on one device or tensor-parallel over a node's ranks.

Counterpart of ``repro.models.layers``, for the blocks of the ported
configurations: gated MLPs (SwiGLU, or GeGLU with the tanh-approximate
gelu; ``models.moe`` stacks them into experts), optional q/k norms,
tied or untied embeddings, attention and final softcaps, the
``sqrt(d_model)`` embedding scale, sliding-window ('L') as well as
global ('A', 'E', 'D') attention, and for the encoder-decoder (whisper)
attention without RoPE, bidirectional attention and the sinusoidal
positions of the encoder.  ``transformer.build_defs`` refuses
configurations outside that.  Layouts follow the reference at every public
function: activations ``(b, s, d)``, grouped queries ``(b, s, kvh, g,
hd)``, weights ``(d_in, d_out)``, KV caches ``(b, S, kvh, hd)``.

Precision follows the reference's at its compute dtype (float32 or
bfloat16, the parameters' dtype): activations and matrix products run in
the compute dtype, one rounding per operation, while RMS-norm statistics,
RoPE, attention scores, the softmax and its weighted sum run in float32
(``chunked_attention``'s products take compute-dtype operands with
float32 results, as the reference's ``preferred_element_type=float32``
does), and the logits are float32.  Under ``jit`` XLA computes a
compute-dtype matrix product whose only use is a cast to float32 as one
product with a float32 result, never rounded to the compute dtype; the
port does the same wherever the reference casts a product up
(:func:`dot_f32`: the logits here, the MoE router, Mamba2's ``dt`` and
gate).  At float32 all of this is the float32 arithmetic it always was.

Tensor parallelism (``ctx``, a ``models.sharding.ParallelContext``;
the default is the one-device context, ``tp`` 1, where every collective
is the identity and a rank's slice is the whole leaf) follows the
reference's paths at their lines.  Each function takes a model index's
parameters (``params.logical_shape_local``) and the replicated stream
``(b, s, d)``, the same bits on every rank.  Attention
is head-sharded when ``n_heads % tp == 0`` (q, o and, when ``n_kv_heads
>= tp``, k and v split on the head dim; with fewer kv heads than ranks k
and v are replicated and a rank slices the kv head ``(r * h_local) //
(n_heads / n_kv_heads)`` its q heads use), else sequence-sharded (every
projection replicated; in train and prefill each rank projects its
``s / tp`` positions, all-gathers K and V, attends its queries and
all-gathers the output; the prefill's cache holds every position and
head on every rank, and decode runs every head on every rank without a
sum).  The MLP splits ``d_ff``; the embedding table, the unembedding and
the logits split the vocabulary, padded to a multiple of ``tp * 128``
(:func:`padded_vocab`: the padded columns are drawn like the others and
enter the softmax and the argmax, as in the reference).  A replicated
tensor that enters rank-partial compute goes through ``ctx.copy_tp``
(its backward sums the ranks' cotangents): the stream before each
projection, and every replicated weight used on a rank's own heads or
positions (a replicated kv projection, the q/k norms, all attention
weights of the sequence-sharded path).  :func:`kv_weights` gives a rank's
k and v projections, to the self and the cross attention alike.

``attention_forward`` runs in three modes, as the reference's does:
``train`` (the causal forward, ``chunked_attention``; bidirectional with
``causal=False``), ``prefill`` (the same, returning the prompt's K and V,
rotated unless ``use_rope=False``, as the decode cache) and
``decode`` (one token against the cache through the flash-decode kernel,
``kernels.gqa_decode``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef
from repro_torch.models.sharding import local_context

__all__ = ["widen", "dot_f32", "rms_norm", "rope_freqs", "apply_rope",
           "sinusoidal_positions", "chunked_attention",
           "decode_attention_local", "combine_decode_partials",
           "attention_defs", "attention_forward", "mlp_defs", "mlp_forward",
           "embed_defs", "embed_lookup", "logits_local",
           "sharded_softmax_xent", "sharded_greedy_sample", "norm_def",
           "padded_vocab", "head_sharded", "kv_weights"]

#: score of a masked position (the reference's -1e30, not -inf)
NEG = -1e30


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 (exact from bfloat16), or as it is when it is
    float32 or wider (float64 forwards are a measuring aid)."""
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with a float32 result from bfloat16 operands: they widen
    to float32 exactly, so each product is exact and the sum is float32's,
    what XLA computes for a bfloat16 product that is only ever cast to
    float32.  At float32 it is ``x @ w``."""
    return torch.matmul(widen(x), widen(w))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)``; weights initialise to 0.
    The variance is float32; the scale, ``1 + w`` and both products are in
    ``x``'s dtype, each rounded (the reference's order)."""
    var = widen(x).square().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * (1.0 + w.to(x.dtype))


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (b, s, h, hd); positions: (s,).  Rotates the two halves of each
    head against each other (not interleaved pairs), in float32, and
    returns ``x``'s dtype."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]
    ang = ang[None, :, None, :]                            # (1, s, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = widen(x).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) float32 table: ``sin(pos * div)`` in the even columns and
    ``cos(pos * div)`` in the odd ones, ``div = exp(arange(0, d, 2) *
    f32(-log(1e4) / d))``, in the reference's float32 order.  ``exp``,
    ``sin`` and ``cos`` are evaluated in float64 and rounded, so each
    value is the correctly rounded one of its float32 argument: the
    compiled reference's ``exp`` is, and its ``sin``/``cos`` lie within an
    ulp of it, where float32 ``torch.exp`` is an ulp off in 5 of 384
    entries at d 768 and so moves angles up to 1,503 rad by ~1e-4."""
    arg = torch.arange(0, d, 2, dtype=torch.float32, device=device) \
        * float(np.float32(-math.log(10000.0) / d))
    div = torch.exp(arg.double()).float()
    ang = (torch.arange(n, dtype=torch.float32, device=device)[:, None]
           * div).double()
    pe = torch.empty((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def _divisor_chunk(s: int, target: int) -> int:
    """Largest chunk size <= target that divides s."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def _softcap(s: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return s
    return cap * torch.tanh(s / cap)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      softcap: float | None = None, q_offset: int = 0,
                      k_offset: int = 0, chunk_q: int = 512,
                      chunk_k: int = 1024) -> torch.Tensor:
    """Online-softmax attention over ``(chunk_q, chunk_k)`` blocks (each a
    divisor of its length), the reference's arithmetic block for block:
    scores scaled by ``1/sqrt(hd)``, softcapped, masked to -1e30 (causal:
    ``qpos >= kpos``; window: ``qpos - kpos < window``; positions count
    from ``q_offset`` and ``k_offset``), then the running max, denominator
    and weighted sum; the output is ``acc / max(l, 1e-30)`` in ``q``'s
    dtype.  Only one block's scores exist at a time.

    Both products take operands in the input dtype (``p`` rounded to it)
    and give float32 results; the softmax statistics are float32.  When
    autograd records and there is more than one query chunk, each query
    chunk runs under ``torch.utils.checkpoint``, as the reference wraps it
    in ``jax.checkpoint``: its backward recomputes the chunk's scores from
    q, K and V instead of keeping every block's scores and probabilities
    (the same bits either way).

    q: (b, sq, kvh, g, hd); k, v: (b, sk, kvh, hd) -> (b, sq, kvh, g, hd).
    """
    b, sq, kvh, g, hd = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    cq, ck = _divisor_chunk(sq, chunk_q), _divisor_chunk(sk, chunk_k)
    qh = q.permute(0, 2, 3, 1, 4)                          # (b,kvh,g,sq,hd)
    # the operands widen to float32 exactly: products of the input dtype
    # with float32 accumulation and results
    kh = widen(k.permute(0, 2, 3, 1).unsqueeze(2))         # (b,kvh,1,hd,sk)
    vh = widen(v.permute(0, 2, 1, 3).unsqueeze(2))         # (b,kvh,1,sk,hd)
    ar_q = torch.arange(cq, device=q.device)
    ar_k = torch.arange(ck, device=q.device)

    def q_step(qi: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
               q0: int) -> torch.Tensor:
        qpos = (q_offset + q0 + ar_q)[:, None]
        qi = widen(qi)
        m = torch.full((b, kvh, g, cq), NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, kvh, g, cq, hd), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, sk, ck):
            kpos = (k_offset + k0 + ar_k)[None, :]
            s = _softcap(torch.matmul(qi, kh[..., k0:k0 + ck]) * scale,
                         softcap)
            mask = torch.ones((cq, ck), dtype=torch.bool, device=q.device)
            if causal:
                mask &= qpos >= kpos
            if window is not None:
                mask &= qpos - kpos < window
            s = torch.where(mask, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.matmul(widen(p.to(q.dtype)), vh[..., k0:k0 + ck, :])
            acc = acc * corr[..., None] + pv
            m = m_new
        return acc / torch.clamp_min(l, 1e-30)[..., None]

    recompute = sq > cq and torch.is_grad_enabled()
    outs = []
    for q0 in range(0, sq, cq):
        qi = qh[..., q0:q0 + cq, :]
        outs.append(checkpoint(q_step, qi, kh, vh, q0, use_reentrant=False)
                    if recompute else q_step(qi, kh, vh, q0))
    return torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4).to(q.dtype)


#: the default context: one device, tp 1
ONE_DEVICE = local_context()


def head_sharded(cfg: ModelConfig, tp: int) -> bool:
    """The reference's attention strategy at ``tp``: heads split over the
    ranks when they divide, else the sequence."""
    return cfg.n_heads % max(tp, 1) == 0


def attention_defs(cfg: ModelConfig, dtype=torch.float32, ctx=ONE_DEVICE
                   ) -> dict[str, ParamDef]:
    """q, k, v, o (and the q/k norms) with the reference's ``tp_dim`` /
    ``fsdp_dim`` at ``ctx.tp`` (reference ``attention_defs``)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    tp = ctx.tp
    hs = head_sharded(cfg, tp)
    kv_tp = 1 if hs and kvh >= tp else None
    out = {"wq": ParamDef((d, h * hd), dtype=dtype, tp_dim=1 if hs else None),
           "wk": ParamDef((d, kvh * hd), dtype=dtype, tp_dim=kv_tp),
           "wv": ParamDef((d, kvh * hd), dtype=dtype, tp_dim=kv_tp),
           "wo": ParamDef((h * hd, d), dtype=dtype, tp_dim=0 if hs else None,
                          fsdp_dim=1)}
    if cfg.qk_norm:
        out["q_norm"] = ParamDef((hd,), init="zeros", dtype=dtype)
        out["k_norm"] = ParamDef((hd,), init="zeros", dtype=dtype)
    return out


def decode_attention_local(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, valid: torch.Tensor,
                           softcap: float | None = None):
    """Flash-decode partials of one query token over a cache.

    q: (b, 1, kvh, g, hd); k_cache/v_cache: (b, S, kvh, hd); valid: (S,)
    bool.  Returns (m, l, acc): per-(b, kvh, g) running max, denominator
    and weighted sum (``kernels.gqa_decode``: the CUDA kernel on the card,
    its plain version on the CPU)."""
    if valid.dim() != 1:
        raise NotImplementedError("per-row validity masks (b, S) are not "
                                  "yet ported")
    return kops.gqa_decode(q[:, 0], k_cache, v_cache, valid, softcap)


def combine_decode_partials(m: torch.Tensor, l: torch.Tensor,
                            acc: torch.Tensor) -> torch.Tensor:
    """The attention output of flash-decode partials from one cache shard
    (the reference's combine with no mesh axes): ``acc / max(l, 1e-30)``,
    (b, kvh, g, hd).  ``m`` only matters across shards."""
    del m
    return acc / torch.clamp_min(l, 1e-30)[..., None]


def kv_weights(p, cfg: ModelConfig, ctx=ONE_DEVICE):
    """(wk, wv, kv heads) of the rank at ``ctx.tp``: its ``kvh / tp`` kv
    heads' columns, or with fewer kv heads than ranks the replicated
    projections (through ``ctx.copy_tp``) sliced to the one kv head ``(r *
    h_local) // (n_heads / n_kv_heads)`` its q heads use."""
    hd, tp = cfg.resolved_head_dim, ctx.tp
    kvh = cfg.n_kv_heads
    if kvh >= tp:
        return p["wk"], p["wv"], kvh // tp
    j = (ctx.tp_rank * (cfg.n_heads // tp)) // (cfg.n_heads // kvh)
    return (ctx.copy_tp(p["wk"])[:, j * hd:(j + 1) * hd],
            ctx.copy_tp(p["wv"])[:, j * hd:(j + 1) * hd], 1)


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig,
                 pos: torch.Tensor | None, ctx=ONE_DEVICE):
    """q (b, s, kvh, g, hd), k and v (b, s, kvh, hd) of ``x`` at positions
    ``pos``: projected, q and k normalised over ``hd`` when the config has
    q/k norms, then rotated (not when ``pos`` is None).  Head-sharded at
    ``ctx.tp`` > 1: the rank's heads (``kvh`` its local kv heads, or the
    one kv head its q heads use when there are fewer kv heads than ranks;
    ``x`` and the replicated weights enter through ``ctx.copy_tp``)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h = cfg.n_heads // ctx.tp
    x = ctx.copy_tp(x)
    wk, wv, kvh = kv_weights(p, cfg, ctx)
    if cfg.qk_norm:
        p = {**p, "q_norm": ctx.copy_tp(p["q_norm"]),
             "k_norm": ctx.copy_tp(p["k_norm"])}
    q = (x @ p["wq"]).reshape(b, s, kvh, h // kvh, hd)
    k = (x @ wk).reshape(b, s, kvh, hd)
    v = (x @ wv).reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if pos is None:
        return q, k, v
    q = apply_rope(q.reshape(b, s, h, hd), pos, cfg.rope_theta)
    return (q.reshape(b, s, kvh, h // kvh, hd),
            apply_rope(k, pos, cfg.rope_theta), v)


def attention_forward(p, x: torch.Tensor, cfg: ModelConfig,
                      mode: str = "train", cache: dict | None = None,
                      pos: int = 0, kind: str = "A",
                      window_override: int | None = None,
                      use_rope: bool = True, causal: bool = True,
                      ctx=ONE_DEVICE):
    """Self-attention, with RoPE unless ``use_rope`` is False (whisper's
    encoder and decoder), causal unless ``causal`` is False (whisper's
    encoder; train and prefill only).  ``kind`` 'L' attends within
    ``cfg.sliding_window`` positions, every other kind ('A', and the MoE
    'E' and dense 'D' blocks) globally; ``window_override`` sets the
    window of either (long-context serving caps 'A' blocks).  The
    attention softcap applies in every mode.  Returns (out (b, s, d),
    cache):

    * ``train``: attention over the whole sequence; no cache;
    * ``prefill``: the same, and the prompt's K and V as the cache
      ``{"k", "v"}``, each (b, s, kvh, hd);
    * ``decode``: one token at position ``pos`` against ``cache`` (each of
      k, v (b, S, kvh, hd)): its K and V are written at ``pos`` in place,
      positions ``<= pos`` (and ``> pos - window``) are valid, and the
      flash-decode kernel attends over them.  Returns the same cache.

    At ``ctx.tp`` > 1 (module docstring) the output is the replicated
    stream and the cache holds the rank's kv heads (head-sharded) or
    every head (sequence-sharded: train and prefill need ``s % tp ==
    0``).
    """
    b, s, _ = x.shape
    window = window_override if window_override is not None else (
        cfg.sliding_window if kind == "L" else None)
    seq_sharded = not head_sharded(cfg, ctx.tp)
    if mode == "decode":
        return _attention_decode(p, x, cfg, cache, pos, window, use_rope,
                                 ONE_DEVICE if seq_sharded else ctx)
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode must be train, prefill or decode, got "
                         f"{mode!r}")
    if seq_sharded:
        return _attention_seq_sharded(p, x, cfg, mode, window, use_rope,
                                      causal, ctx)
    q, k, v = _project_qkv(p, x, cfg, torch.arange(s, device=x.device)
                           if use_rope else None, ctx)
    out = chunked_attention(q, k, v, causal=causal, window=window,
                            softcap=cfg.attn_softcap).reshape(b, s, -1)
    y = ctx.psum_tp(out @ p["wo"])
    return y, ({"k": k, "v": v} if mode == "prefill" else None)


def _attention_seq_sharded(p, x: torch.Tensor, cfg: ModelConfig, mode: str,
                           window: int | None, use_rope: bool, causal: bool,
                           ctx):
    """The reference's sequence-sharded path (``n_heads % tp != 0``):
    rank r projects positions ``[r * s_l, (r + 1) * s_l)`` with every
    head, all-gathers K and V, attends its queries at their global
    positions and all-gathers the output.  Every weight is replicated and
    used on the rank's positions only, so each enters through
    ``copy_tp``; the gathered K and V feed rank-partial compute again
    (``copy_tp`` after ``ag_tp``: the reference's reduce-scatter
    transpose).  The prefill's cache is the gathered K and V."""
    b, s, _ = x.shape
    tp, r = ctx.tp, ctx.tp_rank
    if s % tp:
        raise ValueError(f"sequence-sharded attention at tp={tp} needs the "
                         f"sequence ({s}) to be a multiple of tp")
    s_l = s // tp
    p = {k: ctx.copy_tp(w) for k, w in p.items()}
    x = ctx.copy_tp(x)[:, r * s_l:(r + 1) * s_l]
    q, k, v = _project_qkv(p, x, cfg, r * s_l + torch.arange(
        s_l, device=x.device) if use_rope else None)
    k = ctx.ag_tp(k, 1)
    v = ctx.ag_tp(v, 1)
    out = chunked_attention(q, ctx.copy_tp(k), ctx.copy_tp(v),
                            causal=causal, window=window,
                            softcap=cfg.attn_softcap, q_offset=r * s_l)
    y = ctx.ag_tp(out.reshape(b, s_l, -1) @ p["wo"], 1)
    return y, ({"k": k, "v": v} if mode == "prefill" else None)


def _attention_decode(p, x: torch.Tensor, cfg: ModelConfig, cache: dict,
                      pos: int, window: int | None, use_rope: bool = True,
                      ctx=ONE_DEVICE):
    """One-token decode against a KV cache that holds every position
    (one device, or the rank's heads when ``ctx`` is head-sharded at tp >
    1: the output is then summed over the ranks)."""
    if cache is None:
        raise ValueError("decode requires a cache")
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"decode processes one token, got {s}")
    k_cache, v_cache = cache["k"], cache["v"]
    if not 0 <= pos < k_cache.shape[1]:
        raise ValueError(f"position {pos} outside the cache of "
                         f"{k_cache.shape[1]}")
    q, k_new, v_new = _project_qkv(
        p, x, cfg, torch.full((1,), pos, device=x.device) if use_rope
        else None, ctx)
    k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
    gpos = torch.arange(k_cache.shape[1], device=x.device)
    valid = gpos <= pos
    if window is not None:
        valid &= gpos > pos - window
    m, l, acc = decode_attention_local(q, k_cache, v_cache, valid,
                                       cfg.attn_softcap)
    out = combine_decode_partials(m, l, acc).reshape(b, 1, -1).to(x.dtype)
    return ctx.psum_tp(out @ p["wo"]), cache


def mlp_defs(cfg: ModelConfig, d_ff: int | None = None,
             dtype=torch.float32, ctx=ONE_DEVICE) -> dict[str, ParamDef]:
    """A gated MLP of width ``d_ff`` (``cfg.d_ff`` when None; deepseek's
    dense 'D' block passes its ``dense_d_ff``), split over ``ctx.tp``."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if ff % ctx.tp:
        raise ValueError(f"d_ff {ff} does not split over tp={ctx.tp}")
    return {"w_gate": ParamDef((d, ff), dtype=dtype, tp_dim=1),
            "w_up": ParamDef((d, ff), dtype=dtype, tp_dim=1),
            "w_down": ParamDef((ff, d), dtype=dtype, tp_dim=0, fsdp_dim=1)}


def mlp_forward(p, x: torch.Tensor, cfg: ModelConfig,
                ctx=ONE_DEVICE) -> torch.Tensor:
    """Gated MLP: ``(act(x W_gate) * x W_up) W_down`` with ``cfg.mlp_act``
    (silu: SwiGLU; gelu: GeGLU); at ``ctx.tp`` > 1 on the rank's columns
    of ``d_ff``, summed over the ranks."""
    x = ctx.copy_tp(x)
    return ctx.psum_tp((_act(cfg.mlp_act, x @ p["w_gate"])
                        * (x @ p["w_up"])) @ p["w_down"])


def padded_vocab(cfg: ModelConfig, tp: int) -> int:
    """The vocabulary rounded up to a multiple of ``tp * 128`` at ``tp`` >
    1 (the reference's)."""
    v = cfg.vocab_size
    return int(math.ceil(v / (tp * 128)) * tp * 128) if tp > 1 else v


def embed_defs(cfg: ModelConfig, dtype=torch.float32, ctx=ONE_DEVICE
               ) -> dict[str, ParamDef]:
    v = padded_vocab(cfg, ctx.tp)
    out = {"table": ParamDef((v, cfg.d_model), dtype=dtype, tp_dim=0,
                             fsdp_dim=1)}
    if not cfg.tie_embeddings:
        out["unembed"] = ParamDef((cfg.d_model, v), dtype=dtype, tp_dim=1)
    return out


def embed_lookup(p, ids: torch.Tensor, cfg: ModelConfig,
                 dtype: torch.dtype | None = None,
                 ctx=ONE_DEVICE) -> torch.Tensor:
    """ids (b, s) -> (b, s, d) in the table's dtype, times ``sqrt(d_model)``
    rounded to the table's dtype when the config scales its embeddings
    (gemma2-9b: 59.866 in float32, 59.75 in bfloat16), then cast to
    ``dtype`` when given.  At ``ctx.tp`` > 1 each rank looks up the ids
    its rows hold (zero rows for the others) and the ranks' rows are
    summed."""
    table = p["table"]
    v_l = table.shape[0]
    local = ids.long() - ctx.tp_rank * v_l
    ok = (local >= 0) & (local < v_l)
    emb = ctx.psum_tp(table[local.clamp(0, v_l - 1)]
                      * ok[..., None].to(table.dtype))
    if cfg.embed_scale:
        emb = emb * float(torch.tensor(math.sqrt(cfg.d_model),
                                       dtype=emb.dtype))
    return emb if dtype is None else emb.to(dtype)


def logits_local(p, h: torch.Tensor, cfg: ModelConfig,
                 ctx=ONE_DEVICE) -> torch.Tensor:
    """(b, s, d) -> (b, s, V) float32 logits through the tied embedding
    table or the ``unembed`` matrix (:func:`dot_f32`: the reference casts
    this product to float32), softcapped when the config says so; at
    ``ctx.tp`` > 1 the rank's ``V / tp`` columns."""
    h = ctx.copy_tp(h)
    w = p["table"].t() if cfg.tie_embeddings else p["unembed"]
    return _softcap(dot_f32(h, w), cfg.final_softcap)


def sharded_softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                         ctx=ONE_DEVICE) -> torch.Tensor:
    """Mean cross-entropy, in the reference's arithmetic (the max is
    detached: it only stabilises the exponent).  At ``ctx.tp`` > 1 the
    logits are the rank's vocabulary columns: the max and the
    denominator are reduced over the ranks, and the target's logit comes
    from the rank that holds it."""
    v_l = logits.shape[-1]
    m = ctx.pmax_tp(logits.amax(dim=-1).detach())
    e = torch.exp(logits - m[..., None])
    log_z = torch.log(ctx.psum_tp(e.sum(dim=-1))) + m
    local = targets.long() - ctx.tp_rank * v_l
    ok = (local >= 0) & (local < v_l)
    picked = torch.gather(logits, -1,
                          local.clamp(0, v_l - 1)[..., None])[..., 0]
    return (log_z - ctx.psum_tp(picked * ok.to(picked.dtype))).mean()


def sharded_greedy_sample(logits: torch.Tensor,
                          ctx=ONE_DEVICE) -> torch.Tensor:
    """Greedy next ids (b, s) int32 from (b, s, V) logits (the reference's
    at tp = 1): ties go to the lowest id.  At ``ctx.tp`` > 1 the logits
    are the rank's columns: each rank's maximum and its first global id,
    then the lowest id among the ranks that hold the global maximum, the
    same on every rank."""
    v_l = logits.shape[-1]
    loc_max = logits.amax(dim=-1)
    loc_arg = torch.argmax(logits, dim=-1) + ctx.tp_rank * v_l
    cand = torch.where(loc_max >= ctx.pmax_tp(loc_max), loc_arg,
                       torch.iinfo(torch.int64).max)
    return (-ctx.pmax_tp(-cand)).to(torch.int32)


def norm_def(cfg: ModelConfig, dtype=torch.float32) -> ParamDef:
    return ParamDef((cfg.d_model,), init="zeros", dtype=dtype)
