"""Transformer layers on one device (tensor-parallel degree 1).

Counterpart of ``repro.models.layers`` at tp = 1, where every collective
of the reference is the identity, for the llama-style blocks of the ported
configuration (smollm-135m): SwiGLU MLP, no q/k norms, tied embeddings, no
softcaps.  ``transformer.build_defs`` refuses configurations outside that.
Layouts follow the reference at every public function: activations ``(b,
s, d)``, grouped queries ``(b, s, kvh, g, hd)``, weights ``(d_in,
d_out)``, KV caches ``(b, S, kvh, hd)``; everything is float32.

``attention_forward`` runs in three modes, as the reference's does:
``train`` (the causal forward), ``prefill`` (the same, returning the
prompt's rotated K and V as the decode cache) and ``decode`` (one token
against the cache through the flash-decode kernel, ``kernels.gqa_decode``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef

__all__ = ["rms_norm", "rope_freqs", "apply_rope", "attention",
           "decode_attention_local", "combine_decode_partials",
           "attention_defs", "attention_forward", "mlp_defs", "mlp_forward",
           "embed_defs", "embed_lookup", "logits_local",
           "sharded_softmax_xent", "sharded_greedy_sample", "norm_def"]

#: score of a masked position (the reference's -1e30, not -inf)
NEG = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)``; weights initialise to 0."""
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + w)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (b, s, h, hd); positions: (s,).  Rotates the two halves of each
    head against each other (not interleaved pairs)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]
    ang = ang[None, :, None, :]                            # (1, s, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Plain causal softmax attention, the reference's ``chunked_attention``
    arithmetic in one chunk: masked scores are -1e30, and the output is
    ``(p @ v) / max(sum p, 1e-30)`` with ``p = exp(s - max s)``.

    q: (b, sq, kvh, g, hd); k, v: (b, sk, kvh, hd) -> (b, sq, kvh, g, hd).
    """
    sq, sk, hd = q.shape[1], k.shape[1], q.shape[-1]
    qh = q.permute(0, 2, 3, 1, 4)                          # (b,kvh,g,sq,hd)
    kh = k.permute(0, 2, 3, 1).unsqueeze(2)                # (b,kvh,1,hd,sk)
    vh = v.permute(0, 2, 1, 3).unsqueeze(2)                # (b,kvh,1,sk,hd)
    s = torch.matmul(qh, kh) * (1.0 / math.sqrt(hd))
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, torch.full_like(s, NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, vh) / torch.clamp_min(l, 1e-30)
    return out.permute(0, 3, 1, 2, 4)


def attention_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    return {"wq": ParamDef((d, h * hd)), "wk": ParamDef((d, kvh * hd)),
            "wv": ParamDef((d, kvh * hd)), "wo": ParamDef((h * hd, d))}


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


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig, pos: torch.Tensor):
    """Rotated q (b, s, kvh, g, hd), rotated k and v (b, s, kvh, hd) of
    ``x`` at positions ``pos``."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, kvh, hd)
    v = (x @ p["wv"]).reshape(b, s, kvh, hd)
    q = apply_rope(q, pos, cfg.rope_theta).reshape(b, s, kvh, h // kvh, hd)
    return q, apply_rope(k, pos, cfg.rope_theta), v


def attention_forward(p, x: torch.Tensor, cfg: ModelConfig,
                      mode: str = "train", cache: dict | None = None,
                      pos: int = 0):
    """Self-attention with RoPE.  Returns (out (b, s, d), cache):

    * ``train``: causal attention over the whole sequence; no cache;
    * ``prefill``: the same, and the prompt's rotated K and V as the cache
      ``{"k", "v"}``, each (b, s, kvh, hd);
    * ``decode``: one token at position ``pos`` against ``cache`` (each of
      k, v (b, S, kvh, hd)): its K and V are written at ``pos`` in place,
      positions ``<= pos`` are valid, and the flash-decode kernel attends
      over them.  Returns the same cache.
    """
    b, s, _ = x.shape
    if mode == "decode":
        return _attention_decode(p, x, cfg, cache, pos)
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode must be train, prefill or decode, got "
                         f"{mode!r}")
    q, k, v = _project_qkv(p, x, cfg, torch.arange(s, device=x.device))
    out = attention(q, k, v).reshape(b, s, -1)
    return out @ p["wo"], ({"k": k, "v": v} if mode == "prefill" else None)


def _attention_decode(p, x: torch.Tensor, cfg: ModelConfig, cache: dict,
                      pos: int):
    """One-token decode against a KV cache (one device, no shards)."""
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
        p, x, cfg, torch.full((1,), pos, device=x.device))
    k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
    valid = torch.arange(k_cache.shape[1], device=x.device) <= pos
    m, l, acc = decode_attention_local(q, k_cache, v_cache, valid,
                                       cfg.attn_softcap)
    out = combine_decode_partials(m, l, acc).reshape(b, 1, -1).to(x.dtype)
    return out @ p["wo"], cache


def mlp_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    d, ff = cfg.d_model, cfg.d_ff
    return {"w_gate": ParamDef((d, ff)), "w_up": ParamDef((d, ff)),
            "w_down": ParamDef((ff, d))}


def mlp_forward(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x W_gate) * x W_up) W_down``."""
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def embed_defs(cfg: ModelConfig) -> dict[str, ParamDef]:
    return {"table": ParamDef((cfg.vocab_size, cfg.d_model))}


def embed_lookup(p, ids: torch.Tensor) -> torch.Tensor:
    """ids (b, s) -> (b, s, d)."""
    return p["table"][ids.long()]


def logits_local(p, h: torch.Tensor) -> torch.Tensor:
    """(b, s, d) -> (b, s, V) logits through the tied embedding table."""
    return h @ p["table"].t()


def sharded_softmax_xent(logits: torch.Tensor,
                         targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy, in the reference's arithmetic at tp = 1 (the
    max is detached: it only stabilises the exponent)."""
    m = logits.amax(dim=-1).detach()
    e = torch.exp(logits - m[..., None])
    log_z = torch.log(e.sum(dim=-1)) + m
    picked = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (log_z - picked).mean()


def sharded_greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """Greedy next ids (b, s) int32 from (b, s, V) logits (the reference's
    at tp = 1): ties go to the lowest id."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def norm_def(cfg: ModelConfig) -> ParamDef:
    return ParamDef((cfg.d_model,), init="zeros")
