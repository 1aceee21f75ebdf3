"""Transformer layers on one device (tensor-parallel degree 1).

Counterpart of ``repro.models.layers`` at tp = 1, where every collective
of the reference is the identity, for the llama-style blocks of the ported
configuration (smollm-135m): SwiGLU MLP, no q/k norms, tied embeddings, no
softcaps.  ``transformer.build_defs`` refuses configurations outside that.
Layouts follow the reference at every public function: activations ``(b,
s, d)``, grouped queries ``(b, s, kvh, g, hd)``, weights ``(d_in,
d_out)``; everything is float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef

__all__ = ["rms_norm", "rope_freqs", "apply_rope", "attention",
           "attention_defs", "attention_forward", "mlp_defs", "mlp_forward",
           "embed_defs", "embed_lookup", "logits_local",
           "sharded_softmax_xent", "norm_def"]

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


def attention_forward(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Causal self-attention with RoPE over the whole sequence."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, kvh, hd)
    v = (x @ p["wv"]).reshape(b, s, kvh, hd)
    pos = torch.arange(s, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta).reshape(b, s, kvh, h // kvh, hd)
    k = apply_rope(k, pos, cfg.rope_theta)
    out = attention(q, k, v).reshape(b, s, h * hd)
    return out @ p["wo"]


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


def norm_def(cfg: ModelConfig) -> ParamDef:
    return ParamDef((cfg.d_model,), init="zeros")
