"""Model configuration (a copy of ``repro.models.config``: ``ModelConfig``,
``InputShape`` and ``INPUT_SHAPES``).

A ``ModelConfig`` fully determines the parameter pytree and the forward pass.
Architectures are expressed as a *layer pattern*: a short period string that
repeats ``n_periods`` times (scanned for compile-time compactness), with
optional explicit prelude/postlude layers.

Block codes used in patterns:
  'A' — full (global) attention block + dense MLP
  'L' — sliding-window (local) attention block + dense MLP
  'M' — Mamba2 (SSD) block
  'E' — attention block + MoE FFN
  'X' — Mamba2 block + MoE FFN (jamba-style MoE-on-mamba layer)
  'D' — attention block + dense MLP with its own width (deepseek layer-0)
"""
from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "InputShape", "INPUT_SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str              # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    vocab_size: int
    # --- layer stack -------------------------------------------------
    period: str              # repeating block pattern, e.g. "A", "LG", "MMMAMMMM"
    n_periods: int           # total layers = len(period) * n_periods (+ prelude)
    prelude: str = ""        # explicit (unscanned) leading layers
    # --- attention ---------------------------------------------------
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int | None = None
    d_ff: int = 0
    qk_norm: bool = False
    attn_softcap: float | None = None      # gemma2: 50.0
    final_softcap: float | None = None     # gemma2: 30.0
    sliding_window: int | None = None      # for 'L' blocks
    rope_theta: float = 10_000.0
    post_norms: bool = False               # gemma2 sandwich norms
    mlp_act: str = "silu"                  # silu (swiglu) | gelu (geglu) | gelu_mlp
    # --- MoE ----------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                      # routed-expert hidden dim
    dense_d_ff: int = 0                    # 'D' block dense width (deepseek L0)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- Mamba2 (SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- encoder-decoder (whisper) --------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_frames: int = 1500             # stub frontend output length
    # --- embeddings/misc -------------------------------------------------
    tie_embeddings: bool = False
    embed_scale: bool = False              # gemma-style sqrt(d) embedding scale
    norm_eps: float = 1e-6
    # --- frontend stubs ---------------------------------------------------
    frontend: str | None = None            # None | 'audio_frames'
    # long-context serving applicability (DESIGN.md section 5)
    supports_long_context: bool = False
    long_context_window: int | None = None  # window cap for 'A' blocks in long-serve
    citation: str = ""

    # ------------------------------------------------------------------
    @property
    def n_layers(self) -> int:
        return len(self.prelude) + len(self.period) * self.n_periods

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Analytic parameter count (embedding + per-block), for rooflines."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        hd = self.resolved_head_dim

        def attn_params() -> int:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            return q + kv + o

        def mlp_params(ff: int) -> int:
            mult = 3 if self.mlp_act in ("silu", "gelu") else 2
            return mult * d * ff

        def moe_params() -> int:
            routed = self.n_experts * 3 * d * self.moe_d_ff
            shared = self.n_shared_experts * 3 * d * self.moe_d_ff
            router = d * self.n_experts
            return routed + shared + router

        def mamba_params() -> int:
            di = self.d_inner
            n, h = self.ssm_state, self.ssm_heads
            in_proj = d * (2 * di + 2 * n + h)  # x, z, B, C, dt
            out_proj = di * d
            conv = self.ssm_conv * (di + 2 * n)
            return in_proj + out_proj + conv + 3 * h  # + A, D, dt_bias

        per_block = {
            "A": attn_params() + mlp_params(self.d_ff),
            "L": attn_params() + mlp_params(self.d_ff),
            "M": mamba_params() + (mlp_params(self.d_ff) if self.d_ff else 0),
            "E": attn_params() + moe_params(),
            "X": mamba_params() + moe_params(),
            "D": attn_params() + mlp_params(self.dense_d_ff or self.d_ff),
        }
        for code in self.prelude + self.period * self.n_periods:
            total += per_block[code] + 2 * d  # + norms
        total += d  # final norm
        if self.is_encoder_decoder:
            # encoder self-attn + mlp, decoder adds cross-attn
            enc = self.n_encoder_layers * (attn_params() + mlp_params(self.d_ff) + 2 * d)
            cross = self.n_layers * attn_params()
            total += enc + cross
        return total

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: top_k + shared only)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        inactive_experts = self.n_experts - self.top_k
        n_moe_blocks = sum(
            1 for c in self.prelude + self.period * self.n_periods if c in ("E", "X")
        )
        return full - n_moe_blocks * inactive_experts * 3 * d * self.moe_d_ff


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
