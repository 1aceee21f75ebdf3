"""Architecture config registry and reduced smoke variants.

Counterpart of ``repro.configs``.  ``get_config(arch_id)`` returns the
exact configuration of every architecture of the reference (the dense
family: smollm-135m, qwen3-0.6b, yi-9b, chameleon-34b and gemma2-9b; the
mixture-of-experts family: granite-moe-3b-a800m and deepseek-moe-16b; the
state-space family: mamba2-1.3b and the hybrid jamba-v0.1-52b; the
encoder-decoder whisper-small) and raises ``KeyError`` for an unknown
one; ``reduced(cfg)`` returns the same small same-family variant as the
reference; ``shape_applicable`` says whether an architecture runs at an
input shape, and ``input_specs(cfg, shape)`` gives ``meta``-device
stand-ins for every model input of that shape (no allocation), the
reference's ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.config import InputShape, ModelConfig

__all__ = ["ARCH_IDS", "PORTED", "get_config", "all_configs", "reduced",
           "cut_depth", "shape_applicable", "input_specs"]

#: every architecture of the reference registry
ARCH_IDS = ("jamba-v0.1-52b", "qwen3-0.6b", "chameleon-34b", "yi-9b",
            "gemma2-9b", "deepseek-moe-16b", "whisper-small",
            "granite-moe-3b-a800m", "mamba2-1.3b", "smollm-135m")

#: the module of each architecture (all of the reference's)
PORTED = {"qwen3-0.6b": "qwen3_0_6b", "chameleon-34b": "chameleon_34b",
          "yi-9b": "yi_9b", "gemma2-9b": "gemma2_9b",
          "smollm-135m": "smollm_135m",
          "granite-moe-3b-a800m": "granite_moe_3b_a800m",
          "deepseek-moe-16b": "deepseek_moe_16b",
          "mamba2-1.3b": "mamba2_1_3b",
          "jamba-v0.1-52b": "jamba_v0_1_52b",
          "whisper-small": "whisper_small"}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCH_IDS)}")
    return importlib.import_module(
        f"repro_torch.configs.{PORTED[arch_id]}").CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def reduced(cfg: ModelConfig, d_model: int = 256) -> ModelConfig:
    """Small same-family variant: <=2 periods, d_model<=512, <=4 experts,
    for the Mamba2 blocks 8 SSM heads of 64 with state 16 and chunk 32
    at d_model 256, and for an encoder-decoder 2 encoder layers over 32
    frames (the reference's rule, restricted to the fields the port's
    architectures use)."""
    n_heads = min(cfg.n_heads, 4) if cfg.n_heads else 0
    n_kv = min(cfg.n_kv_heads, max(1, n_heads // 2)) if cfg.n_kv_heads else 0
    changes = dict(
        arch_id=cfg.arch_id + "-smoke",
        d_model=d_model,
        vocab_size=min(cfg.vocab_size, 1024),
        n_periods=min(cfg.n_periods, 2),
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=64 if cfg.head_dim else None,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        dense_d_ff=min(cfg.dense_d_ff, 512) if cfg.dense_d_ff else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window
        else None,
        long_context_window=(min(cfg.long_context_window, 128)
                             if cfg.long_context_window else None),
    )
    if cfg.n_experts:
        # capacity factor 8: no assignment is dropped at smoke size
        changes.update(n_experts=4, top_k=min(cfg.top_k, 2),
                       moe_d_ff=min(cfg.moe_d_ff, 128),
                       n_shared_experts=min(cfg.n_shared_experts, 1),
                       capacity_factor=8.0)
    if cfg.ssm_state:
        # d_inner = expand * d_model = heads * head_dim: 2 * 256 = 8 * 64
        changes.update(ssm_state=16, ssm_heads=(2 * 256) // 64,
                       ssm_head_dim=64, ssm_chunk=32, d_model=256)
    if cfg.is_encoder_decoder:
        changes.update(n_encoder_layers=2, encoder_frames=32)
    return dataclasses.replace(cfg, **changes)


def cut_depth(cfg: ModelConfig, periods: int | None = None,
              encoder_layers: int | None = None) -> ModelConfig:
    """``cfg`` cut to ``periods`` periods of its layer pattern and, for an
    encoder-decoder, ``encoder_layers`` encoder layers, every width kept
    (the CLIs' ``--periods`` and ``--encoder-layers``; None keeps a
    depth).  ValueError outside ``[1, the config's depth]``, or for
    encoder layers without an encoder."""
    if periods is not None:
        if not 1 <= periods <= cfg.n_periods:
            raise ValueError(f"--periods must be in [1, {cfg.n_periods}]")
        cfg = dataclasses.replace(cfg, n_periods=periods)
    if encoder_layers is not None:
        if not cfg.is_encoder_decoder:
            raise ValueError(f"--encoder-layers: {cfg.arch_id} has no "
                             "encoder")
        if not 1 <= encoder_layers <= cfg.n_encoder_layers:
            raise ValueError(f"--encoder-layers must be in [1, "
                             f"{cfg.n_encoder_layers}]")
        cfg = dataclasses.replace(cfg, n_encoder_layers=encoder_layers)
    return cfg


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether (arch, input-shape) runs; reason string if skipped."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention architecture: long_500k requires "
                       "sub-quadratic attention (DESIGN.md section 5)")
    return True, ""


def input_specs(cfg: ModelConfig,
                shape: InputShape) -> dict[str, torch.Tensor]:
    """Global-batch ``meta`` stand-ins of the inputs of ``shape``: tokens
    (and for train labels) ``(b, s)`` int32; a decode step carries ONE new
    token per sequence (the cache of ``seq_len`` lives in the serve
    state); an audio-frames model outside decode adds its float32 frames
    ``(b, encoder_frames, d_model)``."""
    b, s = shape.global_batch, shape.seq_len

    def spec(*dims, dt=torch.int32):
        return torch.empty(dims, dtype=dt, device="meta")

    if shape.kind == "train":
        specs = {"tokens": spec(b, s), "labels": spec(b, s)}
    elif shape.kind == "prefill":
        specs = {"tokens": spec(b, s)}
    else:
        specs = {"tokens": spec(b, 1)}
    if cfg.frontend == "audio_frames" and shape.kind != "decode":
        specs["enc_frames"] = spec(b, cfg.encoder_frames, cfg.d_model,
                                   dt=torch.float32)
    return specs
