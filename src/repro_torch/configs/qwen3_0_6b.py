"""qwen3-0.6b [dense] — qk_norm, GQA.  [hf:Qwen/Qwen3-8B family]

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936, head_dim=128,
tied embeddings, qk-norm.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-0.6b",
    family="dense",
    d_model=1024,
    vocab_size=151936,
    period="A",
    n_periods=28,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    citation="hf:Qwen/Qwen3-8B",
)
