"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained.
[arXiv:2401.06066]

28L d_model=2048 16H (GQA kv=16 = MHA) d_ff=1408 (per expert) vocab=102400.
Layer 0 is a dense FFN (width 10944); layers 1..27 are MoE.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-moe-16b",
    family="moe",
    d_model=2048,
    vocab_size=102400,
    prelude="D",                 # dense layer 0 (d_ff 10944)
    period="E",
    n_periods=27,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    dense_d_ff=10944,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    citation="arXiv:2401.06066",
)
