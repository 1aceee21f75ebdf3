"""granite-moe-3b-a800m [moe] — 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base family]

32L d_model=1536 24H (GQA kv=8) d_ff=512 (per expert) vocab=49155,
MoE 40e top-8.  On one device there is no expert axis, so the 40 experts
are not padded.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-3b-a800m",
    family="moe",
    d_model=1536,
    vocab_size=49155,
    period="E",
    n_periods=32,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    n_experts=40,
    top_k=8,
    moe_d_ff=512,
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
