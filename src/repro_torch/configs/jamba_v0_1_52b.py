"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536  [arXiv:2403.19887]

Layer pattern (HF config: attn_layer_period=8, attn_layer_offset=4,
expert_layer_period=2, expert_layer_offset=1):
  per period of 8: mamba everywhere except index 4 (attention);
  MoE FFN on odd indices, dense FFN on even.
  codes: M(dense) X(mamba+moe) A(attn+dense)  ->  "MXMXAXMX" x 4.

Jamba v0.1 uses Mamba-1 internally; this framework implements the SSD
(Mamba-2) formulation for all SSM blocks — recorded in DESIGN.md §Changed
assumptions (systems-equivalent compute/communication structure).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="jamba-v0.1-52b",
    family="hybrid",
    d_model=4096,
    vocab_size=65536,
    period="MXMXAXMX",
    n_periods=4,                      # 32 layers total, 4 attention
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    n_experts=16,
    top_k=2,
    moe_d_ff=14336,
    ssm_state=16,                     # jamba mamba d_state
    ssm_heads=128,                    # d_inner 8192 / head_dim 64
    ssm_head_dim=64,
    ssm_expand=2,
    supports_long_context=True,       # hybrid: 4 attn layers, seq-sharded cache
    citation="arXiv:2403.19887",
)
