"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060]

48L d_model=2048 d_ff=0 (no MLP; the mamba block IS the layer) vocab=50280,
ssm_state=128, expand=2 (d_inner 4096), head_dim 64 -> 64 SSM heads.
Fully sub-quadratic: runs long_500k natively.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-1.3b",
    family="ssm",
    d_model=2048,
    vocab_size=50280,
    period="M",
    n_periods=48,
    d_ff=0,                       # attention-free, no interleaved MLP
    ssm_state=128,
    ssm_heads=64,
    ssm_head_dim=64,
    ssm_expand=2,
    tie_embeddings=True,
    supports_long_context=True,
    citation="arXiv:2405.21060",
)
