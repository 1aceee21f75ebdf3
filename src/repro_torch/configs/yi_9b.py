"""yi-9b [dense] — llama-arch GQA.  [arXiv:2403.04652]

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="yi-9b",
    family="dense",
    d_model=4096,
    vocab_size=64000,
    period="A",
    n_periods=48,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    citation="arXiv:2403.04652",
)
