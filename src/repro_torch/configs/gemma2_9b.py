"""gemma2-9b [dense] — local+global alternating, logit softcap. [arXiv:2408.00118]

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000, head_dim=256,
sliding window 4096 on local layers, attn softcap 50, final softcap 30,
GeGLU, sandwich (post) norms, sqrt(d) embedding scale, tied embeddings.

long_500k applicability: local layers are natively sub-quadratic; global
layers are capped to a 32k window in long-serve mode (beyond-paper serving
adaptation, DESIGN.md section 5).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-9b",
    family="dense",
    d_model=3584,
    vocab_size=256000,
    period="LA",                 # local (window) then global, x21
    n_periods=21,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_act="gelu",
    post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
    supports_long_context=True,
    long_context_window=32768,
    citation="arXiv:2408.00118",
)
