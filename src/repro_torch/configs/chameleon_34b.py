"""chameleon-34b [vlm] — early-fusion, VQ image tokens.  [arXiv:2405.09818]

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.

Early fusion means the language backbone consumes a single token stream in
which images appear as VQ-VAE codebook ids inside the same 65536 vocab —
the modality frontend (VQ tokenizer) is the allowed stub: ``input_specs``
provides token ids directly.  Chameleon uses qk-norm for stability.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="chameleon-34b",
    family="vlm",
    d_model=8192,
    vocab_size=65536,
    period="A",
    n_periods=48,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    qk_norm=True,
    frontend=None,      # VQ image tokens are ordinary vocabulary entries
    citation="arXiv:2405.09818",
)
