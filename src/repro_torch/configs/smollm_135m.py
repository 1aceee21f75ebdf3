"""smollm-135m [dense] — llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M]

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152, tied embeddings.
9 heads do not divide tp=16 -> sequence-sharded attention path.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm-135m",
    family="dense",
    d_model=576,
    vocab_size=49152,
    period="A",
    n_periods=30,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    tie_embeddings=True,
    citation="hf:HuggingFaceTB/SmolLM-135M",
)
