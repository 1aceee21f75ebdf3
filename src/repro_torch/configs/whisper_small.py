"""whisper-small [audio] — enc-dec, conv frontend (stub).  [arXiv:2212.04356]

12L (x2: encoder+decoder) d_model=768 12H (MHA kv=12) d_ff=3072 vocab=51865.

The mel-spectrogram + conv feature extractor frontend is the allowed stub:
the model takes precomputed frame embeddings (B, 1504, 768) — whisper's
native 1500 frames padded to 1504, a multiple of 16 (the reference shards
the frame sequence over a 16-way `model` axis; here it is one device).
The encoder adds sinusoidal positions to the frames; the decoder learns
its positions (``pos_emb``) and attends over the encoder's output through
a cross attention in every block.  RoPE is off throughout.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small",
    family="audio",
    d_model=768,
    vocab_size=51865,
    period="A",
    n_periods=12,                # decoder layers
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    mlp_act="gelu",
    is_encoder_decoder=True,
    n_encoder_layers=12,
    encoder_frames=1504,   # 1500 padded to a multiple of 16 (see docstring)
    frontend="audio_frames",
    citation="arXiv:2212.04356",
)
