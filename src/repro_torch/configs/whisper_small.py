"""Whisper-small backbone — an encoder-decoder transformer; the audio conv
frontend is a stub (precomputed frame embeddings) [arXiv:2212.04356].

A copy of the reference's config: 12 encoder and 12 decoder blocks of
width 768 (12 heads of 64, layer norm, gelu MLP of 3072), sinusoidal
positions and no RoPE, tied embeddings, 1500 frames; the vocabulary of
51,865 is padded to a multiple of 256 (51,968). The Origami partition
puts the first two encoder blocks in tier-1.
"""
from repro_torch.configs.base import ModelConfig, OrigamiConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,                  # 12 encoder + 12 decoder
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    vocab_pad_to=256,
    attention="gqa",
    norm="layernorm",
    activation="gelu",
    encoder_decoder=True,
    encoder_seq_len=1500,
    tie_embeddings=True,
    rope_theta=0.0,                 # sinusoidal positions
    origami=OrigamiConfig(enabled=True, tier1_layers=2),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=96, num_heads=3, num_kv_heads=3, head_dim=32,
        d_ff=192, vocab_size=512, vocab_pad_to=16, encoder_seq_len=64,
        origami=OrigamiConfig(enabled=True, tier1_layers=1),
    )
