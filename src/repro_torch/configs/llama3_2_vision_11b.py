"""Llama-3.2-Vision-11B backbone — a decoder with a gated cross-attention
image block closing every group of 5 blocks; the vision tower is a stub
(precomputed patch embeddings) [hf:meta-llama/Llama-3.2-11B-Vision].

A copy of the reference's config: 40 blocks in 8 groups of 4 self blocks
and 1 cross block, attending to 1601 patches of width 4096; the Origami
partition puts the first four (self) blocks in tier-1.
"""
from repro_torch.configs.base import ModelConfig, OrigamiConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    attention="gqa",
    rope_theta=500000.0,
    norm="rmsnorm",
    activation="silu",
    cross_attn_every=5,
    vision_seq_len=1601,
    origami=OrigamiConfig(enabled=True, tier1_layers=4),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=5, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, cross_attn_every=5, vision_seq_len=16,
        origami=OrigamiConfig(enabled=True, tier1_layers=1),
    )
