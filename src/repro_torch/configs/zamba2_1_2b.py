"""Zamba2-1.2B — hybrid: Mamba2 backbone + shared full-attention block
applied every 6 SSM blocks [arXiv:2411.15242].

A copy of the reference's config: 38 Mamba2 blocks (64 heads of state 64
over an inner width of 4096), one shared attention block of 32 heads of
64 with an 8192-wide MLP, run after every complete group of 6, and a tail
of 2 blocks past the last group.
"""
from repro_torch.configs.base import ModelConfig, OrigamiConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,                      # shared attention block's FFN
    vocab_size=32000,
    attention="gqa",
    rope_theta=10000.0,
    norm="rmsnorm",
    activation="gelu",
    ssm=SSMConfig(variant="mamba2", state_dim=64, conv_dim=4, expand=2,
                  num_ssm_heads=64, chunk_size=256),
    hybrid_attn_every=6,
    origami=OrigamiConfig(enabled=True, tier1_layers=3),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=6, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512,
        ssm=SSMConfig(variant="mamba2", state_dim=16, conv_dim=4, expand=2,
                      num_ssm_heads=8, chunk_size=32),
        hybrid_attn_every=3,
        origami=OrigamiConfig(enabled=True, tier1_layers=1),
    )
