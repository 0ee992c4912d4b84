"""Qwen2.5-14B — dense GQA with QKV bias [hf:Qwen/Qwen2.5 family].

A copy of the reference's config; the Origami partition puts the first
four decoder blocks in tier-1. The q, k and v projections carry a bias,
which the Slalom hook adds in the enclave after unblinding.
"""
from repro_torch.configs.base import ModelConfig, OrigamiConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    attention="gqa",
    rope_theta=1000000.0,
    norm="rmsnorm",
    activation="silu",
    origami=OrigamiConfig(enabled=True, tier1_layers=4),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512,
        origami=OrigamiConfig(enabled=True, tier1_layers=1),
    )
