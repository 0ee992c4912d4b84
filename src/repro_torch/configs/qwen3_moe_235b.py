"""Qwen3-MoE-235B-A22B — 128-expert top-8 MoE [hf:Qwen/Qwen3 family].

A copy of the reference's config. Every block is a MoE block; the Origami
partition puts the first four in tier-1.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, OrigamiConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,                      # per-expert FFN width
    vocab_size=151936,
    qkv_bias=False,
    attention="gqa",
    rope_theta=1000000.0,
    norm="rmsnorm",
    activation="silu",
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536,
                  dispatch="sorted_grouped"),
    origami=OrigamiConfig(enabled=True, tier1_layers=4),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=64, vocab_size=512,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64,
                      dispatch="gshard"),
        origami=OrigamiConfig(enabled=True, tier1_layers=1),
    )
