"""Snowflake Arctic-480B — 128-expert top-2 MoE with dense residual FFN
[hf:Snowflake/snowflake-arctic-base].

A copy of the reference's config. One block's experts hold 26.8 GB in
bf16, so the port runs it at smoke size until the experts are sharded
over several cards.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, OrigamiConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,                      # per-expert FFN width
    vocab_size=32000,
    qkv_bias=False,
    attention="gqa",
    rope_theta=10000.0,
    norm="rmsnorm",
    activation="silu",
    moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual_d_ff=4864, dispatch="sorted_grouped"),
    origami=OrigamiConfig(enabled=True, tier1_layers=3),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=64, vocab_size=512,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64,
                      dense_residual_d_ff=64, dispatch="gshard"),
        origami=OrigamiConfig(enabled=True, tier1_layers=1),
    )
