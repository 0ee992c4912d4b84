"""SmolLM-135M — small llama-arch dense GQA [hf:HuggingFaceTB/SmolLM-135M].

A copy of the reference's config; the Origami partition puts the first
three decoder blocks in tier-1.
"""
from repro_torch.configs.base import ModelConfig, OrigamiConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    qkv_bias=False,
    attention="gqa",
    rope_theta=10000.0,
    norm="rmsnorm",
    activation="silu",
    tie_embeddings=True,
    origami=OrigamiConfig(enabled=True, tier1_layers=3),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=4, d_model=96, num_heads=3, num_kv_heads=1, head_dim=32,
        d_ff=192, vocab_size=512,
        origami=OrigamiConfig(enabled=True, tier1_layers=1),
    )
