"""Yi-9B — llama-arch dense GQA [arXiv:2403.04652].

A copy of the reference's config; the Origami partition puts the first
four decoder blocks in tier-1.
"""
from repro_torch.configs.base import ModelConfig, OrigamiConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    qkv_bias=False,
    attention="gqa",
    rope_theta=10000.0,
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
