"""MiniCPM3-4B — dense with Multi-head Latent Attention
[hf:openbmb/MiniCPM3-4B].

A copy of the reference's config. MLA decouples the head widths: q and k
are 64 + 32 (rope) wide, v 64 (``head_dim``), and the decode cache holds
the 256-wide latent and the shared 32-wide rope key. The vocab of 73,448
is padded to a multiple of 256 (73,472), as in the reference.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, OrigamiConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=64,                    # v head dim (MLA decouples qk dims)
    d_ff=6400,
    vocab_size=73448,
    vocab_pad_to=256,
    attention="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    rope_theta=10000.0,
    norm="rmsnorm",
    activation="silu",
    origami=OrigamiConfig(enabled=True, tier1_layers=4),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512, vocab_pad_to=16,
        mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32,
                      qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32),
        origami=OrigamiConfig(enabled=True, tier1_layers=1),
    )
