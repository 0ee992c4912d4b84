"""xLSTM-1.3B — recurrent: mLSTM blocks with one sLSTM block every 8
(d_ff = 0: blocks carry their own up/down projections) [arXiv:2405.04517].

A copy of the reference's config: 48 blocks in 6 groups of 7 mLSTM
blocks (4 heads of 1024 over an inner width of 4096) and one sLSTM block.
"""
from repro_torch.configs.base import ModelConfig, OrigamiConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    attention="none",
    norm="layernorm",
    activation="gelu",
    ssm=SSMConfig(variant="xlstm", expand=2, num_ssm_heads=4, chunk_size=256,
                  slstm_every=8, slstm_proj_factor=1.333),
    origami=OrigamiConfig(enabled=True, tier1_layers=3),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=4, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
        vocab_size=512,
        ssm=SSMConfig(variant="xlstm", expand=2, num_ssm_heads=2,
                      chunk_size=16, slstm_every=4),
        origami=OrigamiConfig(enabled=True, tier1_layers=1),
    )
