"""VGG-19 — the paper's second evaluation model."""
from repro_torch.configs.base import ModelConfig, OrigamiConfig

_LAYERS = (
    "conv64", "conv64", "pool",
    "conv128", "conv128", "pool",
    "conv256", "conv256", "conv256", "conv256", "pool",
    "conv512", "conv512", "conv512", "conv512", "pool",
    "conv512", "conv512", "conv512", "conv512", "pool",
    "fc4096", "fc4096", "logits",
)

CONFIG = ModelConfig(
    name="vgg19",
    family="cnn",
    num_layers=len(_LAYERS),
    d_model=0, num_heads=0, num_kv_heads=0, d_ff=0,
    vocab_size=0,
    cnn_layers=_LAYERS,
    image_size=224,
    image_channels=3,
    num_classes=1000,
    dtype="float32",
    origami=OrigamiConfig(enabled=True, tier1_layers=6),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        cnn_layers=("conv8", "conv8", "pool", "conv16", "conv16", "conv16",
                    "pool", "fc32", "logits"),
        num_layers=9, image_size=32, num_classes=10,
        origami=OrigamiConfig(enabled=True, tier1_layers=3),
    )
