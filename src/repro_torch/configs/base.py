"""Config schema: a copy of the reference's ``ModelConfig`` and
``OrigamiConfig`` (``repro/configs/base.py``) with the same fields, in the
same order and with the same defaults, so ``to_json()`` — which the
enclave measurement hashes — is identical for the same model.

``MoEConfig``, ``MLAConfig`` and ``SSMConfig`` copy the reference's
fields, order and defaults: the mixture-of-experts family
(models/moe.py), the latent attention (models/attention.py) and the
state-space and hybrid families (models/ssm.py) read them, and
``to_json()`` nests them as the reference does. The
properties (``resolved_head_dim``, ``padded_vocab``) are not fields, so
they do not enter the JSON. ``TrainConfig`` is the reference's, verbatim: AdamW
(optim/adamw.py) reads it. ``ShapeConfig`` and ``SHAPES`` are the
reference's, verbatim: the train, prefill and decode steps take a shape
(launch/steps.py).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    # Arctic-style dense residual FFN running in parallel with the experts.
    dense_residual_d_ff: int = 0
    # "gshard" = dense one-hot dispatch (baseline); "sorted" = argsort +
    # capacity buffers; "sorted_grouped" = the sorted dispatch within
    # token groups (models/moe.py).
    dispatch: str = "gshard"
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class SSMConfig:
    variant: str = "mamba2"        # "mamba2" | "xlstm"
    state_dim: int = 64            # N: SSM state size per head
    conv_dim: int = 4              # depthwise conv width (mamba2)
    expand: int = 2                # inner dim = expand * d_model
    num_ssm_heads: int = 8         # mamba2 heads (d_inner / head_dim)
    chunk_size: int = 256          # chunked-scan block length
    # xlstm only: one sLSTM block every `slstm_every` blocks (rest mLSTM).
    slstm_every: int = 8
    slstm_proj_factor: float = 1.333


@dataclass(frozen=True)
class OrigamiConfig:
    """The paper's technique: tier-1 blinded-offload prefix, tier-2 open."""
    enabled: bool = False
    tier1_layers: int = 0          # partition point p (layers)
    field_bits: int = 24
    quant_bits: int = 8
    verify_depth: int = 2


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    # bf16 moments for very large models (arctic-480b / qwen3-moe-235b)
    moment_dtype: str = "float32"
    microbatches: int = 1          # gradient accumulation steps
    grad_compression: bool = False # int8 + error feedback on cross-pod axis
    seed: int = 0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str         # cnn | dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    vocab_pad_to: int = 1
    qkv_bias: bool = False
    attention: str = "gqa"
    window_size: int = 0
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"
    activation: str = "silu"
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): a shared full-attention block applied every k SSM blocks
    hybrid_attn_every: int = 0
    encoder_decoder: bool = False
    encoder_seq_len: int = 1500
    cross_attn_every: int = 0
    vision_seq_len: int = 1601
    # CNN (VGG) family
    cnn_layers: Tuple[str, ...] = ()
    image_size: int = 224
    image_channels: int = 3
    num_classes: int = 1000
    dtype: str = "bfloat16"
    origami: OrigamiConfig = field(default_factory=OrigamiConfig)
    remat: str = "block"
    scan_layers: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // self.vocab_pad_to) * self.vocab_pad_to

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str, indent=1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per-arch)."""
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_training(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
