"""Top-level LM API of the dense and mixture-of-experts families: config
-> init / forward / prefill / decode.

Port of the dense and MoE part of ``repro/models/model.py``. Parameters
are a nested dict of tensors with the reference's tree and layouts: block
leaves are stacked (a leading layer dim; a MoE expert bank is
(L, E, d, f), its router float32), the KV cache is ``KVCache`` of
(L, B, max_seq, KH, D) tensors (an MLA model's: k the latent and rope key,
(L, B, max_seq, kv_lora_rank + qk_rope_head_dim), and v ``None``, which
every cache function passes through as the reference treats ``None`` as
an empty subtree), activations are (B, S, d). The
reference's ``lax.scan`` over blocks is a Python loop here, so the
``*_unrolled`` walks (which the reference keeps for per-op addressable
tier-1 traces) are the same functions as their scanned names.

``apply_range``/``prefill_range``/``decode_range`` run blocks [lo, hi)
(``apply_range`` sums the blocks' aux losses) so the Origami executor
can place tier-1 under the Slalom hook and run tier-2 in the clear
(core/origami.py). Decode writes each token's K/V into
the caches in place and returns them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.transformer import lm_defs  # noqa: F401 re-export

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int32": torch.int32}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


def model_defs(cfg: ModelConfig):
    if cfg.family == "cnn":
        from repro_torch.models.vgg import vgg_defs
        return vgg_defs(cfg)
    return T.lm_defs(cfg)


def init_params(cfg: ModelConfig, seed: int, device="cuda"):
    """Random parameters from a seeded ``torch.Generator`` on ``device``,
    in the config's dtype (norm scales in float32)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return L.init_params(model_defs(cfg), gen, device=device,
                         dtype=torch_dtype(cfg.dtype))


def count_params_analytic(cfg: ModelConfig) -> int:
    return L.param_count(model_defs(cfg))


def active_params_analytic(cfg: ModelConfig) -> int:
    """Activated params per token (MoE: top_k of num_experts)."""
    total = count_params_analytic(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_ff_expert
    inactive = cfg.num_layers * (m.num_experts - m.top_k) * per_expert
    return total - inactive


def params_from_numpy(tree, cfg: ModelConfig, device="cuda"):
    """The reference's parameter tree as numpy arrays -> tensors on
    ``device``, each in its definition's dtype. JAX's bf16 leaves reach
    numpy as ``ml_dtypes.bfloat16``, which torch cannot take: every leaf
    goes through float32 (exact for bf16) and is then cast."""
    dtype = torch_dtype(cfg.dtype)

    def convert(leaf, d: L.ParamDef):
        t = torch.from_numpy(np.array(leaf, np.float32))
        return t.to(device=device, dtype=torch_dtype(d.dtype or dtype))

    def walk(node, defs):
        if L.is_def(defs):
            return convert(node, defs)
        return {k: walk(node[k], defs[k]) for k in defs}

    return walk(tree, model_defs(cfg))


def params_to_numpy(params):
    """Tensors -> float32 numpy arrays of the same tree (exact for bf16;
    the caller casts to the reference's dtype)."""
    return tree_map(lambda t: t.detach().to("cpu", torch.float32).numpy(),
                      params)


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig):
    return L.embed_lookup(params["embed"], tokens).to(torch_dtype(cfg.dtype))


def embed_tokens_at(params, token: torch.Tensor, pos, cfg: ModelConfig):
    """The embedding of one decode step's tokens (B, 1); the dense and MoE
    families carry positions in RoPE, so ``pos`` adds nothing here."""
    return embed_tokens(params, token, cfg)


def head(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].to(x.dtype).T
    return L.dense(params["lm_head"], x)


def apply_range(params, x: torch.Tensor, cfg: ModelConfig, lo: int,
                hi: int):
    """Run blocks [lo, hi) on hidden states x -> (x, aux)."""
    aux = 0.0
    for i in range(lo, hi):
        x, a = T.decoder_block_fwd(T.layer_params(params["blocks"], i), x,
                                   cfg)
        aux = aux + a
    return x, aux


def layer_program(cfg: ModelConfig):
    """(prologue, segment, epilogue): the LM layer iterator the plan
    interpreter walks (core/plan.py:program_for)."""
    def prologue(params, batch):
        return embed_tokens(params, batch["tokens"], cfg), None

    def segment(params, x, lo, hi, memory=None):
        return apply_range(params, x, cfg, lo, hi)[0]

    def epilogue(params, x, batch, memory=None):
        return head(params, x, cfg)

    return prologue, segment, epilogue


def forward(params, batch, cfg: ModelConfig) -> T.LMOutputs:
    x = embed_tokens(params, batch["tokens"], cfg)
    x, aux = apply_range(params, x, cfg, 0, cfg.num_layers)
    return T.LMOutputs(head(params, x, cfg), aux)


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16, device="cuda") -> A.KVCache:
    if cfg.attention == "mla":
        width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        return A.KVCache(k=torch.zeros((cfg.num_layers, batch, max_seq,
                                        width), dtype=dtype, device=device),
                         v=None)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return A.KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device))


def prefill_range(params, x: torch.Tensor, cfg: ModelConfig, lo: int,
                  hi: int):
    """Prefill blocks [lo, hi) on hidden states x -> (x, KVCache with a
    leading layer dim of hi - lo)."""
    ks, vs = [], []
    for i in range(lo, hi):
        x, cache, _aux = T.decoder_block_prefill(
            T.layer_params(params["blocks"], i), x, cfg)
        ks.append(cache.k)
        vs.append(cache.v)
    # an MLA cache has no v
    return x, A.KVCache(torch.stack(ks),
                        None if vs[0] is None else torch.stack(vs))


# one loop serves both: every linear op is its own call in eager PyTorch
prefill_range_unrolled = prefill_range


def concat_layer_caches(parts, max_seq: int,
                        dtype=torch.bfloat16) -> A.KVCache:
    """Stitch per-segment prefill caches (leading layer dim) into one
    stack, padded along the sequence axis to ``max_seq``, in the decode
    cache dtype."""
    def cat(leaves):
        if leaves[0] is None:
            return None
        c = torch.cat(leaves, dim=0)
        pad = max_seq - c.shape[2]
        if pad:      # dim 2 (sequence) of (L, B, S, ...)
            c = F.pad(c, (0, 0) * (c.dim() - 3) + (0, pad))
        return c.to(dtype)

    return A.KVCache(cat([p.k for p in parts]), cat([p.v for p in parts]))


def prefill(params, batch, cfg: ModelConfig, *,
            max_seq: Optional[int] = None):
    """(last-position logits, caches sized to max_seq)."""
    tokens = batch["tokens"]
    max_seq = max_seq or tokens.shape[1]
    x = embed_tokens(params, tokens, cfg)
    x, caches = prefill_range(params, x, cfg, 0, cfg.num_layers)
    return head(params, x[:, -1:], cfg), concat_layer_caches([caches],
                                                             max_seq)


def decode_range(params, x: torch.Tensor, caches: A.KVCache, pos,
                 cfg: ModelConfig, lo: int, hi: int):
    """One-token step through blocks [lo, hi) at ``pos`` (an int or a 0-dim
    long tensor); writes the token's K/V into ``caches`` in place."""
    pos = A.position(pos, x.device)
    for i in range(lo, hi):
        x, _ = T.decoder_block_decode(
            T.layer_params(params["blocks"], i), x,
            A.KVCache(caches.k[i], None if caches.v is None
                      else caches.v[i]), pos, cfg)
    return x, caches


decode_range_unrolled = decode_range


def decode_step(params, token: torch.Tensor, caches: A.KVCache, pos,
                cfg: ModelConfig):
    """token: (B, 1) int; pos: the token's position (an int or a 0-dim
    long tensor). -> (logits, caches)."""
    x = embed_tokens_at(params, token, pos, cfg)
    x, caches = decode_range(params, x, caches, pos, cfg, 0, cfg.num_layers)
    return head(params, x, cfg), caches
