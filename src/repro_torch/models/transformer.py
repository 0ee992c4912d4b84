"""Decoder stacks of every LM family the port runs.

Port of ``repro/models/transformer.py``: the gated MLP, the pre-norm
decoder block's forward / prefill / decode with GQA or, for ``attention ==
"mla"``, latent attention (a MoE block runs ``models/moe.py`` in the
MLP's place and returns its aux loss), stacked parameter definitions and
``lm_defs``, whose hybrid tree (Zamba2) stacks the Mamba2 blocks twice,
as (groups, every), beside one shared attention block, whose SSM tree
(xLSTM) stacks the mLSTM blocks as (groups, every - 1) beside one sLSTM
block a group (models/ssm.py), whose audio tree (Whisper) stacks the
encoder blocks (non-causal self-attention) and the decoder blocks (causal
self-attention, cross-attention to the encoder's output, MLP), and whose
VLM tree (Llama-3.2-Vision) stacks the self blocks as (groups, every - 1)
beside one gated cross-attention block a group (its float32 ``attn_gate``
and ``mlp_gate``, zero at init, enter as ``tanh(gate)``). The reference
scans blocks with ``lax.scan`` over stacked parameters; the port keeps the
stacked layout (a leading layer dim on every block leaf) and walks it
with a Python loop (models/model.py). ``remat`` is the reference's
``_maybe_remat``: when training, each block the reference scans runs under
activation checkpointing.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S
from repro_torch.parallel import act_sharding as ash

# (family, attention) pairs the port runs
SUPPORTED = (("dense", "gqa"), ("moe", "gqa"), ("dense", "mla"),
             ("hybrid", "gqa"), ("ssm", "none"), ("audio", "gqa"),
             ("vlm", "gqa"))


def _supported(cfg: ModelConfig) -> None:
    if (cfg.family, cfg.attention) not in SUPPORTED:
        raise NotImplementedError(
            f"{cfg.name}: the port runs {SUPPORTED} (family, attention), "
            f"not {cfg.family}/{cfg.attention} (ROADMAP Queue 1)")


def _gated(cfg: ModelConfig) -> bool:
    return cfg.activation == "silu"


def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None):
    d_ff = d_ff or cfg.d_ff
    d = cfg.d_model
    if _gated(cfg):
        return {"w_gate": L.dense_def(d, d_ff, ("embed", "ffn")),
                "w_up": L.dense_def(d, d_ff, ("embed", "ffn")),
                "w_down": L.dense_def(d_ff, d, ("ffn", "embed"))}
    return {"w_up": L.dense_def(d, d_ff, ("embed", "ffn")),
            "w_down": L.dense_def(d_ff, d, ("ffn", "embed"))}


def mlp_forward(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = L.activation(cfg.activation)
    if "w_gate" in p:
        h = act(L.dense(p["w_gate"], x)) * L.dense(p["w_up"], x)
    else:
        h = act(L.dense(p["w_up"], x))
    h = ash.constrain(h, "batch", "seq", "ffn_act")
    return L.dense(p["w_down"], h)


def decoder_block_defs(cfg: ModelConfig):
    _supported(cfg)
    attn = A.mla_defs(cfg) if cfg.attention == "mla" else A.gqa_defs(cfg)
    d = {"ln1": L.norm_def(cfg.d_model, cfg.norm), "attn": attn,
         "ln2": L.norm_def(cfg.d_model, cfg.norm)}
    if cfg.moe is not None:
        d["moe"] = MOE.moe_defs(cfg)
    else:
        d["mlp"] = mlp_defs(cfg)
    return d


def _attn_fwd(p, x: torch.Tensor, cfg: ModelConfig):
    if cfg.attention == "mla":
        return A.mla_forward(p, x, cfg)
    return A.gqa_forward(p, x, cfg)


def _attn_prefill(p, x: torch.Tensor, cfg: ModelConfig):
    if cfg.attention == "mla":
        return A.mla_prefill(p, x, cfg)
    return A.gqa_prefill(p, x, cfg)


def _attn_decode(p, x: torch.Tensor, cache: A.KVCache, pos,
                 cfg: ModelConfig):
    if cfg.attention == "mla":
        return A.mla_decode(p, x, cache, pos, cfg)
    return A.gqa_decode(p, x, cache, pos, cfg)


def _ffn(p, x: torch.Tensor, cfg: ModelConfig):
    """The block's feed-forward: (y, aux loss; 0.0 for a dense block)."""
    if cfg.moe is not None:
        return MOE.moe_forward(p["moe"], x, cfg)
    return mlp_forward(p["mlp"], x, cfg), 0.0


def decoder_block_fwd(p, x: torch.Tensor, cfg: ModelConfig):
    h = x + _attn_fwd(p["attn"], L.apply_norm(p["ln1"], x, cfg.norm), cfg)
    y, aux = _ffn(p, L.apply_norm(p["ln2"], h, cfg.norm), cfg)
    return ash.constrain(h + y, "batch", "seq", "embed_act"), aux


def decoder_block_prefill(p, x: torch.Tensor, cfg: ModelConfig):
    a, cache = _attn_prefill(p["attn"], L.apply_norm(p["ln1"], x, cfg.norm),
                             cfg)
    h = x + a
    y, aux = _ffn(p, L.apply_norm(p["ln2"], h, cfg.norm), cfg)
    return h + y, cache, aux


def decoder_block_decode(p, x: torch.Tensor, cache: A.KVCache, pos,
                         cfg: ModelConfig):
    a, cache = _attn_decode(p["attn"], L.apply_norm(p["ln1"], x, cfg.norm),
                            cache, pos, cfg)
    h = x + a
    y, _ = _ffn(p, L.apply_norm(p["ln2"], h, cfg.norm), cfg)
    return h + y, cache


def stacked_defs(defs, n: int):
    """Prepend a layer dimension to every ParamDef in ``defs``."""
    return tree_map(lambda d: L.ParamDef((n,) + d.shape, d.init,
                                         ("layers",) + tuple(d.axes), d.dtype),
                    defs)


def slice_layers(stacked, lo: int, hi: int):
    return tree_map(lambda a: a[lo:hi], stacked)


def remat(fn, cfg: ModelConfig, train: bool):
    """``fn`` (a block), for a training forward with ``cfg.remat`` other
    than "none" run under ``checkpoint``: its activations are not kept but
    recomputed in the backward (reference: ``_maybe_remat``, which
    ``jax.checkpoint``s the scanned block)."""
    if not train or cfg.remat == "none":
        return fn

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False)

    return run


def layer_params(stacked, i: int):
    """Block ``i``'s parameters: views into the stacked leaves."""
    return tree_map(lambda a: a[i], stacked)


class LMOutputs(NamedTuple):
    logits: torch.Tensor
    aux_loss: Any


def lm_defs(cfg: ModelConfig) -> Dict[str, object]:
    _supported(cfg)
    d: Dict[str, object] = {
        "embed": L.embed_def(cfg.padded_vocab, cfg.d_model),
        "final_norm": L.norm_def(cfg.d_model, cfg.norm),
    }
    if not cfg.tie_embeddings:
        d["lm_head"] = L.dense_def(cfg.d_model, cfg.padded_vocab,
                                   ("embed", "vocab"))
    if cfg.family == "hybrid":
        e = cfg.hybrid_attn_every
        groups = cfg.num_layers // e
        n_main = groups * e
        mamba = {"norm": L.norm_def(cfg.d_model, cfg.norm),
                 "mamba": S.mamba2_defs(cfg)}
        d["mamba_main"] = stacked_defs(stacked_defs(mamba, e), groups)
        if cfg.num_layers - n_main:
            d["mamba_tail"] = stacked_defs(mamba, cfg.num_layers - n_main)
        d["shared_attn"] = {
            "ln1": L.norm_def(cfg.d_model, cfg.norm),
            "attn": A.gqa_defs(cfg),
            "ln2": L.norm_def(cfg.d_model, cfg.norm),
            "mlp": mlp_defs(cfg),
        }
    elif cfg.family == "ssm":         # xlstm
        every = cfg.ssm.slstm_every
        assert cfg.num_layers % every == 0, "xlstm layers % slstm_every"
        groups = cfg.num_layers // every
        mblock = {"norm": L.norm_def(cfg.d_model, cfg.norm),
                  "mlstm": S.mlstm_defs(cfg)}
        sblock = {"norm": L.norm_def(cfg.d_model, cfg.norm),
                  "slstm": S.slstm_defs(cfg)}
        d["mlstm_groups"] = stacked_defs(stacked_defs(mblock, every - 1),
                                         groups)
        d["slstm_groups"] = stacked_defs(sblock, groups)
    elif cfg.family == "audio":       # whisper enc-dec
        d["enc_blocks"] = stacked_defs(encoder_block_defs(cfg),
                                       cfg.num_layers)
        d["enc_norm"] = L.norm_def(cfg.d_model, cfg.norm)
        d["dec_blocks"] = stacked_defs(cross_decoder_block_defs(cfg),
                                       cfg.num_layers)
    elif cfg.family == "vlm":
        every = cfg.cross_attn_every
        assert cfg.num_layers % every == 0
        groups = cfg.num_layers // every
        d["self_groups"] = stacked_defs(
            stacked_defs(decoder_block_defs(cfg), every - 1), groups)
        d["cross_groups"] = stacked_defs(vlm_cross_block_defs(cfg), groups)
    else:
        d["blocks"] = stacked_defs(decoder_block_defs(cfg), cfg.num_layers)
    return d


# -- Whisper blocks ---------------------------------------------------------

def encoder_block_defs(cfg: ModelConfig):
    return {"ln1": L.norm_def(cfg.d_model, cfg.norm),
            "attn": A.gqa_defs(cfg),
            "ln2": L.norm_def(cfg.d_model, cfg.norm),
            "mlp": mlp_defs(cfg)}


def encoder_block_fwd(p, x: torch.Tensor, cfg: ModelConfig):
    h = x + A.gqa_forward(p["attn"], L.apply_norm(p["ln1"], x, cfg.norm),
                          cfg, causal=False)
    return h + mlp_forward(p["mlp"], L.apply_norm(p["ln2"], h, cfg.norm), cfg)


def cross_decoder_block_defs(cfg: ModelConfig):
    return {"ln1": L.norm_def(cfg.d_model, cfg.norm),
            "attn": A.gqa_defs(cfg),
            "ln_x": L.norm_def(cfg.d_model, cfg.norm),
            "xattn": A.cross_attn_defs(cfg),
            "ln2": L.norm_def(cfg.d_model, cfg.norm),
            "mlp": mlp_defs(cfg)}


def _cross_and_mlp(p, h: torch.Tensor, memory: torch.Tensor,
                   cfg: ModelConfig):
    h = h + A.cross_attn_forward(p["xattn"],
                                 L.apply_norm(p["ln_x"], h, cfg.norm),
                                 memory, cfg)
    return h + mlp_forward(p["mlp"], L.apply_norm(p["ln2"], h, cfg.norm), cfg)


def cross_decoder_block_fwd(p, x: torch.Tensor, memory: torch.Tensor,
                            cfg: ModelConfig):
    h = x + A.gqa_forward(p["attn"], L.apply_norm(p["ln1"], x, cfg.norm),
                          cfg)
    return _cross_and_mlp(p, h, memory, cfg)


def cross_decoder_block_prefill(p, x: torch.Tensor, memory: torch.Tensor,
                                cfg: ModelConfig):
    a, cache = A.gqa_prefill(p["attn"], L.apply_norm(p["ln1"], x, cfg.norm),
                             cfg)
    return _cross_and_mlp(p, x + a, memory, cfg), cache


def cross_decoder_block_decode(p, x: torch.Tensor, cross_ck: torch.Tensor,
                               cross_cv: torch.Tensor, cache: A.KVCache, pos,
                               cfg: ModelConfig):
    """Decode against the precomputed cross K/V (the memory is not
    projected again); the self-attention cache written in place."""
    a, cache = A.gqa_decode(p["attn"], L.apply_norm(p["ln1"], x, cfg.norm),
                            cache, pos, cfg)
    h = x + a
    h = h + A.cross_attn_cached(p["xattn"],
                                L.apply_norm(p["ln_x"], h, cfg.norm),
                                cross_ck, cross_cv, cfg)
    return (h + mlp_forward(p["mlp"], L.apply_norm(p["ln2"], h, cfg.norm),
                            cfg), cache)


# -- Llama-3.2-Vision's gated cross-attention block -------------------------

def vlm_cross_block_defs(cfg: ModelConfig):
    return {"ln1": L.norm_def(cfg.d_model, cfg.norm),
            "xattn": A.cross_attn_defs(cfg),
            "attn_gate": L.ParamDef((1,), "zeros", (None,), torch.float32),
            "ln2": L.norm_def(cfg.d_model, cfg.norm),
            "mlp": mlp_defs(cfg),
            "mlp_gate": L.ParamDef((1,), "zeros", (None,), torch.float32)}


def _gated_mlp(p, h: torch.Tensor, a: torch.Tensor, cfg: ModelConfig):
    """h + tanh(attn_gate) a, then its gated MLP residual."""
    h = h + torch.tanh(p["attn_gate"]).to(h.dtype) * a
    m = mlp_forward(p["mlp"], L.apply_norm(p["ln2"], h, cfg.norm), cfg)
    return h + torch.tanh(p["mlp_gate"]).to(h.dtype) * m


def vlm_cross_block_fwd(p, x: torch.Tensor, patches: torch.Tensor,
                        cfg: ModelConfig):
    a = A.cross_attn_forward(p["xattn"], L.apply_norm(p["ln1"], x, cfg.norm),
                             patches, cfg)
    return _gated_mlp(p, x, a, cfg)


def vlm_cross_block_cached(p, x: torch.Tensor, ck: torch.Tensor,
                           cv: torch.Tensor, cfg: ModelConfig):
    a = A.cross_attn_cached(p["xattn"], L.apply_norm(p["ln1"], x, cfg.norm),
                            ck, cv, cfg)
    return _gated_mlp(p, x, a, cfg)
