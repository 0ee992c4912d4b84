"""Top-level LM API of every LM family: config -> init / forward /
prefill / decode.

Port of the LM part of ``repro/models/model.py``.
Parameters are a nested dict of tensors with the reference's tree and
layouts: block leaves are stacked (a leading layer dim; a MoE expert bank
is (L, E, d, f), its router float32; Zamba2's Mamba2 blocks (groups,
every, ...) and xLSTM's mLSTM blocks (groups, every - 1, ...)), the KV
cache is ``KVCache`` of (L, B, max_seq, KH, D) tensors (an MLA model's: k
the latent and rope key, (L, B, max_seq, kv_lora_rank +
qk_rope_head_dim), and v ``None``, which every cache function passes
through as the reference treats ``None`` as an empty subtree),
activations are (B, S, d). The reference's ``lax.scan`` over blocks is a
Python loop here, so the ``*_unrolled`` walks (which the reference keeps
for per-op addressable tier-1 traces) are the same functions as their
scanned names.

``apply_range``/``prefill_range``/``decode_range`` run blocks [lo, hi)
(``apply_range`` sums the blocks' aux losses) so the Origami executor
can place tier-1 under the Slalom hook and run tier-2 in the clear
(core/origami.py). Decode writes each token's K/V into
the caches in place and returns them.

The recurrent families (hybrid Zamba2: Mamba2 blocks with a shared
attention block after each complete group; SSM xLSTM: groups of mLSTM
blocks closed by an sLSTM block) carry a state instead of a KV cache
(``init_caches``: the per-block Mamba2, mLSTM and sLSTM states, stacked
as their parameters, and the shared block's KV cache, one a group).
``decode_step`` writes each block's new state into those stacks in place
(the reference returns new stacks) and returns the same dict. They have
no ``prefill``, as in the reference: open generation builds the state by
stepping ``decode_step`` through the prompt (runtime/generate.py).

The cross-attention families attend to a memory that the batch carries
beside its tokens. Whisper (audio) encodes ``frames`` (B, 1500, d), cast
to the model dtype and given sinusoidal positions, through its encoder
blocks, and its decoder (sinusoidal positions on the tokens, no RoPE)
attends to the normed encoder output; its Origami ranges are the encoder
blocks (the private input is the audio) and the decoder runs in the
program's epilogue, in the clear like the head. Llama-3.2-Vision (vlm)
closes each group of self blocks with a gated cross block over
``patches`` (B, 1601, d), which the forward keeps in float32, as the
reference does (their K/V come out float32 against bf16 queries;
``sdpa`` promotes); ``prefill_vlm`` casts them to the model dtype. Their
caches are {"self": the self-attention ``KVCache``, "cross_k",
"cross_v": the memory's K/V, bf16, projected once by the prompt pass};
``decode_step`` writes the self caches in place and reads the cross K/V.

``forward(..., train=True)`` is the training forward: each block the
reference scans runs under activation checkpointing (``T.remat``), and
attention differentiates through the flash backward kernel
(models/attention.py). ``loss_fn`` is the reference's next-token loss on
it.
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
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.transformer import lm_defs  # noqa: F401 re-export
from repro_torch.parallel import act_sharding as act

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


def abstract_params(cfg: ModelConfig):
    """The parameter tree as tensors on the ``meta`` device: each leaf's
    shape and dtype, nothing allocated (the dry-run's input)."""
    dtype = torch_dtype(cfg.dtype)
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype or dtype,
                                          device="meta"), model_defs(cfg))


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


def _sinusoidal_positions(cfg: ModelConfig) -> bool:
    """Whisper, and a model without attention and without RoPE, add
    sinusoidal positions to their token embeddings (the reference's
    condition; xLSTM keeps ``rope_theta`` 10000)."""
    return cfg.family == "audio" or (cfg.attention == "none"
                                     and cfg.rope_theta == 0.0)


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig):
    x = L.embed_lookup(params["embed"], tokens).to(torch_dtype(cfg.dtype))
    if _sinusoidal_positions(cfg):
        pe = L.sinusoidal_positions(tokens.shape[-1], cfg.d_model,
                                    device=x.device)
        x = x + pe.to(x.dtype)
    return act.constrain(x, "batch", "seq", "embed_act")


def embed_tokens_at(params, token: torch.Tensor, pos, cfg: ModelConfig):
    """The embedding of one decode step's tokens (B, 1) at position
    ``pos`` (an int or a 0-dim tensor); only a model that adds sinusoidal
    positions reads ``pos`` (the others carry positions in RoPE)."""
    x = L.embed_lookup(params["embed"], token).to(torch_dtype(cfg.dtype))
    if _sinusoidal_positions(cfg):
        d = cfg.d_model
        half = torch.arange(0, d, 2, dtype=torch.float32, device=x.device)
        div = torch.exp(half * (-torch.log(torch.tensor(
            10000.0, dtype=torch.float32, device=x.device)) / d))
        ang = A.position(pos, x.device).to(torch.float32) * div
        pe = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
        x = x + pe.reshape(d).to(x.dtype)
    return x


def head(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    if cfg.tie_embeddings:
        logits = x @ act.for_product(params["embed"]["table"]).to(x.dtype).T
    else:
        logits = L.dense(params["lm_head"], x)
    return act.constrain(logits, "batch", "seq", "vocab")


def _block(stacked, *index):
    """One block's parameters out of a (doubly) stacked subtree: views."""
    return tree_map(lambda a: a[index], stacked)


def _shared_attn_fwd(p, x: torch.Tensor, cfg: ModelConfig):
    h = x + A.gqa_forward(p["attn"], L.apply_norm(p["ln1"], x, cfg.norm),
                          cfg)
    return h + T.mlp_forward(p["mlp"], L.apply_norm(p["ln2"], h, cfg.norm),
                             cfg)


def _mamba_blk(p, x: torch.Tensor, cfg: ModelConfig):
    return x + S.mamba2_forward(p["mamba"],
                                L.apply_norm(p["norm"], x, cfg.norm), cfg)


def _range_hybrid(params, x: torch.Tensor, cfg: ModelConfig, lo: int,
                  hi: int, train: bool = False):
    """Zamba2's blocks [lo, hi): the Mamba2 blocks of each group, and the
    shared attention block after a group that completes inside the range;
    then the tail past the last group."""
    mamba_blk = T.remat(lambda p, h: _mamba_blk(p, h, cfg), cfg, train)
    e = cfg.hybrid_attn_every
    groups = cfg.num_layers // e
    n_main = groups * e
    for g in range(groups):
        g_lo, g_hi = g * e, (g + 1) * e
        a, b = max(lo, g_lo), min(hi, g_hi)
        if a >= b:
            continue
        for j in range(a - g_lo, b - g_lo):
            x = mamba_blk(_block(params["mamba_main"], g, j), x)
        if b == g_hi and hi >= g_hi:   # group completed inside range
            x = _shared_attn_fwd(params["shared_attn"], x, cfg)
    a, b = max(lo, n_main), min(hi, cfg.num_layers)
    if a < b and "mamba_tail" in params:
        for j in range(a - n_main, b - n_main):
            x = mamba_blk(_block(params["mamba_tail"], j), x)
    return x, 0.0


def _mlstm_blk(p, x: torch.Tensor, cfg: ModelConfig):
    return x + S.mlstm_forward(p["mlstm"],
                               L.apply_norm(p["norm"], x, cfg.norm), cfg)


def _range_xlstm(params, x: torch.Tensor, cfg: ModelConfig, lo: int,
                 hi: int, train: bool = False):
    """xLSTM's blocks [lo, hi): in each group of ``slstm_every`` the mLSTM
    blocks, then the sLSTM block that closes the group."""
    mlstm_blk = T.remat(lambda p, h: _mlstm_blk(p, h, cfg), cfg, train)
    e = cfg.ssm.slstm_every
    groups = cfg.num_layers // e
    for g in range(groups):
        g_lo = g * e
        a, b = max(lo, g_lo), min(hi, g_lo + e - 1)   # mlstm sub-blocks
        for j in range(a - g_lo, b - g_lo):
            x = mlstm_blk(_block(params["mlstm_groups"], g, j), x)
        sidx = g_lo + e - 1
        if lo <= sidx < hi:
            sp = _block(params["slstm_groups"], g)
            y, _ = S.slstm_forward(sp["slstm"],
                                   L.apply_norm(sp["norm"], x, cfg.norm), cfg)
            x = x + y
    return x, 0.0


def _range_vlm(params, x: torch.Tensor, cfg: ModelConfig, lo: int, hi: int,
               patches: torch.Tensor, train: bool = False):
    """Llama-3.2-Vision's blocks [lo, hi): in each group of
    ``cross_attn_every`` the self blocks, then the gated cross block over
    ``patches`` that closes the group."""
    self_blk = T.remat(lambda p, h: T.decoder_block_fwd(p, h, cfg), cfg,
                       train)
    e = cfg.cross_attn_every
    groups = cfg.num_layers // e
    for g in range(groups):
        g_lo = g * e
        a, b = max(lo, g_lo), min(hi, g_lo + e - 1)   # self sub-blocks
        for j in range(a - g_lo, b - g_lo):
            x, _ = self_blk(_block(params["self_groups"], g, j), x)
        cidx = g_lo + e - 1
        if lo <= cidx < hi:
            x = T.vlm_cross_block_fwd(_block(params["cross_groups"], g), x,
                                      patches, cfg)
    return x, 0.0


def _range_audio_encoder(params, x: torch.Tensor, cfg: ModelConfig, lo: int,
                         hi: int, train: bool = False):
    blk = T.remat(lambda p, h: T.encoder_block_fwd(p, h, cfg), cfg, train)
    for i in range(lo, hi):
        x = blk(T.layer_params(params["enc_blocks"], i), x)
    return x, 0.0


def apply_range(params, x: torch.Tensor, cfg: ModelConfig, lo: int,
                hi: int, *, memory: Optional[torch.Tensor] = None,
                train: bool = False):
    """Run blocks [lo, hi) on hidden states x -> (x, aux). ``memory``: a
    VLM's patches; an audio model's range is over its encoder blocks.
    ``train``: each block the reference scans runs under ``T.remat``."""
    if cfg.family == "hybrid":
        return _range_hybrid(params, x, cfg, lo, hi, train)
    if cfg.family == "ssm":
        return _range_xlstm(params, x, cfg, lo, hi, train)
    if cfg.family == "vlm":
        return _range_vlm(params, x, cfg, lo, hi, memory, train)
    if cfg.family == "audio":
        # ranges apply to the encoder (tier-1 is a prefix of the encoder)
        return _range_audio_encoder(params, x, cfg, lo, hi, train)
    blk = T.remat(lambda p, h: T.decoder_block_fwd(p, h, cfg), cfg, train)
    aux = 0.0
    for i in range(lo, hi):
        x, a = blk(T.layer_params(params["blocks"], i), x)
        aux = aux + a
    return x, aux


def _audio_input(frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Whisper's encoder input: the frames in the model dtype plus
    sinusoidal positions."""
    x = frames.to(torch_dtype(cfg.dtype))
    pe = L.sinusoidal_positions(x.shape[1], cfg.d_model, device=x.device)
    return x + pe.to(x.dtype)


def layer_program(cfg: ModelConfig):
    """(prologue, segment, epilogue): the LM layer iterator the plan
    interpreter walks (core/plan.py:program_for).

    Audio plans range over the encoder blocks; the decoder runs in the
    epilogue, in the clear like the LM head. A VLM's prologue hands the
    batch's patches to every segment as the memory."""
    audio = cfg.family == "audio"

    def prologue(params, batch):
        if audio:
            return _audio_input(batch["frames"], cfg), None
        memory = batch.get("patches") if cfg.family == "vlm" else None
        return embed_tokens(params, batch["tokens"], cfg), memory

    def segment(params, x, lo, hi, memory=None):
        return apply_range(params, x, cfg, lo, hi, memory=memory)[0]

    def epilogue(params, x, batch, memory=None):
        if audio:
            mem = L.apply_norm(params["enc_norm"], x, cfg.norm)
            return forward_audio_decoder(params, batch, mem, cfg)
        return head(params, x, cfg)

    return prologue, segment, epilogue


# the memory a cross-attention family's forward and prompt pass read from
# the batch beside the tokens
MEMORY_KEYS = {"audio": "frames", "vlm": "patches"}


def forward(params, batch, cfg: ModelConfig, *,
            train: bool = False) -> T.LMOutputs:
    """Teacher-forced logits at every position: {"tokens"} and, for the
    cross-attention families, {"frames"} (audio) or {"patches"} (vlm).
    ``train``: the blocks the reference scans run under ``T.remat``."""
    if cfg.family == "audio":
        memory = encode_audio(params, batch["frames"], cfg, train=train)
        return T.LMOutputs(forward_audio_decoder(params, batch, memory, cfg,
                                                 train=train), 0.0)
    x = embed_tokens(params, batch["tokens"], cfg)
    memory = batch.get("patches") if cfg.family == "vlm" else None
    x, aux = apply_range(params, x, cfg, 0, cfg.num_layers, memory=memory,
                         train=train)
    return T.LMOutputs(head(params, x, cfg), aux)


def loss_fn(params, batch, cfg: ModelConfig, aux_weight: float = 0.01):
    """(ce + aux_weight * aux loss, ce) of next-token prediction over the
    shifted tokens, from a training forward (reference: ``loss_fn``)."""
    out = forward(params, batch, cfg, train=True)
    logits = out.logits[:, :-1]
    labels = batch["tokens"][:, 1:]
    ce = L.cross_entropy(logits, labels, cfg.vocab_size)
    return ce + aux_weight * out.aux_loss, ce


def encode_audio(params, frames: torch.Tensor, cfg: ModelConfig, *,
                 train: bool = False):
    """Whisper's encoder: frames (B, M, d) -> the normed memory (B, M, d)."""
    x, _ = _range_audio_encoder(params, _audio_input(frames, cfg), cfg, 0,
                                cfg.num_layers, train)
    return L.apply_norm(params["enc_norm"], x, cfg.norm)


def forward_audio_decoder(params, batch, memory: torch.Tensor,
                          cfg: ModelConfig, *,
                          train: bool = False) -> torch.Tensor:
    """Whisper's decoder over a precomputed encoder memory -> logits (the
    Origami program's epilogue)."""
    x = embed_tokens(params, batch["tokens"], cfg)
    blk = T.remat(lambda p, h: T.cross_decoder_block_fwd(p, h, memory, cfg),
                  cfg, train)
    for i in range(cfg.num_layers):
        x = blk(T.layer_params(params["dec_blocks"], i), x)
    return head(params, x, cfg)


def _tuple_like(t: tuple, items):
    """``items`` as a tuple of ``t``'s type (a NamedTuple or a tuple)."""
    return type(t)(*items) if hasattr(t, "_fields") else tuple(items)


def _stack_state(state, *lead):
    """A per-block state NamedTuple (nested tuples of tensors) with every
    leaf repeated over the leading dims ``lead``."""
    if isinstance(state, tuple):
        return _tuple_like(state, [_stack_state(s, *lead) for s in state])
    return state.expand(lead + tuple(state.shape)).clone()


def _state_at(stacked, *index):
    """The block at ``index`` of a stacked state: views."""
    if isinstance(stacked, tuple):
        return _tuple_like(stacked, [_state_at(s, *index) for s in stacked])
    return stacked[index]


def _write_state(stacked, new, *index) -> None:
    """Copy a block's new state into its slot of the stacked state."""
    if isinstance(stacked, tuple):
        for s, n in zip(stacked, new):
            _write_state(s, n, *index)
        return
    stacked[index].copy_(new)


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16, device="cuda"):
    """The decode caches: a ``KVCache`` for the dense and MoE families; for
    Zamba2 {"main": Mamba2State (groups, every, B, ...), "shared": the
    shared block's KVCache (groups, B, max_seq, KH, D), "tail":
    Mamba2State (tail, B, ...) when there is a tail}; for xLSTM {"mlstm":
    MLSTMState (groups, every - 1, B, ...), "slstm": SLSTMState (groups,
    B, ...)}; for Whisper {"self": KVCache (L, B, max_seq, KH, D),
    "cross_k", "cross_v": (L, B, encoder_seq_len, KH, D)}; for
    Llama-3.2-Vision {"self": KVCache (groups, every - 1, B, max_seq, KH,
    D), "cross_k", "cross_v": (groups, B, vision_seq_len, KH, D)}. The
    recurrent states are float32 and zero."""
    hd = cfg.resolved_head_dim
    if cfg.family in ("audio", "vlm"):
        if cfg.family == "audio":
            lead, mem = (cfg.num_layers,), cfg.encoder_seq_len
            self_lead = lead
        else:
            e = cfg.cross_attn_every
            lead, mem = (cfg.num_layers // e,), cfg.vision_seq_len
            self_lead = lead + (e - 1,)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        return {"self": A.KVCache(
                    zeros(*self_lead, batch, max_seq, cfg.num_kv_heads, hd),
                    zeros(*self_lead, batch, max_seq, cfg.num_kv_heads, hd)),
                "cross_k": zeros(*lead, batch, mem, cfg.num_kv_heads, hd),
                "cross_v": zeros(*lead, batch, mem, cfg.num_kv_heads, hd)}
    if cfg.family == "hybrid":
        e = cfg.hybrid_attn_every
        groups = cfg.num_layers // e
        tail = cfg.num_layers - groups * e
        st = S.mamba2_init_state(cfg, batch, device=device)
        shape = (groups, batch, max_seq, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        caches = {"main": _stack_state(st, groups, e),
                  "shared": A.KVCache(
                      k=torch.zeros(shape, dtype=dtype, device=device),
                      v=torch.zeros(shape, dtype=dtype, device=device))}
        if tail:
            caches["tail"] = _stack_state(st, tail)
        return caches
    if cfg.family == "ssm":
        e = cfg.ssm.slstm_every
        groups = cfg.num_layers // e
        return {"mlstm": _stack_state(
                    S.mlstm_init_state(cfg, batch, device=device),
                    groups, e - 1),
                "slstm": _stack_state(
                    S.slstm_init_state(cfg, batch, device=device), groups)}
    if cfg.attention == "mla":
        width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        return A.KVCache(k=torch.zeros((cfg.num_layers, batch, max_seq,
                                        width), dtype=dtype, device=device),
                         v=None)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, hd)
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


def _cross_prefill_out(params, x: torch.Tensor, cfg: ModelConfig, ks, vs,
                       cks, cvs, max_seq: int):
    """A cross-attention prompt pass's (last-position logits, caches): the
    stacked self K/V (..., S, KH, D) zero-padded along S to ``max_seq``
    and the stacked cross K/V, all bf16."""
    def pad(c):
        return F.pad(c, (0, 0, 0, 0, 0, max_seq - c.shape[-3])).to(
            torch.bfloat16)

    return head(params, x[:, -1:], cfg), {
        "self": A.KVCache(pad(torch.stack(ks)), pad(torch.stack(vs))),
        "cross_k": torch.stack(cks).to(torch.bfloat16),
        "cross_v": torch.stack(cvs).to(torch.bfloat16)}


def prefill(params, batch, cfg: ModelConfig, *,
            max_seq: Optional[int] = None):
    """(last-position logits, caches sized to max_seq). Whisper's batch
    carries its ``frames``: the encoder runs once, and each decoder block
    leaves its self-attention K/V and the memory's cross K/V (bf16)."""
    if cfg.family == "vlm":
        raise NotImplementedError("prefill for family vlm: use prefill_vlm")
    if cfg.family not in ("dense", "moe", "audio"):
        raise NotImplementedError(
            f"prefill for family {cfg.family}: use forward() + "
            f"decode-from-scratch (runtime/generate.py steps decode_step "
            f"through the prompt)")
    tokens = batch["tokens"]
    max_seq = max_seq or tokens.shape[1]
    if cfg.family == "audio":
        return _prefill_audio(params, batch, cfg, max_seq)
    x = embed_tokens(params, tokens, cfg)
    x, caches = prefill_range(params, x, cfg, 0, cfg.num_layers)
    return head(params, x[:, -1:], cfg), concat_layer_caches([caches],
                                                             max_seq)


def _prefill_audio(params, batch, cfg: ModelConfig, max_seq: int):
    memory = encode_audio(params, batch["frames"], cfg)
    x = embed_tokens(params, batch["tokens"], cfg)
    ks, vs, cks, cvs = [], [], [], []
    for i in range(cfg.num_layers):
        p = T.layer_params(params["dec_blocks"], i)
        x, cache = T.cross_decoder_block_prefill(p, x, memory, cfg)
        ck, cv = A.cross_kv(p["xattn"], memory, cfg)
        ks.append(cache.k)
        vs.append(cache.v)
        cks.append(ck)
        cvs.append(cv)
    return _cross_prefill_out(params, x, cfg, ks, vs, cks, cvs, max_seq)


def prefill_vlm(params, batch, cfg: ModelConfig, *,
                max_seq: Optional[int] = None):
    """Llama-3.2-Vision's prompt pass over {"tokens", "patches"} (the
    patches cast to the model dtype, as the reference's) -> (last-position
    logits, {"self": KVCache (groups, every - 1, B, max_seq, KH, D),
    "cross_k", "cross_v": (groups, B, M, KH, D)}, all bf16)."""
    tokens = batch["tokens"]
    max_seq = max_seq or tokens.shape[1]
    x = embed_tokens(params, tokens, cfg)
    patches = batch["patches"].to(x.dtype)
    e = cfg.cross_attn_every
    ks, vs, cks, cvs = [], [], [], []
    for g in range(cfg.num_layers // e):
        gk, gv = [], []
        for j in range(e - 1):
            x, cache, _ = T.decoder_block_prefill(
                _block(params["self_groups"], g, j), x, cfg)
            gk.append(cache.k)
            gv.append(cache.v)
        cp = _block(params["cross_groups"], g)
        x = T.vlm_cross_block_fwd(cp, x, patches, cfg)
        ck, cv = A.cross_kv(cp["xattn"], patches, cfg)
        ks.append(torch.stack(gk))
        vs.append(torch.stack(gv))
        cks.append(ck)
        cvs.append(cv)
    return _cross_prefill_out(params, x, cfg, ks, vs, cks, cvs, max_seq)


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


def decode_step(params, token: torch.Tensor, caches, pos,
                cfg: ModelConfig):
    """token: (B, 1) int; pos: the token's position (an int or a 0-dim
    long tensor). -> (logits, caches), the caches updated in place."""
    x = embed_tokens_at(params, token, pos, cfg)
    if cfg.family == "hybrid":
        return _decode_hybrid(params, x, caches, pos, cfg)
    if cfg.family == "ssm":
        return _decode_xlstm(params, x, caches, pos, cfg)
    if cfg.family == "audio":
        return _decode_audio(params, x, caches, pos, cfg)
    if cfg.family == "vlm":
        return _decode_vlm(params, x, caches, pos, cfg)
    x, caches = decode_range(params, x, caches, pos, cfg, 0, cfg.num_layers)
    return head(params, x, cfg), caches


def _mamba_decode_blk(p, x: torch.Tensor, states, cfg: ModelConfig, *index):
    y, new = S.mamba2_decode(p["mamba"], L.apply_norm(p["norm"], x, cfg.norm),
                             _state_at(states, *index), cfg)
    _write_state(states, new, *index)
    return x + y


def _decode_hybrid(params, x: torch.Tensor, caches, pos, cfg: ModelConfig):
    e = cfg.hybrid_attn_every
    groups = cfg.num_layers // e
    pos = A.position(pos, x.device)
    sp = params["shared_attn"]
    shared = caches["shared"]
    for g in range(groups):
        for j in range(e):
            x = _mamba_decode_blk(_block(params["mamba_main"], g, j), x,
                                  caches["main"], cfg, g, j)
        a, _ = A.gqa_decode(sp["attn"], L.apply_norm(sp["ln1"], x, cfg.norm),
                            A.KVCache(shared.k[g], shared.v[g]), pos, cfg)
        x = x + a
        x = x + T.mlp_forward(sp["mlp"], L.apply_norm(sp["ln2"], x, cfg.norm),
                              cfg)
    if "tail" in caches:
        for j in range(cfg.num_layers - groups * e):
            x = _mamba_decode_blk(_block(params["mamba_tail"], j), x,
                                  caches["tail"], cfg, j)
    return head(params, x, cfg), caches


def _decode_xlstm(params, x: torch.Tensor, caches, pos, cfg: ModelConfig):
    e = cfg.ssm.slstm_every
    groups = cfg.num_layers // e
    for g in range(groups):
        for j in range(e - 1):
            p = _block(params["mlstm_groups"], g, j)
            y, new = S.mlstm_decode(
                p["mlstm"], L.apply_norm(p["norm"], x, cfg.norm),
                _state_at(caches["mlstm"], g, j), cfg)
            _write_state(caches["mlstm"], new, g, j)
            x = x + y
        sp = _block(params["slstm_groups"], g)
        y, new = S.slstm_forward(
            sp["slstm"], L.apply_norm(sp["norm"], x, cfg.norm), cfg,
            state=_state_at(caches["slstm"], g))
        _write_state(caches["slstm"], new, g)
        x = x + y
    return head(params, x, cfg), caches


def _decode_audio(params, x: torch.Tensor, caches, pos, cfg: ModelConfig):
    pos = A.position(pos, x.device)
    sc = caches["self"]
    for i in range(cfg.num_layers):
        x, _ = T.cross_decoder_block_decode(
            T.layer_params(params["dec_blocks"], i), x,
            caches["cross_k"][i], caches["cross_v"][i],
            A.KVCache(sc.k[i], sc.v[i]), pos, cfg)
    return head(params, x, cfg), caches


def _decode_vlm(params, x: torch.Tensor, caches, pos, cfg: ModelConfig):
    e = cfg.cross_attn_every
    pos = A.position(pos, x.device)
    sc = caches["self"]
    for g in range(cfg.num_layers // e):
        for j in range(e - 1):
            x, _ = T.decoder_block_decode(
                _block(params["self_groups"], g, j), x,
                A.KVCache(sc.k[g, j], sc.v[g, j]), pos, cfg)
        x = T.vlm_cross_block_cached(_block(params["cross_groups"], g), x,
                                     caches["cross_k"][g],
                                     caches["cross_v"][g], cfg)
    return head(params, x, cfg), caches
