"""Mixture-of-Experts: the top-k router and three dispatch implementations.

Port of ``repro/models/moe.py``:

- ``gshard``: dense one-hot dispatch and combine einsums; memory scales
  with T·E·C, the baseline the smoke configs run;
- ``sorted``: experts sorted by a stable argsort into static (E, C)
  capacity buffers; memory scales with T·k·d;
- ``sorted_grouped``: the sorted dispatch within token groups (32, halved
  until they divide the token count), the path of the full configs.

All three drop the assignments past an expert's capacity in the same
order (token-major, then the token's top-k rank), and the router takes a
softmax, then the top-k, then normalizes the k weights. The experts are
einsums over the expert banks, not ``layers.dense`` calls, so the Slalom
hook never intercepts them: they run in the enclave in tier-1, as in the
reference. Only Arctic's dense-residual FFN goes through ``layers.dense``.

Where the port departs from the reference's code, not its function:

- ``lax.top_k`` puts the lower expert first on a tie; the port takes the
  first k of a stable descending sort, which does the same.
- ``_dispatch_sorted_grouped`` vmaps the sorted dispatch over the groups;
  the port runs it batched over a group axis (a batched stable argsort
  and ``searchsorted``), and the expert FFN as one ``bmm`` a projection
  over (E, G·C, d): one read of the expert banks for all groups.
- The capacity buffers are filled by a gather (slot (e, c) of a group
  takes the group's sorted assignment ``start[e] + c`` when that is one of
  expert e's), not by a scatter, so no write collides.
- The combine (``.at[tok].add(rows * w)`` in the reference, in the
  activations' dtype and in the order of the sorted assignments: a
  token's k experts by ascending id) gathers each token's k weighted rows
  in ascending-expert order and adds them one after another in that
  dtype, from zeros. No atomics: two runs of one batch agree bit for bit,
  which the blinded-against-trusted gate and a CUDA graph of the trusted
  forward need.
- Nothing reads a value back to the host (no ``.item()``, ``nonzero`` or
  boolean indexing; ``one_hot`` is a comparison with an ``arange``), so
  the layer runs inside a CUDA graph capture.
- ``act_sharding.constrain`` is a no-op without a mesh; the port, on one
  card, leaves it out.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def moe_defs(cfg: ModelConfig) -> Dict[str, object]:
    m = cfg.moe
    d = cfg.d_model
    defs = {
        "router": {"w": L.ParamDef((d, m.num_experts), "scaled",
                                   ("embed", None), torch.float32)},
        "w_gate": L.ParamDef((m.num_experts, d, m.d_ff_expert), "scaled",
                             ("experts", "embed", "ffn")),
        "w_up": L.ParamDef((m.num_experts, d, m.d_ff_expert), "scaled",
                           ("experts", "embed", "ffn")),
        "w_down": L.ParamDef((m.num_experts, m.d_ff_expert, d), "scaled",
                             ("experts", "ffn", "embed")),
    }
    if m.dense_residual_d_ff:
        defs["dense_residual"] = {
            "w_gate": L.dense_def(d, m.dense_residual_d_ff, ("embed", "ffn")),
            "w_up": L.dense_def(d, m.dense_residual_d_ff, ("embed", "ffn")),
            "w_down": L.dense_def(m.dense_residual_d_ff, d, ("ffn", "embed")),
        }
    return defs


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(c, m.top_k)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of ``idx`` over ``n`` classes; an index outside
    [0, n) gives a zero row, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


def _route(p, x: torch.Tensor, cfg: ModelConfig):
    """x: (..., T, d) -> (weights (..., T, k) float32, experts (..., T, k),
    aux loss (...)): the leading dims are token groups, each with its own
    load-balancing loss."""
    m = cfg.moe
    logits = x.to(torch.float32) @ p["router"]["w"]              # (..., T, E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: descending, the lower expert first on a tie
    weights, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, experts = weights[..., :m.top_k], experts[..., :m.top_k]
    weights = weights / torch.clamp(
        torch.sum(weights, dim=-1, keepdim=True), min=1e-9)
    # load-balancing auxiliary loss (Switch-style)
    me = torch.mean(probs, dim=-2)
    ce = torch.mean(torch.sum(_one_hot(experts, m.num_experts), dim=-2),
                    dim=-2)
    aux = m.num_experts * torch.sum(me * ce, dim=-1)
    return weights, experts, aux


def _expert_ffn(p, xe: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """xe: (E, C, d) -> (E, C, d), per-expert gated MLP."""
    act = L.activation(cfg.activation)
    h = act(torch.bmm(xe, p["w_gate"].to(xe.dtype)))
    h = h * torch.bmm(xe, p["w_up"].to(xe.dtype))
    return torch.bmm(h, p["w_down"].to(xe.dtype))


def _dispatch_gshard(p, x: torch.Tensor, cfg: ModelConfig):
    """Dense one-hot dispatch. x: (T, d)."""
    m = cfg.moe
    T, d = x.shape
    C = _capacity(T, cfg)
    weights, experts, aux = _route(p, x, cfg)
    onehot = _one_hot(experts, m.num_experts)                    # (T, k, E)
    # position of each (token, slot) within its expert queue
    pos = torch.cumsum(onehot.reshape(T * m.top_k, m.num_experts), 0) - 1.0
    pos = torch.sum(pos.reshape(T, m.top_k, m.num_experts) * onehot, dim=-1)
    keep = pos < C
    pos_oh = _one_hot(torch.where(keep, pos, float(C)).to(torch.long), C)
    pos_oh = pos_oh * keep[..., None]
    dispatch = torch.einsum("tke,tkc->tec", onehot, pos_oh)       # (T, E, C)
    combine = torch.einsum("tk,tke,tkc->tec", weights, onehot, pos_oh)
    xe = torch.einsum("tec,td->ecd", dispatch, x.to(torch.float32))
    ye = _expert_ffn(p, xe.to(x.dtype), cfg)
    y = torch.einsum("tec,ecd->td", combine, ye.to(torch.float32))
    return y.to(x.dtype), aux


def _dispatch_groups(p, xg: torch.Tensor, cfg: ModelConfig):
    """The sorted dispatch of every group at once. xg: (G, Tg, d) ->
    (y (G, Tg, d), aux (G,)): each group routes, sorts and fills its own
    (E, C) capacity buffers, C from its Tg tokens, as one call of the
    reference's ``_dispatch_sorted`` on it."""
    m = cfg.moe
    G, Tg, d = xg.shape
    E, k = m.num_experts, m.top_k
    N = Tg * k                                                   # assignments
    C = _capacity(Tg, cfg)
    dev = xg.device
    weights, experts, aux = _route(p, xg, cfg)                   # (G, Tg, k)
    flat_e = experts.reshape(G, N)
    order = torch.argsort(flat_e, dim=-1, stable=True)           # (G, N)
    se = torch.gather(flat_e, 1, order)
    sw = torch.gather(weights.reshape(G, N), 1, order)
    stok = order // k                      # the sorted assignments' tokens
    ids = torch.arange(E, device=dev).expand(G, E).contiguous()
    starts = torch.searchsorted(se, ids)                         # (G, E)
    counts = torch.searchsorted(se, ids, right=True) - starts
    rank = torch.arange(N, device=dev) - torch.gather(starts, 1, se)
    keep = rank < C

    # capacity buffers, laid out (E, G, C) so the experts' bmm reads each
    # bank once: slot (e, g, c) <- token stok[g, starts[g, e] + c] when
    # c < counts[g, e], else the zero row past the last token
    c_ix = torch.arange(C, device=dev)
    src = (starts[:, :, None] + c_ix).clamp(max=N - 1)           # (G, E, C)
    tok = torch.gather(stok, 1, src.reshape(G, E * C)).reshape(G, E, C)
    g_ix = torch.arange(G, device=dev)[:, None, None]
    row = torch.where(c_ix < counts[:, :, None], g_ix * Tg + tok, G * Tg)
    x_rows = torch.cat([xg.reshape(G * Tg, d), xg.new_zeros((1, d))])
    buf = x_rows.index_select(0, row.permute(1, 0, 2).reshape(-1))
    ye = _expert_ffn(p, buf.reshape(E, G * C, d), cfg)          # (E, G*C, d)

    # each sorted assignment's expert row, zero where it was dropped
    back = (se * (G * C) + g_ix[:, :, 0] * C
            + torch.clamp(rank, max=C - 1))                      # (G, N)
    rows = ye.reshape(E * G * C, d).index_select(0, back.reshape(-1))
    rows = torch.where(keep.reshape(-1, 1), rows, 0.0).reshape(G, N, d)
    contrib = rows * sw[..., None].to(xg.dtype)
    # the combine: each token's k rows by ascending expert, added in order
    inv = torch.argsort(order, dim=-1)      # sorted index of each (t, slot)
    by_expert = torch.argsort(experts, dim=-1)                   # (G, Tg, k)
    pick = torch.gather(inv.reshape(G, Tg, k), 2, by_expert)
    picked = contrib.reshape(G * N, d).index_select(
        0, (g_ix[:, :, 0] * N + pick.reshape(G, N)).reshape(-1))
    picked = picked.reshape(G, Tg, k, d)
    y = xg.new_zeros((G, Tg, d))
    for j in range(k):
        y = y + picked[:, :, j]
    return y, aux


def _dispatch_sorted(p, x: torch.Tensor, cfg: ModelConfig):
    """Argsort dispatch with static (E, C) capacity buffers. x: (T, d)."""
    y, aux = _dispatch_groups(p, x[None], cfg)
    return y[0], aux[0]


def token_groups(tokens: int, groups: int = 32) -> int:
    """The groups ``_dispatch_sorted_grouped`` cuts ``tokens`` into:
    ``groups`` halved until it divides them."""
    while tokens % groups != 0 and groups > 1:
        groups //= 2
    return groups


def _dispatch_sorted_grouped(p, x: torch.Tensor, cfg: ModelConfig,
                             groups: int = 32):
    """Sorted dispatch within token groups: the reference's per-data-shard
    groups, each sorted on its own; the aux loss is the groups' mean."""
    T, d = x.shape
    groups = token_groups(T, groups)
    y, aux = _dispatch_groups(p, x.reshape(groups, T // groups, d), cfg)
    return y.reshape(T, d), torch.mean(aux)


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, d) -> (B, S, d); returns (y, aux_loss)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    if cfg.moe.dispatch == "sorted_grouped":
        y, aux = _dispatch_sorted_grouped(p, xt, cfg)
    elif cfg.moe.dispatch == "sorted":
        y, aux = _dispatch_sorted(p, xt, cfg)
    else:
        y, aux = _dispatch_gshard(p, xt, cfg)
    if cfg.moe.dense_residual_d_ff:
        act = L.activation(cfg.activation)
        pr = p["dense_residual"]
        h = act(L.dense(pr["w_gate"], xt)) * L.dense(pr["w_up"], xt)
        y = y + L.dense(pr["w_down"], h)
    return y.reshape(B, S, d), aux
