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
- ``act_sharding.constrain`` pins the groups over the batch axes at the
  reference's two points; it is a no-op without a mesh.
- The dispatch's gather has a backward of its own (``_DispatchRows``):
  each token's slots summed by a gather in ascending-expert order, the
  order the CPU's ``index_add_`` takes; on the card ``index_select``'s
  backward adds with atomics, so two runs of a train step differed.

On a device mesh (DTensors, launch/train.py's ``mesh=``) the grouping is
the reference's whatever the mesh (32 groups, halved until they divide
the tokens), and the mesh decides only where each group's rows live: the
routing's top-k, the sort, ``searchsorted`` and the gather of each group's
rows (``_fill``) and the combine (``_combine``) run on each rank's own
groups through ``local_map``, the groups over the active rules' batch axes
(``act_sharding.batch_placements``), as the reference's per-group sort is
local under its batch constraint; the router's product and the experts'
(``_expert_ffn``) stay DTensor ops, so the experts' layout and the
token-to-expert exchange are DTensor's. This, not a sharding strategy
registered for ``searchsorted``: the sort, the searches and the index
arithmetic are per group by construction, and a strategy for each of
their ops (``searchsorted``, the batched ``argsort``/``gather`` and the
index arithmetic, ~30 DTensor dispatches a layer) would only restate
that; on one rank the local functions see the whole tensors, so a 1 x 1
mesh computes the mesh-less bits.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.parallel import act_sharding as ash


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
    return _top_k(x.to(torch.float32) @ p["router"]["w"], cfg)


def _top_k(logits: torch.Tensor, cfg: ModelConfig):
    """``_route`` from the router's logits (..., T, E)."""
    m = cfg.moe
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
    if ash.is_dtensor(xg):
        return _sharded_groups(p, xg, cfg)
    weights, experts, aux = _route(p, xg, cfg)                   # (G, Tg, k)
    buf, se, rank, sw, pick = _fill(xg, weights, experts, cfg)
    return _combine(_expert_ffn(p, buf, cfg), se, rank, sw, pick), aux


def _fill(xg: torch.Tensor, weights, experts, cfg: ModelConfig):
    """Sort each group's assignments and gather its rows. xg: (G, Tg, d),
    the routing's weights and experts (G, Tg, k) -> (capacity buffers
    (E, G·C, d); per group the sorted assignments' experts ``se`` and
    ranks within their expert (G, N), their weights ``sw`` (G, N), each
    token's k sorted indices by ascending expert ``pick`` (G, Tg, k))."""
    m = cfg.moe
    G, Tg, d = xg.shape
    E, k = m.num_experts, m.top_k
    N = Tg * k                                                   # assignments
    C = _capacity(Tg, cfg)
    dev = xg.device
    flat_e = experts.reshape(G, N)
    order = torch.argsort(flat_e, dim=-1, stable=True)           # (G, N)
    se = torch.gather(flat_e, 1, order)
    sw = torch.gather(weights.reshape(G, N), 1, order)
    stok = order // k                      # the sorted assignments' tokens
    ids = torch.arange(E, device=dev).expand(G, E).contiguous()
    starts = torch.searchsorted(se, ids)                         # (G, E)
    counts = torch.searchsorted(se, ids, right=True) - starts
    rank = torch.arange(N, device=dev) - torch.gather(starts, 1, se)

    # capacity buffers, laid out (E, G, C) so the experts' bmm reads each
    # bank once: slot (e, g, c) <- token stok[g, starts[g, e] + c] when
    # c < counts[g, e], else the zero row past the last token
    c_ix = torch.arange(C, device=dev)
    src = (starts[:, :, None] + c_ix).clamp(max=N - 1)           # (G, E, C)
    tok = torch.gather(stok, 1, src.reshape(G, E * C)).reshape(G, E, C)
    g_ix = torch.arange(G, device=dev)[:, None, None]
    row = torch.where(c_ix < counts[:, :, None], g_ix * Tg + tok, G * Tg)
    # the combine's order: each token's k rows by ascending expert
    inv = torch.argsort(order, dim=-1)      # sorted index of each (t, slot)
    by_expert = torch.argsort(experts, dim=-1)                   # (G, Tg, k)
    pick = torch.gather(inv.reshape(G, Tg, k), 2, by_expert)
    # each token's k buffer slots in that order (E·G·C where dropped)
    slot = torch.where(rank < C, _slots(se, rank, C), E * G * C)
    slot = torch.gather(slot, 1, pick.reshape(G, N)).reshape(G * Tg, k)
    x_rows = torch.cat([xg.reshape(G * Tg, d), xg.new_zeros((1, d))])
    buf = _DispatchRows.apply(x_rows, row.permute(1, 0, 2).reshape(-1), slot)
    return buf.reshape(E, G * C, d), se, rank, sw, pick


def _slots(se, rank, C: int):
    """The (E, G·C) buffer slot of each sorted assignment (G, N), its rank
    clamped into the capacity."""
    G = se.shape[0]
    g_ix = torch.arange(G, device=se.device)[:, None]
    return se * (G * C) + g_ix * C + torch.clamp(rank, max=C - 1)


class _DispatchRows(torch.autograd.Function):
    """The dispatch's gather ``x_rows[row]``. Its backward sums each
    token's kept slots in ascending-expert order from zeros by a gather
    (``slot``: each token's k slots, past the last slot where dropped),
    which is the order the CPU's ``index_add_`` (``index_select``'s
    backward) takes; on the card that backward adds with atomics, and a
    token's rows repeat up to k times, so two runs of a train step would
    differ."""

    @staticmethod
    def forward(ctx, x_rows, row, slot):
        ctx.save_for_backward(slot)
        ctx.rows = x_rows.shape[0]
        return x_rows.index_select(0, row)

    @staticmethod
    def backward(ctx, g):
        slot, = ctx.saved_tensors
        g = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        dx = g.new_zeros((ctx.rows, g.shape[1]))
        for j in range(slot.shape[1]):
            dx[:-1] = dx[:-1] + g.index_select(0, slot[:, j])
        return dx, None, None


def _combine(ye: torch.Tensor, se, rank, sw, pick) -> torch.Tensor:
    """The experts' rows (E, G·C, d) back to the tokens, from ``_fill``'s
    indices -> y (G, Tg, d) in ye's dtype: each token's k weighted rows
    added in ascending-expert order, from zeros."""
    E, GC, d = ye.shape
    G, Tg, k = pick.shape
    N, C = Tg * k, GC // G
    g_ix = torch.arange(G, device=ye.device)[:, None]
    # each sorted assignment's expert row, zero where it was dropped
    rows = ye.reshape(E * G * C, d).index_select(
        0, _slots(se, rank, C).reshape(-1))
    rows = torch.where((rank < C).reshape(-1, 1), rows, 0.0).reshape(G, N, d)
    contrib = rows * sw[..., None].to(ye.dtype)
    picked = contrib.reshape(G * N, d).index_select(
        0, (g_ix * N + pick.reshape(G, N)).reshape(-1))
    picked = picked.reshape(G, Tg, k, d)
    y = ye.new_zeros((G, Tg, d))
    for j in range(k):
        y = y + picked[:, :, j]
    return y


def _sharded_groups(p, xg, cfg: ModelConfig):
    """``_dispatch_groups`` of DTensors: the router's product as a DTensor
    op, then the top-k and ``_fill``, and ``_combine``, on each rank's own
    groups (the groups over the active rules' batch axes when they divide
    them, else every group on every rank), the experts' products between
    them as DTensor ops."""
    from torch.distributed.tensor.experimental import local_map
    mesh = xg.device_mesh
    g0 = ash.batch_placements(mesh, xg.shape[0], 0)
    g1 = ash.batch_placements(mesh, xg.shape[0], 1)
    logits = xg.to(torch.float32) @ ash.for_product(p["router"]["w"])

    def fill(x, lg):
        weights, experts, aux = _top_k(lg, cfg)
        return _fill(x, weights, experts, cfg) + (aux,)

    buf, se, rank, sw, pick, aux = local_map(
        fill, out_placements=(g1,) + (g0,) * 5, in_placements=(g0, g0),
        device_mesh=mesh, redistribute_inputs=True)(xg, logits)
    y = local_map(_combine, out_placements=(g0,),
                  in_placements=(g1, g0, g0, g0, g0), device_mesh=mesh,
                  redistribute_inputs=True)(
        _expert_ffn(p, buf, cfg), se, rank, sw, pick)
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
    xg = ash.constrain(x.reshape(groups, T // groups, d), "batch", None, None)
    y, aux = _dispatch_groups(p, xg, cfg)
    return (ash.constrain(y, "batch", None, None).reshape(T, d),
            torch.mean(aux))


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
