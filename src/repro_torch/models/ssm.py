"""State-space / recurrent blocks: Mamba2 (SSD) and xLSTM (mLSTM + sLSTM).

Port of ``repro/models/ssm.py``. Both Mamba2's SSD and the mLSTM matrix
memory are instances of the same *gated linear recurrence*::

    C_t = a_t · C_{t-1} + b_t · k_t v_tᵀ          (state  (dk, dv))
    y_t = q_t · C_t      [ / max(|q_t · n_t|, floor) for mLSTM ]

so one chunked (intra-chunk parallel, inter-chunk sequential) routine,
``chunked_linear_recurrence``, in log-decay space serves both. Decode is
the O(1)-state single-step update.

The reference computes these in jnp, with no Pallas kernel, so the port
computes them in plain PyTorch, in float32 where the reference casts.
Where the reference scans (``lax.scan`` over chunks and over the sLSTM's
tokens) the port loops in Python. The mLSTM stabilizer, a
``lax.associative_scan`` of max-plus pairs in the reference, is its
closed form here: ``m_t = F_t + max(m_0, cummax_{s<=t}(i_s - F_s))`` with
``F = cumsum(f)``, one ``torch.cumsum`` and one ``torch.cummax``; it
equals the reference's to float32 rounding, not bit for bit (XLA sums a
tree). ``softplus`` and ``log_sigmoid`` follow jax.nn's formulas.
Within a chunk the decay between positions s < t, the sum of log a over
(s, t], is summed directly (``_segment_sums``), where the reference takes
it as a difference of two inclusive cumsums. The two are equal in exact
arithmetic, but a 256-step chunk's cumsum reaches ~-200 at Zamba2's
initial decays, where a float32 ulp is 1.5e-5, and the backward of the
difference sums opposite terms of that size: Zamba2's full-size float32
gradients moved by 1.03e-4 (relative Frobenius, at ``dt_bias``) when its
attention rounded apart by ~1e-6, and by 7.65e-5 with segment sums, which
cost one more pass over the chunk's (t, s) tensor
(``scripts/torch_ssm_scan_forms.py`` runs both forms).
Projections go through ``layers.dense``, so in tier-1 they run blinded
(Mamba2's ``in_proj``/``out_proj``, the mLSTM's ``w_up``, gates and
``w_down``, the sLSTM's ``w_gates``, ``w_up`` and ``w_down``); the
convolutions, the per-head q/k/v einsums, the sLSTM's recurrent product
and the recurrences run in the enclave.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.parallel import act_sharding as ash
from repro_torch.parallel.hlo_analysis import analyzing, trips

f32 = torch.float32


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.log_sigmoid, ``-softplus(-x)``, in torch's one kernel:
    ``min(x, 0) - log1p(exp(-|x|))``, the same terms (negation is exact).
    DTensor has no sharding strategy for that kernel's forward or backward
    (``aten.log_sigmoid_forward``/``_backward``), so on a DTensor it runs
    on each rank's shard through ``act_sharding.local_pointwise``, forward
    and backward: the bits a plain tensor gets. (An elementwise
    composition of the same terms rounds apart: torch's ``exp`` is not
    the kernel's, up to 2 ulps forward and 4 in the gradient in
    float32.)"""
    if ash.is_dtensor(x):
        return ash.local_pointwise(F.logsigmoid, x)
    return F.logsigmoid(x)


# ----------------------------------------------------------------------------
# Generic chunked gated linear recurrence
# ----------------------------------------------------------------------------

def _segment_sums(la: torch.Tensor) -> torch.Tensor:
    """la: (..., L) -> (..., t, s): the sum of la over (s, t] for s <= t (0
    on the diagonal), -inf above it. Each sum starts at its own segment, so
    it is as exact as its own size allows."""
    Lc = la.shape[-1]
    ones = torch.ones((Lc, Lc), dtype=torch.bool, device=la.device)
    x = la[..., :, None].expand(*la.shape, Lc).masked_fill(
        ~torch.tril(ones, -1), 0.0)                  # [r, s] = la_r, r > s
    seg = torch.cumsum(x, dim=-2)                    # sum over r in (s, t]
    return seg.masked_fill(~torch.tril(ones), float("-inf"))


def chunked_linear_recurrence(q, k, v, log_a, b, *, chunk: int,
                              init_state=None, normalize=False,
                              den_floor=None):
    """q,k: (B,S,H,dk); v: (B,S,H,dv); log_a,b: (B,S,H).

    Returns (y (B,S,H,dv) float32, (final_state (B,H,dk,dv),
    final_norm (B,H,dk))). DTensors from a zero state run on each rank's
    own rows and heads (``_sharded_recurrence``).
    """
    if init_state is None and ash.is_dtensor(q):
        return _sharded_recurrence(q, k, v, log_a, b, chunk, normalize,
                                   den_floor)
    return _recurrence(q, k, v, log_a, b, chunk, init_state, normalize,
                       den_floor)


def _sharded_recurrence(q, k, v, log_a, b, chunk, normalize, den_floor):
    """``_recurrence`` of DTensors through ``local_map``: the batch over the
    active rules' batch axes when they divide it, the heads over "model"
    when it divides them (replicated there otherwise). Each chunk's steps
    are local ops, not DTensor dispatches: flattening the (batch, head)
    dims of a head-sharded tensor into one matmul batch dim leaves a
    strided shard whose matmul DTensor cannot place under fake tensors."""
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh

    def place(dim):
        return _rows_and_heads(mesh, q.shape[0], q.shape[2], dim)

    args = (q, k, v, log_a, b) + ((den_floor,) if den_floor is not None
                                  else ())

    def local(q, k, v, log_a, b, *floor):
        y, (C, n) = _recurrence(q, k, v, log_a, b, chunk, None, normalize,
                                floor[0] if floor else None)
        return y, C, n

    y, C, n = local_map(local, out_placements=(place(2), place(1),
                                               place(1)),
                        in_placements=(place(2),) * len(args),
                        device_mesh=mesh, redistribute_inputs=True)(*args)
    return y, (C, n)


def _rows_and_heads(mesh, rows: int, heads: int, dim: int):
    """Placements with the batch (dim 0, ``rows``) over the active rules'
    batch axes when they divide it and the heads (``dim``) over "model"
    when it divides them; replicated elsewhere."""
    from torch.distributed.tensor import Shard
    names = mesh.mesh_dim_names
    place = ash.batch_placements(mesh, rows, 0)
    split = ("model" in names and not place[names.index("model")].is_shard()
             and heads % mesh.shape[names.index("model")] == 0)
    return tuple(Shard(dim) if a == "model" and split else pl
                 for a, pl in zip(names, place))


def _recurrence(q, k, v, log_a, b, chunk, init_state, normalize, den_floor):
    """``chunked_linear_recurrence`` on tensors."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    Lc = min(chunk, S)
    assert S % Lc == 0, (S, Lc)
    nc = S // Lc

    qc = q.to(f32).reshape(B, nc, Lc, H, dk)
    kc = k.to(f32).reshape(B, nc, Lc, H, dk)
    vc = v.to(f32).reshape(B, nc, Lc, H, dv)
    lac = log_a.to(f32).reshape(B, nc, Lc, H)
    bc = b.to(f32).reshape(B, nc, Lc, H)
    La = torch.cumsum(lac, dim=2)                      # inclusive cumsum

    if init_state is None:
        C = torch.zeros((B, H, dk, dv), dtype=f32, device=q.device)
        n = torch.zeros((B, H, dk), dtype=f32, device=q.device)
    else:
        C, n = init_state

    ys, dens = [], []
    for c in range(nc):
        qb, kb, vb, Lab, bb = qc[:, c], kc[:, c], vc[:, c], La[:, c], bc[:, c]
        # intra-chunk: S[t,s] = exp(La_t - La_s) * b_s * (q_t . k_s)
        qk = torch.einsum("bthd,bshd->bhts", qb, kb)
        # La_t - La_s as a segment sum, -inf for t < s (masked before exp)
        seg = _segment_sums(lac[:, c].permute(0, 2, 1))          # (B,H,t,s)
        decay = torch.exp(seg)
        scores = qk * decay * bb.permute(0, 2, 1)[:, :, None, :]
        y_intra = torch.einsum("bhts,bshd->bthd", scores, vb)
        den_intra = torch.sum(scores, dim=-1)                    # (B,H,t)
        # inter-chunk: the state's contribution
        Aq = torch.exp(Lab)                                      # (B,Lc,H)
        y_inter = torch.einsum("bthd,bhde->bthe", qb, C) * Aq[..., None]
        den_inter = torch.einsum("bthd,bhd->bth", qb, n) * Aq    # (B,Lc,H)
        # carry update
        # exp(La_last - La_s) b_s
        tail = torch.exp(seg[:, :, -1]).permute(0, 2, 1) * bb   # (B,Lc,H)
        kw = kb * tail[..., None]
        chunk_decay = torch.exp(Lab[:, -1])                      # (B,H)
        C = (C * chunk_decay[..., None, None]
             + torch.einsum("bshd,bshe->bhde", kw, vb))
        n = (n * torch.exp(Lab[:, -1]).reshape(B, H, 1)
             + torch.sum(kw, dim=1))
        ys.append(y_intra + y_inter)
        dens.append(den_intra.permute(0, 2, 1) + den_inter)
    y = torch.stack(ys, dim=1).reshape(B, S, H, dv)
    den = torch.stack(dens, dim=1).reshape(B, S, H)
    if normalize:
        floor = den_floor if den_floor is not None else 1e-6
        y = y / torch.maximum(torch.abs(den),
                              torch.as_tensor(floor, dtype=f32,
                                              device=y.device))[..., None]
    return y, (C, n)


def linear_recurrence_step(q, k, v, a, b, state, *, normalize=False,
                           den_floor=None):
    """Single decode step. q,k: (B,H,dk); v: (B,H,dv); a,b: (B,H); the
    state (C (B,H,dk,dv), n (B,H,dk)). Mixed bf16/float32 operands are
    promoted to float32, as jnp promotes them. DTensors run on each
    rank's own rows and heads, as ``_sharded_recurrence``."""
    if ash.is_dtensor(q):
        return _sharded_step(q, k, v, a, b, state, normalize, den_floor)
    return _step(q, k, v, a, b, state, normalize, den_floor)


def _sharded_step(q, k, v, a, b, state, normalize, den_floor):
    """``_step`` of DTensors through ``local_map``: every operand has its
    heads at dim 1 (module docstring of ``_sharded_recurrence``)."""
    from torch.distributed.tensor.experimental import local_map
    place = _rows_and_heads(q.device_mesh, q.shape[0], q.shape[1], 1)
    args = (q, k, v, a, b) + tuple(state) + (
        (den_floor,) if den_floor is not None else ())

    def local(q, k, v, a, b, C, n, *floor):
        y, (C, n) = _step(q, k, v, a, b, (C, n), normalize,
                          floor[0] if floor else None)
        return y, C, n

    y, C, n = local_map(local, out_placements=(place,) * 3,
                        in_placements=(place,) * len(args),
                        device_mesh=q.device_mesh,
                        redistribute_inputs=True)(*args)
    return y, (C, n)


def _step(q, k, v, a, b, state, normalize, den_floor):
    """``linear_recurrence_step`` on tensors."""
    C, n = state
    q, k, v = q.to(f32), k.to(f32), v.to(f32)
    C = C * a[..., None, None] + b[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", k, v)
    n = n * a[..., None] + b[..., None] * k
    y = torch.einsum("bhd,bhde->bhe", q, C)
    if normalize:
        den = torch.einsum("bhd,bhd->bh", q, n)
        floor = den_floor if den_floor is not None else 1e-6
        y = y / torch.maximum(torch.abs(den),
                              torch.as_tensor(floor, dtype=f32,
                                              device=y.device))[..., None]
    return y, (C, n)


# ----------------------------------------------------------------------------
# Causal depthwise conv1d (mamba2 / mLSTM front conv)
# ----------------------------------------------------------------------------

def causal_conv1d(w, x, *, cache=None):
    """w: (K, C) depthwise; x: (B,S,C). cache: (B,K-1,C) trailing context.
    -> (y (B,S,C) in x's dtype, the new cache (B,K-1,C) in x's dtype)."""
    K = w.shape[0]
    if cache is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    wx = w.to(x.dtype)
    y = xp[:, 0:S, :] * wx[0][None, None, :]
    for i in range(1, K):
        y = y + xp[:, i:i + S, :] * wx[i][None, None, :]
    new_cache = xp[:, -(K - 1):, :] if K > 1 else pad
    return y, new_cache


# ----------------------------------------------------------------------------
# Mamba2 block
# ----------------------------------------------------------------------------

class Mamba2State(NamedTuple):
    ssm: Tuple[torch.Tensor, torch.Tensor]   # C (B,H,N,P), n (B,H,N)
    conv: torch.Tensor                       # (B, K-1, conv_channels)


def mamba2_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = s.num_ssm_heads
    P = d_inner // H
    N = s.state_dim
    conv_ch = d_inner + 2 * N          # conv over [x, B, C], one group
    return d_inner, H, P, N, conv_ch


def mamba2_defs(cfg: ModelConfig) -> Dict[str, object]:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, H, P, N, conv_ch = mamba2_dims(cfg)
    return {
        "in_proj": L.dense_def(d, 2 * d_inner + 2 * N + H, ("embed", "ffn")),
        "conv_w": L.ParamDef((s.conv_dim, conv_ch), "scaled", (None, "ffn")),
        "A_log": L.ParamDef((H,), "zeros", (None,), f32),
        "D": L.ParamDef((H,), "ones", (None,), f32),
        "dt_bias": L.ParamDef((H,), "zeros", (None,), f32),
        "out_norm": L.norm_def(d_inner, "rmsnorm"),
        "out_proj": L.dense_def(d_inner, d, ("ffn", "embed")),
    }


def _mamba2_inner(p, x, cfg: ModelConfig, conv_cache=None):
    d_inner, H, P, N, conv_ch = mamba2_dims(cfg)
    B, S, _ = x.shape
    zxbcdt = L.dense(p["in_proj"], x)
    z, xbc, dt = torch.split(zxbcdt, [d_inner, conv_ch, H], dim=-1)
    xbc, new_conv = causal_conv1d(p["conv_w"], F.silu(xbc), cache=conv_cache)
    xs, Bmat, Cmat = torch.split(xbc, [d_inner, N, N], dim=-1)
    dt = softplus(dt.to(f32) + p["dt_bias"][None, None, :])    # (B,S,H)
    A = -torch.exp(p["A_log"].to(f32))                          # (H,) < 0
    log_a = dt * A[None, None, :]
    xh = xs.reshape(B, S, H, P)
    kq_k = Bmat[:, :, None, :].expand(B, S, H, N)
    kq_q = Cmat[:, :, None, :].expand(B, S, H, N)
    return z, xh, kq_q, kq_k, log_a, dt, new_conv


def mamba2_forward(p, x, cfg: ModelConfig):
    z, xh, q, k, log_a, dt, _ = _mamba2_inner(p, x, cfg)
    y, _ = chunked_linear_recurrence(
        q, k, xh, log_a, dt, chunk=cfg.ssm.chunk_size, normalize=False)
    y = y + xh.to(f32) * p["D"][None, None, :, None]
    B, S = x.shape[:2]
    y = y.reshape(B, S, -1).to(x.dtype)
    y = L.apply_norm(p["out_norm"], y, "rmsnorm") * F.silu(z)
    return L.dense(p["out_proj"], y)


def mamba2_init_state(cfg: ModelConfig, batch: int, dtype=f32,
                      device="cuda") -> Mamba2State:
    d_inner, H, P, N, conv_ch = mamba2_dims(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return Mamba2State(ssm=(zeros(batch, H, N, P), zeros(batch, H, N)),
                       conv=zeros(batch, cfg.ssm.conv_dim - 1, conv_ch))


def mamba2_decode(p, x, state: Mamba2State, cfg: ModelConfig):
    """x: (B,1,d) -> (y (B,1,d), new state). O(1) per step."""
    z, xh, q, k, log_a, dt, new_conv = _mamba2_inner(
        p, x, cfg, conv_cache=state.conv)
    a = torch.exp(log_a[:, 0])                                  # (B,H)
    y, ssm = linear_recurrence_step(
        q[:, 0], k[:, 0], xh[:, 0].to(f32), a, dt[:, 0], state.ssm,
        normalize=False)
    y = y + xh[:, 0].to(f32) * p["D"][None, :, None]
    B = x.shape[0]
    y = y.reshape(B, 1, -1).to(x.dtype)
    y = L.apply_norm(p["out_norm"], y, "rmsnorm") * F.silu(z)
    return L.dense(p["out_proj"], y), Mamba2State(ssm=ssm, conv=new_conv)


# ----------------------------------------------------------------------------
# xLSTM: mLSTM block (matrix memory) and sLSTM block (scalar memory)
# ----------------------------------------------------------------------------

class MLSTMState(NamedTuple):
    C: torch.Tensor      # (B,H,dk,dv)
    n: torch.Tensor      # (B,H,dk)
    m: torch.Tensor      # (B,H)
    conv: torch.Tensor   # (B,K-1,di)


def mlstm_dims(cfg: ModelConfig):
    di = cfg.ssm.expand * cfg.d_model
    H = cfg.ssm.num_ssm_heads
    dh = di // H
    return di, H, dh


def mlstm_defs(cfg: ModelConfig) -> Dict[str, object]:
    d = cfg.d_model
    di, H, dh = mlstm_dims(cfg)
    return {
        "w_up": L.dense_def(d, 2 * di, ("embed", "ffn")),
        "conv_w": L.ParamDef((4, di), "scaled", (None, "ffn")),
        # block-diagonal per-head q/k/v (official xLSTM structure)
        "wq": L.ParamDef((H, dh, dh), "scaled", (None, None, None)),
        "wk": L.ParamDef((H, dh, dh), "scaled", (None, None, None)),
        "wv": L.ParamDef((H, dh, dh), "scaled", (None, None, None)),
        "w_igate": L.dense_def(di, H, ("ffn", None), bias=True),
        "w_fgate": L.dense_def(di, H, ("ffn", None), bias=True),
        "out_norm": L.norm_def(di, "rmsnorm"),
        "w_down": L.dense_def(di, d, ("ffn", "embed")),
    }


def _blockdiag(w, x, H, dh):
    """x: (..., H*dh) -> per-head (..., H, dh) @ w (H, dh, dh)."""
    xh = ash.unflatten_last(x, (H, dh))
    return torch.einsum("...hd,hde->...he", xh, w.to(x.dtype))


def _stabilizer_scan(f_log, i_log, m0):
    """m_t = max(m_{t-1} + f_log_t, i_log_t), m_{-1} = m0; f_log, i_log
    (B,S,H), m0 (B,H) -> (B,S,H). Unrolled, m_t = F_t + max(m0,
    max_{s<=t}(i_s - F_s)) with F the inclusive cumsum of f_log."""
    Fc = torch.cumsum(f_log, dim=1)
    best = torch.cummax(i_log - Fc, dim=1).values
    return Fc + torch.maximum(m0[:, None], best)


def _mlstm_gates(p, xi, m0):
    """xi: (B,S,di). Returns (log_a, b, m, den_floor)."""
    # on a mesh the gates are pinned to the batch: their gradients then
    # come back in that layout, where DTensor leaves them sharded over the
    # sequence, which the gate weights' gradient (a matmul over the
    # flattened tokens) cannot take under fake tensors
    f_log = log_sigmoid(ash.constrain(L.dense(p["w_fgate"], xi),
                                      "batch", "seq", None).to(f32))
    i_log = ash.constrain(L.dense(p["w_igate"], xi), "batch", "seq",
                          None).to(f32)                          # (B,S,H)
    m = _stabilizer_scan(f_log, i_log, m0)
    m_prev = torch.cat([m0[:, None], m[:, :-1]], dim=1)
    log_a = f_log + m_prev - m
    b = torch.exp(i_log - m)
    den_floor = torch.exp(-m)
    return log_a, b, m, den_floor


def mlstm_forward(p, x, cfg: ModelConfig):
    di, H, dh = mlstm_dims(cfg)
    B, S, _ = x.shape
    # on a mesh the projection is gathered whole before it splits (the
    # gradients of a split sharded dim come back in a strided layout that
    # the projection's weight gradient cannot take under fake tensors)
    up = ash.constrain(L.dense(p["w_up"], x), "batch", "seq", None)
    xi, z = torch.chunk(up, 2, dim=-1)
    xc, _ = causal_conv1d(p["conv_w"], xi)
    xc = F.silu(xc)
    q = _blockdiag(p["wq"], xc, H, dh) / math.sqrt(dh)
    k = _blockdiag(p["wk"], xc, H, dh)
    v = _blockdiag(p["wv"], xi, H, dh)
    m0 = torch.zeros((B, H), dtype=f32, device=x.device)
    log_a, b, m, den_floor = _mlstm_gates(p, xi, m0)
    y, _ = chunked_linear_recurrence(
        q, k, v, log_a, b, chunk=cfg.ssm.chunk_size,
        normalize=True, den_floor=den_floor)
    y = y.reshape(B, S, di).to(x.dtype)
    y = L.apply_norm(p["out_norm"], y, "rmsnorm") * F.silu(z)
    return L.dense(p["w_down"], y)


def mlstm_init_state(cfg: ModelConfig, batch: int,
                     device="cuda") -> MLSTMState:
    di, H, dh = mlstm_dims(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=device)
    return MLSTMState(C=zeros(batch, H, dh, dh), n=zeros(batch, H, dh),
                      m=zeros(batch, H), conv=zeros(batch, 3, di))


def mlstm_decode(p, x, state: MLSTMState, cfg: ModelConfig):
    di, H, dh = mlstm_dims(cfg)
    B = x.shape[0]
    up = L.dense(p["w_up"], x)
    xi, z = torch.chunk(up, 2, dim=-1)
    xc, new_conv = causal_conv1d(p["conv_w"], xi, cache=state.conv)
    xc = F.silu(xc)
    q = _blockdiag(p["wq"], xc, H, dh)[:, 0] / math.sqrt(dh)
    k = _blockdiag(p["wk"], xc, H, dh)[:, 0]
    v = _blockdiag(p["wv"], xi, H, dh)[:, 0]
    f_log = log_sigmoid(L.dense(p["w_fgate"], xi)[:, 0].to(f32))   # (B,H)
    i_log = L.dense(p["w_igate"], xi)[:, 0].to(f32)
    m = torch.maximum(state.m + f_log, i_log)
    a = torch.exp(f_log + state.m - m)
    b = torch.exp(i_log - m)
    y, (C, n) = linear_recurrence_step(
        q, k, v, a, b, (state.C, state.n), normalize=True,
        den_floor=torch.exp(-m))
    y = y.reshape(B, 1, di).to(x.dtype)
    y = L.apply_norm(p["out_norm"], y, "rmsnorm") * F.silu(z)
    return L.dense(p["w_down"], y), MLSTMState(C=C, n=n, m=m, conv=new_conv)


class SLSTMState(NamedTuple):
    c: torch.Tensor      # (B,H,dh)
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor      # (B,H)


def slstm_dims(cfg: ModelConfig):
    d = cfg.d_model
    H = cfg.ssm.num_ssm_heads
    dh = d // H
    d_up = int(d * cfg.ssm.slstm_proj_factor)
    d_up = (d_up // 8) * 8 or 8
    return d, H, dh, d_up


def slstm_defs(cfg: ModelConfig) -> Dict[str, object]:
    d, H, dh, d_up = slstm_dims(cfg)
    return {
        "w_gates": L.dense_def(d, 4 * d, ("embed", "ffn"), bias=True),
        "r_gates": L.ParamDef((4, H, dh, dh), "scaled",
                              (None, None, None, None)),
        "out_norm": L.norm_def(d, "rmsnorm"),
        "w_up": L.dense_def(d, d_up, ("embed", "ffn")),
        "w_down": L.dense_def(d_up, d, ("ffn", "embed")),
    }


def _slstm_step(r, gates_x, state: SLSTMState) -> SLSTMState:
    """r: (4, H, dh, dh) float32 recurrent weights; gates_x: (B, 4, H, dh)
    float32 precomputed input contributions. The recurrent product is
    the reference's ``einsum("bhd,ghde->bghe")`` as one batched matmul
    over (gate, head) with the small operand, h, broadcast (an einsum's
    host cost, paid once a token, dominated the loop)."""
    rec = torch.matmul(state.h.transpose(0, 1)[None], r).permute(2, 0, 1, 3)
    g = gates_x + rec                                           # (B,4,H,dh)
    zt = torch.tanh(g[:, 0])
    it = torch.mean(g[:, 1], dim=-1)                            # scalar/head
    ft = torch.mean(g[:, 2], dim=-1)
    ot = torch.sigmoid(g[:, 3])
    f_log = log_sigmoid(ft)
    m = torch.maximum(f_log + state.m, it)
    ip = torch.exp(it - m)
    fp = torch.exp(f_log + state.m - m)
    c = fp[..., None] * state.c + ip[..., None] * zt
    n = fp[..., None] * state.n + ip[..., None]
    h = ot * c / torch.clamp_min(n, 1e-6)
    return SLSTMState(c=c, n=n, h=h, m=m)


def _slstm_scan(r, gates, state: SLSTMState):
    """The token loop: (h of every token (B,S,H,dh), the last state)."""
    hs = []
    for t in range(gates.shape[1]):
        state = _slstm_step(r, gates[:, t], state)
        hs.append(state.h)
    return torch.stack(hs, dim=1), state


class _OneTrip(torch.autograd.Function):
    """``_slstm_scan`` under the dry-run's step analysis (fake tensors,
    nothing computed): one token's step traced inside ``trips(S)``, its
    forward and its backward each counted for the S steps, as the
    reference's analysis multiplies its scan's loop body; the outputs
    have the loop's shapes (h of every token, the last state)."""

    @staticmethod
    def forward(ctx, r, gates, *state):
        S = gates.shape[1]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True)
                   for t in (r, gates[:, 0]) + state]
            with trips(S):
                out = _slstm_step(ins[0], ins[1], SLSTMState(*ins[2:]))
        ctx.trip = (S, ins, out)
        h = torch.stack([out.h.detach()] * S, dim=1)
        return (h,) + tuple(t.detach() for t in out)

    @staticmethod
    def backward(ctx, dh, dc, dn, dh_last, dm):
        S, ins, out = ctx.trip
        with trips(S):
            g = torch.autograd.grad(tuple(out), ins,
                                    (dc, dn, dh[:, -1] + dh_last, dm),
                                    allow_unused=True)
        dgates = g[1].new_zeros((g[1].shape[0], S) + tuple(g[1].shape[1:]))
        return (g[0], dgates) + tuple(g[2:])


def _sharded_slstm_scan(r, gates, cfg: ModelConfig):
    """``_slstm_scan`` from a zero state of DTensor gates: the loop on each
    rank's own rows (the batch over the active rules' batch axes when
    they divide it) through ``local_map``, so a token's step is a handful
    of local ops, not DTensor dispatches; the replicated recurrent
    weights' gradient comes back a partial sum over the ranks that split
    the rows."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = gates.device_mesh
    rows = ash.batch_placements(mesh, gates.shape[0], 0)
    rep = (Replicate(),) * mesh.ndim
    r_grad = tuple(Partial() if pl.is_shard() else Replicate()
                   for pl in rows)

    def scan(r, gates):
        state = slstm_init_state(cfg, gates.shape[0], device=gates.device)
        if analyzing() and gates.shape[1] > 1:
            return _OneTrip.apply(r, gates, *state)
        h, state = _slstm_scan(r, gates, state)
        return (h,) + tuple(state)

    h, *state = local_map(scan, out_placements=(rows,) * 5,
                          in_placements=(rep, rows),
                          in_grad_placements=(r_grad, rows),
                          device_mesh=mesh,
                          redistribute_inputs=True)(r, gates)
    return h, SLSTMState(*state)


def slstm_forward(p, x, cfg: ModelConfig,
                  state: Optional[SLSTMState] = None):
    """x: (B,S,d) -> (y (B,S,d), the state after the last token); one
    recurrent step a token, in order."""
    d, H, dh, d_up = slstm_dims(cfg)
    B, S, _ = x.shape
    gates = ash.unflatten_last(L.dense(p["w_gates"], x),
                               (4, H, dh)).to(f32)
    r = p["r_gates"].to(f32)
    if state is None and ash.is_dtensor(gates):
        h, state = _sharded_slstm_scan(r, gates, cfg)
    else:
        if state is None:
            state = slstm_init_state(cfg, B, device=x.device)
        h, state = _slstm_scan(r, gates, state)
    # on a mesh laid out by batch alone before the heads merge (a view
    # cannot merge split head shards)
    y = ash.constrain(h, "batch", "seq", None, None).reshape(B, S, d)
    y = L.apply_norm(p["out_norm"], y.to(x.dtype), "rmsnorm")
    act = L.activation("gelu")
    up = ash.pin_grad(L.dense(p["w_up"], y))
    y = L.dense(p["w_down"], act(up))
    return y, state


def slstm_init_state(cfg: ModelConfig, batch: int,
                     device="cuda") -> SLSTMState:
    d, H, dh, _ = slstm_dims(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=device)
    return SLSTMState(c=zeros(batch, H, dh), n=zeros(batch, H, dh),
                      h=zeros(batch, H, dh), m=zeros(batch, H))
