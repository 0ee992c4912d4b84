"""The windowed and offset attention gradient against the JAX reference on
the CPU, on the same numpy inputs.

The port's training attention (``attention.FlashAttention``) saves the
forward's window and query offset and hands both to
``flash_attention_bwd``, whose plain version (``mha_bwd_ref``) masks the
band of ``check_band``/``band_mask``. The reference differentiates its
``sdpa`` with ``jax.vjp``: at flashable shapes its custom VJP
(``_make_flash``, whose bwd masks the window), and for offsets its naive
core (its flash core drops ``q_offset``, ROADMAP Queue 3).

- ``sdpa``'s output and (dq, dk, dv) with windows 4, 16, 37 (unaligned)
  and 100, at 128 x 128 against the reference's flash custom VJP (two
  query chunks of 64 against one key chunk of 128), and with offsets
  (with and without a window) against its naive core: float32 within
  1e-5 relative Frobenius, bf16 within 8e-3
  (each gradient rounded to bf16 once, Drow from the bf16 output);
  ``flash_attention_bwd_plain`` on the forward's residuals gives the same
  bits as the autograd path, whose backward receives the forward's
  window and offset;
- the backward refuses what the forward refuses (a row with no key);
- the reference's fault the port does not copy: its flash core starts
  each row's running max at -inf, so a row whose window leaves the first
  key chunk empty comes out NaN (ROADMAP Queue 3);
- a windowed smoke SmolLM (window 5 against 32-token rows): ``loss_fn``'s
  value and every gradient leaf against ``jax.value_and_grad`` of the
  reference's (float32, 1e-4 a leaf, the bound of
  tests/test_torch_train.py) from the reference's ``init_params``
  through ``params_from_numpy``, remat on == off bitwise, and 3 steps of
  ``train`` against the reference ``train``'s losses (1e-4 relative).
"""
import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.launch import train as JT  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd)
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

F32_REL = 1e-5
BF16_REL = 8e-3
MODEL_REL = 1e-4
WINDOW = 5
DTYPES = {"float32": (torch.float32, jnp.float32, F32_REL),
          "bf16": (torch.bfloat16, jnp.bfloat16, BF16_REL)}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _inputs(seed, B, Sq, Skv, H, KH, D, Dv):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KH, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KH, Dv)).astype(np.float32),
            rng.normal(size=(B, Sq, H, Dv)).astype(np.float32))


def _port(q, k, v, dout, dtype, **kw):
    """(out, dq, dk, dv) of the port's ``sdpa`` as float32 numpy, and the
    window and offset its backward received."""
    seen = {}
    inner = A.flash_attention_bwd

    def spy(*args, **bkw):
        seen.update(bkw)
        return inner(*args, **bkw)

    qkv = [torch.from_numpy(a).to(dtype).requires_grad_(True)
           for a in (q, k, v)]
    A.flash_attention_bwd = spy
    try:
        out = A.sdpa(*qkv, causal=True, **kw)
        grads = torch.autograd.grad(out, qkv,
                                    torch.from_numpy(dout).to(dtype))
    finally:
        A.flash_attention_bwd = inner
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    return [t.detach().float().numpy() for t in (out,) + grads], seen


def _ref(q, k, v, dout, dtype, **kw):
    """(out, dq, dk, dv) of ``jax.vjp`` of the reference's ``sdpa``."""
    out, vjp = jax.vjp(lambda a, b, c: JA.sdpa(a, b, c, causal=True, **kw),
                       *(jnp.asarray(x, dtype) for x in (q, k, v)))
    grads = vjp(jnp.asarray(dout, dtype))
    return [np.asarray(t.astype(jnp.float32)) for t in (out,) + grads]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("window", [4, 16, 37, 100])
@pytest.mark.parametrize("H,KH,D,Dv", [(6, 2, 64, 64), (4, 4, 48, 32)])
def test_window_grads_match_reference_flash_vjp(window, H, KH, D, Dv, dt):
    """128 queries in two chunks of 64 against one key chunk of 128: the
    reference's flash custom VJP with the window, its bwd masking the band
    (one key chunk: see the next test for smaller ones)."""
    tdt, jdt, tol = DTYPES[dt]
    q, k, v, dout = _inputs(window + H + D, 2, 128, 128, H, KH, D, Dv)
    got, seen = _port(q, k, v, dout, tdt, window=window)
    assert seen == {"causal": True, "q_offset": 0, "window": window}
    want = _ref(q, k, v, dout, jdt, window=window, q_chunk=64, kv_chunk=128)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= tol, (name, _rel(g, w))
    # the window binds: the gradient differs from the causal one
    causal, _ = _port(q, k, v, dout, tdt)
    assert _rel(got[1], causal[1]) > 10 * tol


def test_reference_flash_core_nans_past_its_first_key_chunk():
    """The reference's fault the port does not copy: ``_flash_fwd_core``
    starts each row's running max at -inf, so a row whose window leaves
    the first key chunk without a key it sees gets exp(-inf - -inf), NaN
    (rows 67 on at window 4 and 64-key chunks), in the output and every
    gradient. The port's rows are finite and equal the naive core's."""
    q, k, v, dout = _inputs(2, 1, 128, 128, 4, 2, 32, 32)
    want = _ref(q, k, v, dout, jnp.float32, window=4, q_chunk=64,
                kv_chunk=64)
    assert np.isnan(want[0][:, 67:]).all()
    assert np.isfinite(want[0][:, :67]).all()
    assert np.isnan(want[1]).any() and np.isnan(want[2]).any()
    naive = _ref(q, k, v, dout, jnp.float32, window=4, cost_mode=True)
    got, _ = _port(q, k, v, dout, torch.float32, window=4)
    for g, w in zip(got, naive):
        assert np.isfinite(g).all() and _rel(g, w) <= F32_REL


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("Sq,Skv,q_offset,window", [
    (16, 64, 48, 0), (16, 64, 48, 16), (24, 100, 60, 37), (8, 8, 2, 0),
    (32, 96, 64, 100), (1, 40, 39, 3)])
def test_offset_grads_match_reference_naive_core(Sq, Skv, q_offset, window,
                                                 dt):
    """Query rows at an offset (a shard of a longer sequence, a prompt
    after a cache) against ``jax.vjp`` of the reference's naive core,
    which honours ``q_offset``; keys that no row sees get zero dk and
    dv on both sides."""
    tdt, jdt, tol = DTYPES[dt]
    q, k, v, dout = _inputs(Sq + Skv + window, 2, Sq, Skv, 6, 2, 32, 32)
    kw = dict(q_offset=q_offset, window=window)
    got, seen = _port(q, k, v, dout, tdt, **kw)
    assert seen == dict(causal=True, **kw)
    want = _ref(q, k, v, dout, jdt, cost_mode=True, **kw)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= tol, (name, _rel(g, w))
    if window and q_offset - window >= 0:
        unseen = q_offset - window + 1
        for g, w in zip(got[2:], want[2:]):
            assert not g[:, :unseen].any() and not w[:, :unseen].any()


@pytest.mark.parametrize("q_offset,window", [(0, 7), (20, 0), (20, 9)])
def test_plain_backward_is_the_autograd_path(q_offset, window):
    """``flash_attention_bwd`` on the forward's residuals (the plain
    version on the CPU) gives the autograd path's bits, and the plain
    formula equals autograd of the plain forward at the band."""
    q, k, v, dout = (torch.from_numpy(a) for a in
                     _inputs(q_offset + window, 2, 24, 48, 6, 3, 64, 64))
    kw = dict(causal=True, q_offset=q_offset, window=window)
    out, lse = flash_attention_fwd(q, k, v, return_lse=True, **kw)
    got = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(A.FlashAttention.apply(*qkv, True, window,
                                                      q_offset), qkv, dout)
    for g, w in zip(got, auto):
        assert torch.equal(g, w)
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_plain)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = torch.autograd.grad(flash_attention_plain(*qkv, **kw), qkv, dout)
    for g, w in zip(got, plain):
        assert _rel(g.numpy(), w.numpy()) <= F32_REL


def test_backward_refuses_a_row_without_keys():
    q, k, v, dout = (torch.from_numpy(a) for a in
                     _inputs(3, 1, 4, 16, 2, 2, 32, 32))
    out = torch.zeros_like(dout)
    lse = torch.zeros(q.shape[:3])
    for fn in (flash_attention_bwd, flash_attention_bwd_plain):
        with pytest.raises(ValueError, match="sees none"):
            fn(q, k, v, out, lse, dout, causal=True, q_offset=15, window=3)
        with pytest.raises(ValueError, match=">= 0"):
            fn(q, k, v, out, lse, dout, causal=True, window=-1)


def _configs():
    cfg = get_smoke("smollm_135m").replace(dtype="float32",
                                           attention="windowed",
                                           window_size=WINDOW)
    jcfg = jget_smoke("smollm_135m").replace(dtype="float32",
                                             attention="windowed",
                                             window_size=WINDOW)
    return cfg, jcfg


def test_windowed_smoke_loss_fn_grads_match_reference():
    cfg, jcfg = _configs()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = M.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), cfg,
        device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens)}
    total, ce = M.loss_fn(params, batch, cfg)
    grads, ce_g = S.loss_grads(params, batch, cfg)
    (jtotal, jce), jgrads = jax.jit(jax.value_and_grad(
        lambda pp: JM.loss_fn(pp, {"tokens": jnp.asarray(tokens)}, jcfg),
        has_aux=True))(jp)
    assert abs(float(total) - float(jtotal)) <= MODEL_REL * abs(float(jtotal))
    assert abs(float(ce) - float(jce)) <= MODEL_REL * abs(float(jce))
    assert float(ce_g) == float(ce)
    leaves, jleaves = tree_leaves(grads), jax.tree.leaves(jgrads)
    assert len(leaves) == len(jleaves)
    for g, w in zip(leaves, jleaves):
        assert _rel(g.detach().numpy(), w) <= MODEL_REL, g.shape
    # remat on and off give the same bits; the window changes the loss
    grads_off, ce_off = S.loss_grads(params, batch, cfg.replace(remat="none"))
    assert torch.equal(ce_off, ce_g)
    for a, b in zip(leaves, tree_leaves(grads_off)):
        assert torch.equal(a, b)
    _, ce_causal = M.loss_fn(params, batch, cfg.replace(attention="gqa"))
    assert abs(float(ce_causal) - float(ce)) > 1e-4


def test_windowed_train_losses_match_reference_train():
    cfg, jcfg = _configs()
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    _, _, losses = T.train(cfg, TrainConfig(**kw), batch=4, seq=64, steps=3,
                           log_every=0, device="cpu")
    _, _, jlosses = JT.train(jcfg, JTrainConfig(**kw), batch=4, seq=64,
                             steps=3, log_every=0)
    gap = np.abs(np.asarray(losses) - np.asarray(jlosses))
    assert np.all(gap <= MODEL_REL * np.abs(jlosses)), (losses, jlosses)
