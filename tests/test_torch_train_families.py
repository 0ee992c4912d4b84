"""The port's training path against the JAX reference on the CPU for the
families ``test_torch_train.py`` does not cover: the hybrid Zamba2-1.2B
(Mamba2 blocks and a shared attention block), the recurrent xLSTM-1.3B
(mLSTM and sLSTM blocks) and the cross-attention Whisper-small and
Llama-3.2-Vision-11B, at their smoke configs in float32, with the
reference's ``init_params`` carried across by ``params_from_numpy``.

- ``loss_fn``'s total and ce, and every gradient leaf of
  ``launch/steps.py:loss_grads``, against ``jax.value_and_grad`` of the
  reference's ``loss_fn``: each leaf within a relative Frobenius of 1e-4,
  the bound of ``test_torch_train.py``. Whisper's batch carries frames and
  the VLM's patches, from N(0, 0.1^2) as the reference's tests draw them.
  The VLM's cross gates are zero at init, which would give its cross
  blocks' weights a zero gradient: they are set to 0.7 and -0.4 first.
- The VLM is held against the reference run in float64 (its parameters,
  patches and activations; the reference's own float32 casts stay), the
  yardstick both float32 runs round apart from (XLA:CPU fuses
  multiply-adds, torch does not). The port's gap to the jitted float32
  reference is printed and not gated.
- remat on and off give bit-equal losses and gradients in the port;
- one Zamba2 ``make_train_step`` step against the reference's jitted step;
- the keyed init in bf16 is the float32 one cast leaf by leaf;
- ``train`` refuses the audio and vlm families, whose batches the
  reference's trainer builds without their memory: the reference raises
  ``KeyError: 'frames'`` (Whisper) and ``AttributeError`` (the VLM's
  missing patches) on the same call.
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
from repro.launch import steps as JS  # noqa: E402
from repro.launch import train as JT  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

REL = 1e-4
ARCHS = ("zamba2_1_2b", "xlstm_1_3b", "whisper_small", "llama3_2_vision_11b")
# held against the reference run in float64: its jitted float32 run rounds
# further from it than the port does
FLOAT64_REFERENCE = ("llama3_2_vision_11b",)
GATES = (0.7, -0.4)           # attn_gate, mlp_gate of every cross block
MEMORY_STD = 0.1
B, SEQ = 2, 32
CPU = "cpu"


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


def _f32(t):
    return t.detach().to(torch.float32).numpy()


def _configs(arch):
    return (get_smoke(arch).replace(dtype="float32"),
            jget_smoke(arch).replace(dtype="float32"))


def _set_gates(jp):
    """Non-zero cross-block gates in the reference's tree (vlm)."""
    if "cross_groups" not in jp:
        return jp
    cg = dict(jp["cross_groups"])
    for name, g in zip(("attn_gate", "mlp_gate"), GATES):
        cg[name] = jnp.full_like(cg[name], g)
    return {**jp, "cross_groups": cg}


def _batch(cfg, seed=1, seq=SEQ):
    """numpy tokens (B, seq) and the family's memory: frames (B,
    encoder_seq_len, d_model) or patches (B, vision_seq_len, d_model)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, seq)).astype(
        np.int32)}
    memory = {"audio": ("frames", cfg.encoder_seq_len),
              "vlm": ("patches", cfg.vision_seq_len)}.get(cfg.family)
    if memory is not None:
        key, n = memory
        batch[key] = (rng.standard_normal((B, n, cfg.d_model))
                      * MEMORY_STD).astype(np.float32)
    return batch


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def _jbatch(batch, dtype=jnp.float32):
    return {k: jnp.asarray(v) if k == "tokens" else jnp.asarray(v, dtype)
            for k, v in batch.items()}


def _ref_params(jcfg, cfg):
    """(the reference's init_params with the cross gates set, the same as
    port tensors)."""
    jp = _set_gates(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jp, M.params_from_numpy(tree, cfg, device=CPU)


def _reference_grads(jp, jcfg, batch, float64):
    """((total, ce), grads) of the reference's ``loss_fn`` as numpy
    float64: jitted in float32, or run in float64 (its parameters, memory
    and activations; the reference's own float32 casts stay)."""
    def value_and_grad(jp, jcfg, jb):
        return jax.jit(jax.value_and_grad(
            lambda pp: JM.loss_fn(pp, jb, jcfg), has_aux=True))(jp)

    if not float64:
        (total, ce), g = value_and_grad(jp, jcfg, _jbatch(batch))
        return ((float(total), float(ce)),
                [np.asarray(x, np.float64) for x in jax.tree.leaves(g)])
    with jax.enable_x64(True):
        jp64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                            jp)
        (total, ce), g = value_and_grad(jp64, jcfg.replace(dtype="float64"),
                                        _jbatch(batch, jnp.float64))
        return ((float(total), float(ce)),
                [np.asarray(x, np.float64) for x in jax.tree.leaves(g)])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_value_and_grads_match_reference(arch):
    cfg, jcfg = _configs(arch)
    jp, params = _ref_params(jcfg, cfg)
    batch = _batch(cfg)
    total, ce = M.loss_fn(params, _tbatch(batch), cfg)
    grads, ce_g = S.loss_grads(params, _tbatch(batch), cfg)
    leaves = [_f32(g) for g in tree_leaves(grads)]
    assert float(ce_g) == float(ce)

    float64 = arch in FLOAT64_REFERENCE
    (jtotal, jce), jleaves = _reference_grads(jp, jcfg, batch, float64)
    assert abs(float(total) - jtotal) <= REL * abs(jtotal)
    assert abs(float(ce) - jce) <= REL * abs(jce)
    assert len(leaves) == len(jleaves)
    gaps = []
    for g, w in zip(leaves, jleaves):
        assert g.shape == w.shape
        assert np.linalg.norm(w) > 0, g.shape    # every leaf is held
        gaps.append(_rel(g, w))
    assert max(gaps) <= REL, max(gaps)
    if float64:
        jitted = _reference_grads(jp, jcfg, batch, False)[1]
        print(f"{arch}: the port's float32 gradients within {max(gaps):.3g} "
              f"of the float64 reference; the jitted float32 reference's "
              f"within {max(_rel(a, b) for a, b in zip(jitted, jleaves)):.3g}"
              f"; the port from the jitted reference "
              f"{max(_rel(a, b) for a, b in zip(leaves, jitted)):.3g}")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_bit_equal(arch):
    cfg, jcfg = _configs(arch)
    params = _ref_params(jcfg, cfg)[1]
    batch = _tbatch(_batch(cfg, seed=3))
    g_on, ce_on = S.loss_grads(params, batch, cfg)
    g_off, ce_off = S.loss_grads(params, batch, cfg.replace(remat="none"))
    assert cfg.remat != "none"
    assert torch.equal(ce_on, ce_off)
    for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)):
        assert torch.equal(a, b)


def test_train_step_matches_reference_jitted_step():
    cfg, jcfg = _configs("zamba2_1_2b")
    jp, params = _ref_params(jcfg, cfg)
    batch = _batch(cfg, seed=2)
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    tcfg, jtcfg = TrainConfig(**kw), JTrainConfig(**kw)
    p2, opt2, m = S.make_train_step(cfg, tcfg)(
        params, adamw.init(params, tcfg), _tbatch(batch))
    jp2, jopt2, jm = jax.jit(JS.make_train_step(jcfg, jtcfg))(
        jp, JA.init(jp, jtcfg), _jbatch(batch))
    for key in ("loss", "lr", "grad_norm"):
        assert abs(float(m[key]) - float(jm[key])) <= REL * abs(
            float(jm[key])), key
    for tree, jtree in ((p2, jp2), (opt2.mu, jopt2.mu), (opt2.nu, jopt2.nu)):
        for a, b in zip(tree_leaves(tree), jax.tree.leaves(jtree)):
            assert _rel(_f32(a), b) <= REL
    assert int(opt2.step) == int(jopt2.step) == 1


@pytest.mark.parametrize("arch", ARCHS + ("minicpm3_4b",))
def test_keyed_init_in_bf16_is_the_float32_init_cast(arch):
    """Each leaf of the trainer's keyed init is (normal x scale) cast to its
    dtype, so the float32 init cast leaf by leaf is the bf16 init, bit for
    bit (a card check draws the float32 parameters once and casts them)."""
    cfg = get_smoke(arch).replace(dtype="bfloat16")
    key = prng.PRNGKey(0)
    defs = M.model_defs(cfg)
    want = L.init_params_keyed(key, defs, torch.bfloat16, device=CPU)
    got = tree_map(lambda t, d: t.to(d.dtype or torch.bfloat16),
                   L.init_params_keyed(key, M.model_defs(cfg.replace(
                       dtype="float32")), torch.float32, device=CPU), defs)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch,error,match", [
    ("whisper_small", KeyError, "frames"),
    ("llama3_2_vision_11b", AttributeError, "shape")])
def test_train_refuses_the_families_the_reference_cannot_train(arch, error,
                                                                match):
    """The reference's trainer feeds the step only the pipeline's tokens;
    the forward of these families reads frames or patches beside them."""
    cfg, jcfg = _configs(arch)
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=1)
    with pytest.raises(error, match=match):
        JT.train(jcfg, JTrainConfig(**kw), batch=2, seq=16, steps=1,
                 log_every=0)
    with pytest.raises(NotImplementedError, match=cfg.family):
        T.train(cfg, TrainConfig(**kw), batch=2, seq=16, steps=1,
                log_every=0, device=CPU)
