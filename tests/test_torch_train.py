"""The port's training path against the JAX reference on the CPU, on the
same numpy inputs and the same parameters (the reference's
``init_params``, carried across by ``params_from_numpy``, or the port's
``init_params_keyed`` with the reference's key).

- ``loss_fn``'s value and gradients against ``jax.value_and_grad`` of the
  reference's for the smollm, qwen3-moe (its aux loss) and minicpm3 (MLA)
  smoke configs in float32: each leaf within a relative Frobenius of 1e-4
  (float32 on both sides, other summation orders, through ~30 ops a
  block and the jitted reference's fused multiply-adds);
- remat on and off give bit-equal losses and gradients in the port;
- one ``make_train_step`` step against the reference's jitted step;
- the reference's microbatch (yi smoke, m 1/2/4), bf16-moment and
  compressed-step tests, rerun on the port with their bounds;
- ``train`` on the smollm smoke config: the loss falls (the reference
  test's margin), a resume is bitwise, and its losses match the
  reference ``train``'s over 10 steps: float32 within 1e-4 relative, bf16
  within ``BF16_LOSS`` (absolute; the two frameworks round bf16
  activations at other places, an error that grows with the steps).
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
from repro_torch.configs.base import SHAPES, TrainConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import compression as GC  # noqa: E402

REL = 1e-4
BF16_LOSS = 5e-3
ARCHS = ("smollm_135m", "qwen3_moe_235b", "minicpm3_4b")
CPU = "cpu"


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.linalg.norm(want), 1e-12)
    return np.linalg.norm(got - want) / scale


def _f32(t):
    return t.detach().to(torch.float32).numpy()


def _configs(arch, dtype="float32"):
    return (get_smoke(arch).replace(dtype=dtype),
            jget_smoke(arch).replace(dtype=dtype))


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _ref_params(jcfg, cfg, seed=0):
    """(the reference's init_params, the same as port tensors)."""
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jp, M.params_from_numpy(tree, cfg, device=CPU)


def _port_loss_and_grads(params, tokens, cfg):
    grads, ce = S.loss_grads(params, {"tokens": torch.from_numpy(tokens)},
                            cfg)
    return ce, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_value_and_grads_match_reference(arch):
    cfg, jcfg = _configs(arch)
    jp, params = _ref_params(jcfg, cfg)
    tokens = _tokens(cfg, 2, 32)
    total, ce = M.loss_fn(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    ce_g, grads = _port_loss_and_grads(params, tokens, cfg)

    (jtotal, jce), jgrads = jax.jit(jax.value_and_grad(
        lambda pp: JM.loss_fn(pp, {"tokens": jnp.asarray(tokens)}, jcfg),
        has_aux=True))(jp)
    assert abs(float(total) - float(jtotal)) <= REL * abs(float(jtotal))
    assert abs(float(ce) - float(jce)) <= REL * abs(float(jce))
    assert float(ce_g) == float(ce)
    jleaves = jax.tree.leaves(jgrads)
    leaves = tree_leaves(grads)
    assert len(leaves) == len(jleaves)
    for g, w in zip(leaves, jleaves):
        assert g.shape == tuple(w.shape)
        assert _rel(_f32(g), w) <= REL, (g.shape, _rel(_f32(g), w))
    if cfg.moe is not None:       # the aux loss enters the total
        assert float(total) != float(ce)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_bit_equal(arch):
    cfg, _ = _configs(arch)
    params = T.init_train_state(cfg, TrainConfig(), CPU)[0]
    tokens = _tokens(cfg, 2, 24, seed=3)
    ce_on, g_on = _port_loss_and_grads(params, tokens, cfg)
    ce_off, g_off = _port_loss_and_grads(params, tokens,
                                         cfg.replace(remat="none"))
    assert torch.equal(ce_on, ce_off)
    for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)):
        assert torch.equal(a, b)


def test_init_train_state_is_the_reference_init():
    cfg, jcfg = _configs("smollm_135m")
    params, opt = T.init_train_state(cfg, TrainConfig(seed=0), CPU)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    for a, b in zip(tree_leaves(params), jax.tree.leaves(jp)):
        np.testing.assert_allclose(_f32(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert int(opt.step) == 0


def test_train_step_matches_reference_jitted_step():
    cfg, jcfg = _configs("smollm_135m")
    jp, params = _ref_params(jcfg, cfg)
    tokens = _tokens(cfg, 4, 32, seed=2)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    jtcfg = JTrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    p2, opt2, m = S.make_train_step(cfg, tcfg)(
        params, adamw.init(params, tcfg), {"tokens": torch.from_numpy(tokens)})
    jp2, jopt2, jm = jax.jit(JS.make_train_step(jcfg, jtcfg))(
        jp, JA.init(jp, jtcfg), {"tokens": jnp.asarray(tokens)})
    for key in ("loss", "lr", "grad_norm"):
        assert abs(float(m[key]) - float(jm[key])) <= REL * abs(
            float(jm[key])), key
    for tree, jtree in ((p2, jp2), (opt2.mu, jopt2.mu), (opt2.nu, jopt2.nu)):
        for a, b in zip(tree_leaves(tree), jax.tree.leaves(jtree)):
            assert _rel(_f32(a), b) <= REL
    assert int(opt2.step) == int(jopt2.step) == 1


def test_microbatched_grads_match_full_batch():
    """The reference's test on the port (yi smoke, m 1/2/4)."""
    cfg = get_smoke("yi_9b")
    params = T.init_train_state(cfg, TrainConfig(), CPU)[0]
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 4, 32))}
    outs = {}
    for m in (1, 2, 4):
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1,
                           total_steps=10, microbatches=m)
        p2, _, metrics = S.make_train_step(cfg, tcfg)(
            params, adamw.init(params, tcfg), batch)
        outs[m] = (tree_leaves(p2), float(metrics["loss"]))
    for m in (2, 4):
        assert abs(outs[m][1] - outs[1][1]) < 5e-2
        for a, b in zip(outs[1][0], outs[m][0]):
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=0.1,
                                       atol=2e-2)


def test_microbatched_step_matches_reference():
    """m = 2 in float32 against the reference's jitted step (its float32
    accumulation of g / m in the same order)."""
    cfg, jcfg = _configs("smollm_135m")
    jp, params = _ref_params(jcfg, cfg)
    tokens = _tokens(cfg, 4, 32, seed=4)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                       microbatches=2)
    jtcfg = JTrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                         microbatches=2)
    p2, _, m = S.make_train_step(cfg, tcfg)(
        params, adamw.init(params, tcfg), {"tokens": torch.from_numpy(tokens)})
    jp2, _, jm = jax.jit(JS.make_train_step(jcfg, jtcfg))(
        jp, JA.init(jp, jtcfg), {"tokens": jnp.asarray(tokens)})
    assert abs(float(m["loss"]) - float(jm["loss"])) <= REL * float(jm["loss"])
    for a, b in zip(tree_leaves(p2), jax.tree.leaves(jp2)):
        assert _rel(_f32(a), b) <= REL


def test_optimizer_bf16_moments_close_to_fp32():
    """The reference's test on the port."""
    cfg = get_smoke("smollm_135m")
    params = T.init_train_state(cfg, TrainConfig(), CPU)[0]
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 2, 32))}
    results = {}
    for dt in ("float32", "bfloat16"):
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1,
                           total_steps=10, moment_dtype=dt)
        step = S.make_train_step(cfg, tcfg)
        p, o = params, adamw.init(params, tcfg)
        for _ in range(3):
            p, o, m = step(p, o, batch)
        results[dt] = float(m["loss"])
        assert tree_leaves(o.mu)[0].dtype == M.torch_dtype(dt)
    assert abs(results["bfloat16"] - results["float32"]) < 0.05


def test_compressed_step_trains():
    """The reference's test on the port: both overfit the fixed batch, the
    compressed step within 15% of the uncompressed one."""
    cfg = get_smoke("smollm_135m")
    params = T.init_train_state(cfg, TrainConfig(), CPU)[0]
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 4, 32))}
    results = {}
    for compress in (False, True):
        tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2,
                           total_steps=20, grad_compression=compress)
        p, opt = params, adamw.init(params, tcfg)
        step = S.make_train_step(cfg, tcfg)
        res = GC.init_residual(p) if compress else None
        losses = []
        for _ in range(12):
            if compress:
                p, opt, metrics, res = step(p, opt, batch, res)
            else:
                p, opt, metrics = step(p, opt, batch)
            losses.append(float(metrics["loss"]))
        results[compress] = losses
    assert results[True][-1] < results[True][0] * 0.9
    assert abs(results[True][-1] - results[False][-1]) \
        < 0.15 * results[False][-1] + 0.2


def test_prefill_decode_steps_and_default_microbatches():
    cfg = get_smoke("smollm_135m").replace(dtype="float32")
    params = T.init_train_state(cfg, TrainConfig(), CPU)[0]
    tokens = torch.from_numpy(_tokens(cfg, 2, 16))
    logits, caches = S.make_prefill_step(cfg, SHAPES["prefill_32k"])(
        params, {"tokens": tokens})
    want = M.prefill(params, {"tokens": tokens}, cfg)[0]
    assert torch.equal(logits, want)
    step = S.make_decode_step(cfg, SHAPES["decode_32k"])
    # the last prompt token again at its position: the prefill's logits, up
    # to the KV cache's bf16 (the reference's init_caches default)
    out, _ = step(params, tokens[:, -1:], caches, 15)
    np.testing.assert_allclose(_f32(out).reshape(2, -1),
                               _f32(logits).reshape(2, -1),
                               rtol=1e-2, atol=1e-2)
    # the reference's rule: 1 off training, 8 above 1e9 parameters, else 2
    for arch in ("smollm_135m", "yi_9b"):
        for shape in SHAPES.values():
            assert S.default_microbatches(get_smoke(arch), shape) == \
                JS.default_microbatches(jget_smoke(arch), shape)
    from repro_torch.configs import get_config
    from repro.configs import get_config as jget_config
    for arch in ("smollm_135m", "yi_9b"):
        assert S.default_microbatches(get_config(arch), SHAPES["train_4k"]) \
            == JS.default_microbatches(jget_config(arch),
                                       SHAPES["train_4k"]) == \
            (8 if arch == "yi_9b" else 2)


def test_smollm_loss_decreases():
    """The reference's test on the port."""
    cfg = get_smoke("smollm_135m")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=5, total_steps=30)
    _, _, losses = T.train(cfg, tcfg, batch=4, seq=64, steps=30,
                           ckpt_dir=None, log_every=0, device=CPU)
    assert losses[-1] < losses[0] - 0.2, (losses[0], losses[-1])


def test_resume_is_bitwise(tmp_path):
    """The reference's test on the port: 10 steps straight against 5, a
    checkpoint and a resume to 10."""
    cfg = get_smoke("smollm_135m")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    pA, oA, _ = T.train(cfg, tcfg, batch=2, seq=32, steps=10, ckpt_dir=None,
                        log_every=0, device=CPU)
    d = tmp_path / "ck"
    T.train(cfg, tcfg, batch=2, seq=32, steps=5, ckpt_dir=str(d),
            ckpt_every=5, log_every=0, device=CPU)
    pB, oB, lossesB = T.train(cfg, tcfg, batch=2, seq=32, steps=10,
                              ckpt_dir=str(d), ckpt_every=100, log_every=0,
                              device=CPU)
    assert len(lossesB) == 5
    for tree_a, tree_b in ((pA, pB), (oA.mu, oB.mu), (oA.nu, oB.nu)):
        for a, b in zip(tree_leaves(tree_a), tree_leaves(tree_b)):
            assert torch.equal(a, b)
    assert torch.equal(oA.step, oB.step)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_losses_match_reference_train(dtype):
    cfg, jcfg = _configs("smollm_135m", dtype)
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    _, _, losses = T.train(cfg, TrainConfig(**kw), batch=4, seq=64,
                           steps=10, log_every=0, device=CPU)
    _, _, jlosses = JT.train(jcfg, JTrainConfig(**kw), batch=4, seq=64,
                             steps=10, log_every=0)
    gap = np.abs(np.asarray(losses) - np.asarray(jlosses))
    if dtype == "float32":
        assert np.all(gap <= REL * np.abs(jlosses)), gap
    else:
        assert np.all(gap <= BF16_LOSS), gap
    assert losses[-1] < losses[0]


def test_train_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        T.train(get_smoke("smollm_135m"), TrainConfig(), batch=1, seq=8,
                steps=1)


def test_main_runs_on_the_cpu_when_asked(tmp_path, capsys):
    T.main(["--smoke", "--steps", "3", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "[train] done in" in out
    from repro_torch.runtime.checkpoint import latest_step
    assert latest_step(tmp_path / "ck") == 3
