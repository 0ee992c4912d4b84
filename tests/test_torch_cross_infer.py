"""The private LM forward (``OrigamiExecutor.infer``) of the port's
cross-attention families against the JAX reference on the CPU, at the
smoke configs with the reference's ``init_params`` carried over (the VLM's
cross-block gates set non-zero in both trees, as in
tests/test_torch_cross.py): Whisper-small on {"tokens", "frames"}, its
plan over the encoder blocks, and Llama-3.2-Vision-11B on {"tokens",
"patches"}, its cross blocks attending to the patches in every segment.

The reference runs its blocks under ``lax.scan``: each projection of a
scanned tier-1 segment is traced once, blinded with one pad, and its
check is dropped (ROADMAP Queue 3). Its counters are pinned below:
Whisper 6 calls and 0 checked ops at p = 1 and at p = 2 (the two encoder
blocks are one scan); Llama-3.2-Vision 7 and 0 at p = 1, 14 and 7 at p =
5, where the unscanned cross block's 7 ops are checked. The port walks
the blocks one by one and draws a fresh pad for each runtime op: 6 ops a
Whisper encoder block (q, k, v, o, w_up, w_down), 7 a VLM self block (q,
k, v, o, w_gate, w_up, w_down) and 7 for its cross block (the k and v
projections of the patches among them), every one checked. Its first
blinded op (key ``(session, 0, 0)`` in both) is bit-equal to the
reference's first fused call of ``infer(jit=False)`` at p = 1, where the
scan holds one block.

Tolerances. The blinding cancels exactly, so blinded logits equal trusted
ones bit for bit. Against the reference's blinded logits (bf16, the
configs' dtype) the port is held at a relative Frobenius error of 0.1:
the two packages round bf16 at different points (tests/test_torch_cross.py
holds the open forward at 0.05), and the tier-1 8-bit quantization turns
an ulp that crosses a rounding boundary into a step of 1/256 of the scale
(measured: 0.007 for Whisper, 0.020-0.024 for Llama-3.2-Vision; the
float forward 0.007 and 0.012).
"""
import dataclasses

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core.slalom as JSL  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.core import integrity as JIG  # noqa: E402
from repro.core.origami import OrigamiExecutor as JEx  # noqa: E402
from repro.models import model as JM  # noqa: E402
import repro_torch.core.slalom as SL  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core import integrity as IG  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.origami import OrigamiExecutor  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

INFER_REL = 0.1
SESSION = 11
ARCHS = ("whisper_small", "llama3_2_vision_11b")
# the reference's eager infer: partition -> (telemetry calls, checked ops)
REF_COUNTERS = {"whisper_small": {1: (6, 0), 2: (6, 0)},
                "llama3_2_vision_11b": {1: (7, 0), 5: (14, 7)}}
BLOCK_OPS = {"whisper_small": 6, "llama3_2_vision_11b": 7}
CROSS_OPS = 7             # the VLM cross block: q, k, v, o, gate, up, down
GATES = (0.7, -0.4)


class _FirstFusedCallback:
    """Records the output of the reference's first fused blinded matmul of
    a run: a debug callback hands the traced value over when it is
    computed; traced call 0 is block 0's first projection."""

    def __init__(self):
        self.inner = JSL.fused_blinded_matmul
        self.calls, self.first = 0, None

    def __call__(self, *a, **kw):
        y = self.inner(*a, **kw)
        if self.calls == 0:
            jax.debug.callback(self._store, y)
        self.calls += 1
        return y

    def _store(self, v):
        if self.first is None:
            self.first = np.array(v, np.float32)

    def __enter__(self):
        JSL.fused_blinded_matmul = self
        return self

    def __exit__(self, *exc):
        JSL.fused_blinded_matmul = self.inner


class _FirstFused:
    """Records the output of the port's first fused blinded matmul."""

    def __init__(self):
        self.inner, self.first = SL.fused_blinded_matmul, None

    def __call__(self, *a, **kw):
        y = self.inner(*a, **kw)
        if self.first is None:
            self.first = np.array(y, np.float32)
        return y

    def __enter__(self):
        SL.fused_blinded_matmul = self
        return self

    def __exit__(self, *exc):
        SL.fused_blinded_matmul = self.inner


def _rel(got, want, bound):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < bound, rel


def _f32(t):
    return t.to(torch.float32).numpy()


_BUILT = {}


def _built(arch):
    """(arch, cfg, jcfg, reference params, port params, numpy batch):
    tokens (2, 16) and the memory from N(0, 0.1^2); built once."""
    if arch not in _BUILT:
        _BUILT[arch] = _build(arch)
    return _BUILT[arch]


@pytest.fixture(scope="module", params=ARCHS)
def cross_lm(request):
    return _built(request.param)


def _build(arch):
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    if cfg.family == "vlm":
        cg = dict(jp["cross_groups"])
        for name, g in zip(("attn_gate", "mlp_gate"), GATES):
            cg[name] = jnp.full_like(cg[name], g)
        jp = {**jp, "cross_groups": cg}
    params = M.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    rng = np.random.default_rng(2)
    key, n = (("frames", cfg.encoder_seq_len) if cfg.family == "audio"
              else ("patches", cfg.vision_seq_len))
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)),
             key: (rng.standard_normal((2, n, cfg.d_model))
                   * 0.1).astype(np.float32)}
    return arch, cfg, jcfg, jp, params, batch


@pytest.fixture(scope="module")
def reference(cross_lm):
    """The reference's eager ``infer`` under full(k=2) at each pinned
    partition (its first fused op recorded at p = 1), and its float
    forward."""
    arch, _, jcfg, jp, _, batch = cross_lm
    jb = {k: jnp.asarray(v.astype(np.int32) if k == "tokens" else v)
          for k, v in batch.items()}
    runs = {}
    for p in REF_COUNTERS[arch]:
        ex = JEx(jcfg, jp, "origami", partition=p,
                 integrity=JIG.IntegrityPolicy.full(k=2))
        with _FirstFusedCallback() as rec:
            res = ex.infer(jb, session_key=jax.random.PRNGKey(SESSION),
                           jit=False)
            jax.effects_barrier()
        runs[p] = {"logits": np.asarray(res.logits, np.float32),
                   "n_ops": res.integrity.n_ops,
                   "telemetry": dataclasses.asdict(ex.telemetry_blinded),
                   "first": rec.first}
    runs["forward"] = np.asarray(JM.forward(jp, jb, jcfg).logits,
                                 np.float32)
    return runs


def _executor(cfg, params, partition, **kw):
    kw.setdefault("integrity", IG.IntegrityPolicy.full(k=2))
    return OrigamiExecutor(cfg, params, "origami", partition, device="cpu",
                           **kw)


def _ops(arch, cfg, partition):
    """The port's blinded ops of a tier-1 range [0, partition)."""
    if cfg.family == "audio":
        return BLOCK_OPS[arch] * partition
    n_cross = partition // cfg.cross_attn_every
    return BLOCK_OPS[arch] * (partition - n_cross) + CROSS_OPS * n_cross


def test_reference_counters(cross_lm, reference):
    """The reference's scanned forward: one traced call a projection of a
    scanned segment, none of them checked; the VLM's unscanned cross
    block's 7 ops checked."""
    arch = cross_lm[0]
    for p, (calls, n_ops) in REF_COUNTERS[arch].items():
        tele = reference[p]["telemetry"]
        assert tele["calls"] == tele["device_matmuls"] == calls, (p, tele)
        assert reference[p]["n_ops"] == n_ops, p


# the partitions each smoke model runs blinded (Whisper has 2 encoder
# blocks; the VLM 4 self blocks and its cross block)
PARTITIONS = {"whisper_small": (1, 2), "llama3_2_vision_11b": (1, 4, 5)}


@pytest.mark.parametrize("arch,partition", [(a, p) for a in ARCHS
                                            for p in PARTITIONS[a]])
def test_infer_blinded_equals_trusted(arch, partition):
    """Every tier-1 op checked and passing, blinded == trusted bit for bit
    in the logits and the boundary: 6p for Whisper; 7p for the VLM up to
    p = 4 and 35 at p = 5 (its first cross block blinded)."""
    _, cfg, _, _, params, batch = _built(arch)
    ex = _executor(cfg, params, partition)
    key = prng.PRNGKey(SESSION)
    blinded = ex.infer(batch, key)
    trusted = ex.infer(batch, key, trusted=True)
    assert blinded.logits.shape == (2, 16, cfg.padded_vocab)
    assert torch.equal(blinded.logits, trusted.logits)
    assert torch.equal(blinded.boundary, trusted.boundary)
    n_ops = _ops(arch, cfg, partition)
    rep, tele = blinded.integrity, blinded.telemetry
    assert rep.n_ops == rep.n_checked == n_ops and rep.ok
    assert tele.calls == tele.device_matmuls == tele.verify_ops == n_ops
    assert trusted.integrity.n_ops == 0
    assert trusted.telemetry.trusted_matmuls == n_ops


def test_counts_at_the_published_partitions():
    """Whisper-small's p = 2: 12 ops; Llama-3.2-Vision-11B's p = 4 (its
    first four self blocks): 28, and 35 at p = 5."""
    whisper, vlm = get_config("whisper_small"), get_config(
        "llama3_2_vision_11b")
    assert whisper.origami.tier1_layers == 2
    assert vlm.origami.tier1_layers == 4
    assert _ops("whisper_small", whisper, 2) == 12
    assert _ops("llama3_2_vision_11b", vlm, 4) == 28
    assert _ops("llama3_2_vision_11b", vlm, 5) == 35


def test_infer_matches_reference_logits(cross_lm, reference):
    arch, cfg, _, _, params, batch = cross_lm
    for p in REF_COUNTERS[arch]:
        ex = _executor(cfg, params, p)
        _rel(_f32(ex.infer(batch, prng.PRNGKey(SESSION)).logits),
             reference[p]["logits"], INFER_REL)
    _rel(_f32(ex.reference(batch)), reference["forward"], INFER_REL)


def test_first_blinded_op_bit_equal_to_reference(cross_lm, reference):
    _, cfg, _, _, params, batch = cross_lm
    ex = _executor(cfg, params, 1)
    with _FirstFused() as rec:
        ex.infer(batch, prng.PRNGKey(SESSION))
    assert reference[1]["first"] is not None
    np.testing.assert_array_equal(rec.first, reference[1]["first"])


def test_on_device_keeps_the_memory_float(cross_lm):
    """Tokens go to the device as long, frames and patches as float32 (a
    cast to long would truncate them); the reference forward reads them."""
    _, cfg, _, _, params, batch = cross_lm
    ex = _executor(cfg, params, 1)
    on = ex._on_device(batch)
    assert on["tokens"].dtype == torch.long
    key = "frames" if cfg.family == "audio" else "patches"
    assert on[key].dtype == torch.float32
    np.testing.assert_array_equal(on[key].numpy(), batch[key])
    with torch.no_grad():
        want = M.forward(params, on, cfg).logits
    assert torch.equal(ex.reference(batch), want)


def test_bit_flip_caught_op_by_op(cross_lm):
    from repro_torch.runtime.faults import DishonestDevice, FaultSpec
    arch, cfg, _, _, params, batch = cross_lm
    p = cfg.num_layers
    ex = _executor(cfg, params, p,
                   fault=DishonestDevice(FaultSpec("bit_flip")))
    rep = ex.infer(batch, prng.PRNGKey(SESSION)).integrity
    assert torch.equal(rep.failed, rep.corrupted)
    assert rep.n_failed == rep.n_corrupted == _ops(arch, cfg, p)


def test_boundary_after_the_first_block(cross_lm):
    """Whisper's plan ranges over the encoder: the tier-1 boundary is the
    encoder's hidden state (B, frames, d), and the split plan's float
    boundary is the open encoder's after p blocks."""
    _, cfg, _, _, params, batch = cross_lm
    ex = OrigamiExecutor(cfg, params, "split", 1, device="cpu")
    res = ex.infer(batch)
    if cfg.family == "audio":
        assert tuple(res.boundary.shape) == (2, cfg.encoder_seq_len,
                                             cfg.d_model)
        with torch.no_grad():
            x = M._audio_input(torch.from_numpy(batch["frames"]), cfg)
            want, _ = M.apply_range(params, x, cfg, 0, 1)
    else:
        assert tuple(res.boundary.shape) == (2, 16, cfg.d_model)
        with torch.no_grad():
            x = M.embed_tokens(params, torch.from_numpy(batch["tokens"]),
                               cfg)
            want, _ = M.apply_range(params, x, cfg, 0, 1, memory=None)
    assert torch.equal(res.boundary, want)

