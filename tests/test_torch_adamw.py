"""The port's AdamW (``optim/adamw.py``) against the reference's
``repro/optim/adamw.py`` on the CPU, on random nested trees carried across
as numpy arrays.

The reference runs eagerly (one XLA computation per op, so nothing is
contracted into an FMA) and the port does the same float32 arithmetic in
the same order; what remains is the summation order of the global norm and
the last ulp of a transcendental. An ulp of the norm moves every clipped
gradient by an ulp, and the moment update ``b1 * m + (1 - b1) * g`` and the
schedule's ``1 + cos`` cancel, so an element is held to rtol 1e-6 of
itself plus atol 1e-6 of its leaf's largest magnitude. A bfloat16 moment
is rounded from such a float32 value, so it may land one bfloat16 ulp
away: bfloat16 moments are held to 1 ulp. Each step starts both packages
from the reference's parameters and state, so such an ulp does not carry
into the next step's update.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402

RTOL = 1e-6
SHAPES = {"conv": {"w": (3, 3, 4, 8), "b": (8,)},
          "dense": {"w": (16, 12), "b": (12,)},
          "stack": {"scale": (2, 5), "w": (2, 6, 4)},
          "norm": (7,)}


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _state_to_torch(state):
    """The reference's AdamWState as the port's (bfloat16 moments carried
    across as their raw bits)."""
    def leaf(x):
        a = np.asarray(x)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))

    def conv(tree):
        return {k: conv(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else leaf(tree)

    return TA.AdamWState(torch.tensor(int(state.step), dtype=torch.int32),
                         conv(state.mu), conv(state.nu))


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:     # the raw bits, as int16
            return {prefix: tree.view(torch.int16).numpy()}
        return {prefix: tree.numpy()}
    if tree.dtype == jnp.bfloat16:
        return {prefix: np.asarray(tree).view(np.int16)}
    return {prefix: np.asarray(tree)}


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=RTOL * float(np.abs(want).max()),
        err_msg=err_msg)


def _assert_trees(got, want, what):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        if w[k].dtype == np.int16:           # bfloat16 bits: within 1 ulp
            assert g[k].dtype == np.int16, (what, k)
            gap = np.abs(g[k].astype(np.int32) - w[k].astype(np.int32))
            assert gap.max() <= 1, (what, k, gap.max())
        else:
            _close(g[k], w[k], f"{what} {k}")


CASES = {
    # name: (grad scale, grad_clip, weight_decay)
    "clip_active": (5.0, 1.0, 0.1),
    "clip_inactive": (0.01, 1.0, 0.1),
    "clip_off": (1.0, 0.0, 0.1),
    "no_decay": (5.0, 1.0, 0.0),
}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_update_matches_reference(case, moment_dtype):
    gscale, clip, wd = CASES[case]
    kw = dict(learning_rate=1e-2, weight_decay=wd, grad_clip=clip,
              moment_dtype=moment_dtype)
    tcfg, jcfg = TrainConfig(**kw), JTrainConfig(**kw)
    rng = np.random.default_rng(sorted(CASES).index(case))
    params = _tree(rng, SHAPES)
    tp, jp = _to_torch(params), _to_jax(params)
    ts, js = TA.init(tp, tcfg), JA.init(jp, jcfg)
    assert ts.mu["dense"]["w"].dtype == getattr(torch, moment_dtype)
    norms = []
    for step in range(4):
        grads = _tree(rng, SHAPES, gscale)
        lr = float(np.float32(1e-2 / (step + 1)))
        tp, ts, tm = TA.update(_to_torch(grads), ts, tp, tcfg, lr)
        jp, js, jm = JA.update(_to_jax(grads), js, jp, jcfg, jnp.float32(lr))
        _assert_trees(tp, jp, f"params after step {step}")
        _assert_trees(ts.mu, js.mu, f"mu after step {step}")
        _assert_trees(ts.nu, js.nu, f"nu after step {step}")
        assert int(ts.step) == int(js.step) == step + 1
        assert ts.step.dtype == torch.int32
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
        norms.append(float(tm["grad_norm"]))
        tp = _to_torch(jax.tree.map(np.asarray, jp))
        ts = _state_to_torch(js)
    # the case exercises what its name says
    if clip > 0:
        assert (min(norms) > clip) == (case != "clip_inactive"), norms


def test_weight_decay_only_on_matrices():
    """A zero gradient moves a >= 2-D leaf by lr * wd * p and leaves a
    1-D leaf where it was (the reference's ``p.ndim >= 2`` rule)."""
    tcfg = TrainConfig(learning_rate=0.5, weight_decay=0.1, grad_clip=0.0)
    params = {"w": torch.ones(3, 4), "b": torch.ones(4)}
    grads = {"w": torch.zeros(3, 4), "b": torch.zeros(4)}
    new, _, _ = TA.update(grads, TA.init(params, tcfg), params, tcfg, 0.5)
    assert torch.equal(new["b"], params["b"])
    torch.testing.assert_close(new["w"], torch.full((3, 4), 0.95),
                               rtol=0, atol=0)


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (100, 1000),
                                          (5, 5)])
def test_lr_schedule_matches_reference(warmup, total):
    kw = dict(learning_rate=3e-4, warmup_steps=warmup, total_steps=total)
    steps = np.arange(total + 3, dtype=np.int32)
    got = TA.lr_schedule(TrainConfig(**kw), torch.from_numpy(steps)).numpy()
    want = np.asarray(JA.lr_schedule(JTrainConfig(**kw), jnp.asarray(steps)))
    _close(got, want)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    tree = _tree(rng, SHAPES, 3.0)
    got = float(TA.global_norm(_to_torch(tree)))
    want = float(JA.global_norm(_to_jax(tree)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [1, 7, 40])
def test_update_in_slices_bit_equal_to_one_slice(chunk, moment_dtype,
                                                 monkeypatch):
    """A leaf larger than ``UPDATE_CHUNK`` is updated slice by slice into
    its new tensors: the same bits as the update of the whole leaf at
    once."""
    tcfg = TrainConfig(learning_rate=1e-2, moment_dtype=moment_dtype)
    rng = np.random.default_rng(chunk)
    params = _to_torch(_tree(rng, SHAPES))
    state = TA.init(params, tcfg)
    for step in range(3):
        grads = _to_torch(_tree(rng, SHAPES, 5.0))
        monkeypatch.setattr(TA, "UPDATE_CHUNK", 1 << 40)
        whole = TA.update(grads, state, params, tcfg, 1e-2)
        monkeypatch.setattr(TA, "UPDATE_CHUNK", chunk)
        sliced = TA.update(grads, state, params, tcfg, 1e-2)
        for a, b in ((whole[0], sliced[0]), (whole[1].mu, sliced[1].mu),
                     (whole[1].nu, sliced[1].nu)):
            for k, v in _flat(a).items():
                np.testing.assert_array_equal(_flat(b)[k], v, err_msg=k)
        params, state = sliced[0], sliced[1]
