"""The port's fault injectors (runtime/faults.py) against the JAX
reference, on the CPU: the same device result, fault key and check
decision give a bit-equal corrupted result and the same ground truth, and
the liveness injector fires on the same (seed, op, attempt)."""
import threading

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (imports before the kernel ops)
from repro.core import slalom as JS  # noqa: E402
from repro.runtime import faults as JF  # noqa: E402
from repro_torch.core import slalom as TS  # noqa: E402
from repro_torch.kernels.limb_matmul.ref import P  # noqa: E402
from repro_torch.runtime import faults as TF  # noqa: E402

SHAPES = [(37, 11), (1, 5), (2, 3), (70_001, 3)]


def _y(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.int32)


def _pair(kind, **kw):
    return (JF.DishonestDevice(JF.FaultSpec(kind, **kw)),
            TF.DishonestDevice(TF.FaultSpec(kind, **kw)))


def test_kinds_and_domains_match_reference():
    assert TF.KINDS == JF.KINDS
    assert TF.LIVENESS_KINDS == JF.LIVENESS_KINDS
    assert TS.FAULT_DOMAIN == JS.FAULT_DOMAIN
    for parts in [(), (1, "crash", 3, 0), ("x", 2.5, None)]:
        assert TF.stable_seed(*parts) == JF.stable_seed(*parts)


@pytest.mark.parametrize("will_verify", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", list(JF.KINDS))
def test_corrupt_bit_equal_to_reference(kind, shape, will_verify):
    y = _y(shape, seed=shape[0] + len(kind))
    jdev, tdev = _pair(kind)
    for op in range(3):
        key = JS.SlalomContext(jax.random.PRNGKey(op + 5)).fault_key(op)
        tkey = TS.SlalomContext(np.asarray(jax.random.PRNGKey(op + 5))
                                ).fault_key(op)
        np.testing.assert_array_equal(tkey, np.asarray(key))
        jy, jchanged = jdev.corrupt(jnp.asarray(y), op_index=op, key=key,
                                    will_verify=jnp.bool_(will_verify))
        ty, tchanged = tdev.corrupt(torch.from_numpy(y), op_index=op,
                                    key=tkey, will_verify=will_verify)
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        assert tchanged.dtype == torch.bool and tchanged.dim() == 0
        assert bool(tchanged) == bool(jchanged)
    assert tdev.targeted_ops == jdev.targeted_ops == 3


@pytest.mark.parametrize("kind", ["bit_flip", "stale"])
def test_partial_probability_and_op_targeting(kind):
    """prob < 1 gates per (session, op); ``ops`` restricts the targets."""
    y = _y((9, 6), seed=1)
    jdev, tdev = _pair(kind, prob=0.4, ops=(0, 2, 3, 5))
    fired = []
    for seed in range(12):
        for op in range(6):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), op)
            jy, jc = jdev.corrupt(jnp.asarray(y), op_index=op, key=key,
                                  will_verify=jnp.bool_(False))
            ty, tc = tdev.corrupt(torch.from_numpy(y), op_index=op,
                                  key=np.asarray(key), will_verify=False)
            np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
            assert bool(tc) == bool(jc)
            fired.append(bool(tc))
            if op in (1, 4):
                assert not bool(tc)
    assert 0 < sum(fired) < 48
    assert tdev.targeted_ops == jdev.targeted_ops == 48


def _fire_pattern(mod, spec, seed, ops=6, attempts=3):
    inj = mod.UnresponsiveDevice(spec, seed=seed)
    done = threading.Event()
    pattern = []
    for op in range(ops):
        for _ in range(attempts):
            try:
                inj.perturb(op_index=op, cancel=done)
                pattern.append(False)
            except mod.DeviceCrash:
                pattern.append(True)
    return pattern, inj.fired


@pytest.mark.parametrize("kind,kw", [("flaky", {"prob": 0.6}),
                                     ("flaky", {"prob": 1.0, "decay": 0.5}),
                                     ("crash", {"prob": 0.5}),
                                     ("crash", {"ops": (1, 4)}),
                                     ("brownout", {"prob": 0.5,
                                                   "delay_s": 0.0})])
def test_liveness_decisions_match_reference(kind, kw):
    for seed in (0, 3, 11):
        want = _fire_pattern(JF, JF.LivenessSpec(kind, **kw), seed)
        got = _fire_pattern(TF, TF.LivenessSpec(kind, **kw), seed)
        assert got == want


def test_hang_parks_on_the_cancel_event():
    inj = TF.UnresponsiveDevice(TF.LivenessSpec("hang"))
    cancel = threading.Event()
    cancel.set()                       # abandoned before the dispatch
    with pytest.raises(TF.DeviceCrash):
        inj.perturb(op_index=0, cancel=cancel)
    assert inj.fired == 1


@pytest.mark.parametrize("bad", [lambda: TF.FaultSpec("nope"),
                                 lambda: TF.FaultSpec("stale", prob=0.0),
                                 lambda: TF.LivenessSpec("nope"),
                                 lambda: TF.LivenessSpec("crash", decay=2.0)])
def test_specs_reject_bad_values(bad):
    with pytest.raises(AssertionError):
        bad()
