"""The port's partition planner (``core/planner.py``), enclave cost model
(``core/trust.py``), SSIM (``privacy/ssim.py``) and synthetic images
(``privacy/data.py``) against the JAX reference, on the CPU.

The cost model is copied, so every modeled runtime, residency and fitted
unit cost is exactly the reference's. The privacy proxy goes through float
convolutions whose summation order differs between torch and XLA: SSIM is
held to atol 1e-5 and each boundary leakage to atol 1e-4, and the planner
must then pick the reference's partition and feasible set, since no
leakage of these configs lies within the tolerance of the floor (checked).
"""
import dataclasses

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (before kernels: circular import)
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.core import plan as JPL  # noqa: E402
from repro.core import planner as JP  # noqa: E402
from repro.core import trust as JTR  # noqa: E402
from repro.privacy import data as JD  # noqa: E402
from repro.privacy import ssim as JS  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core import integrity as TIG  # noqa: E402
from repro_torch.core import plan as TPL  # noqa: E402
from repro_torch.core import planner as TP  # noqa: E402
from repro_torch.core import trust as TTR  # noqa: E402
from repro_torch.models import vgg as V  # noqa: E402
from repro_torch.privacy import data as TD  # noqa: E402
from repro_torch.privacy import ssim as TS  # noqa: E402

LEAK_ATOL = 1e-4


def test_synthetic_images_equal_reference():
    np.testing.assert_array_equal(TD.make_batch(3, 4, 32),
                                  JD.make_batch(3, 4, 32))
    np.testing.assert_array_equal(TD.dataset(2, 16, 5), JD.dataset(2, 16, 5))


@pytest.mark.parametrize("win", [3, 4, 7])
@pytest.mark.parametrize("channels", [1, 3])
def test_ssim_matches_reference(win, channels):
    rng = np.random.default_rng(win * 10 + channels)
    x = rng.random((2, 24, 20, channels), np.float32)
    y = np.clip(x + rng.normal(0, 0.2, x.shape), 0, 1).astype(np.float32)
    got = float(TS.ssim(torch.from_numpy(x), torch.from_numpy(y), win=win))
    want = float(JS.ssim(jnp.asarray(x), jnp.asarray(y), win=win))
    assert got == pytest.approx(want, abs=1e-5)
    per = TS.ssim_per_image(torch.from_numpy(x), torch.from_numpy(y), win=win)
    np.testing.assert_allclose(per.numpy(), np.asarray(JS.ssim_per_image(
        jnp.asarray(x), jnp.asarray(y), win=win)), atol=1e-5, rtol=0)
    assert float(TS.ssim(torch.from_numpy(x), torch.from_numpy(x),
                         win=win)) == pytest.approx(1.0, abs=1e-5)


def _np_params(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for layer, leaves in V.vgg_defs(cfg).items():
        w = leaves["w"].shape
        out[layer] = {
            "w": (rng.normal(size=w) / np.sqrt(np.prod(w[:-1]))).astype(
                np.float32),
            "b": (rng.normal(size=leaves["b"].shape) * 0.1).astype(np.float32)}
    return out


@pytest.fixture(scope="module", params=["vgg16", "vgg19"])
def profiles(request):
    name = request.param
    cfg, jcfg = get_smoke(name), jget_smoke(name)
    npp = _np_params(cfg, seed=len(name))
    tl = TP.leakage_profile(V.params_from_numpy(npp, "cpu"), cfg,
                            n_images=2)
    jl = JP.leakage_profile(jax.tree.map(jnp.asarray, npp), jcfg,
                            n_images=2)
    return cfg, jcfg, tl, jl


def test_leakage_profile_matches_reference(profiles):
    cfg, _, tl, jl = profiles
    assert set(tl) == set(jl) == set(range(1, len(cfg.cnn_layers)))
    for p in tl:
        assert tl[p] == pytest.approx(jl[p], abs=LEAK_ATOL), p
        assert 0.0 <= tl[p] <= 1.0
    fc = cfg.cnn_layers.index(next(s for s in cfg.cnn_layers
                                   if s.startswith("fc"))) + 1
    assert tl[fc] == tl[fc - 1]              # fc: fail-closed carry


_FLOORS = (0.95, 0.6, 0.35, 0.2, 0.1, 0.01)


@pytest.mark.parametrize("floor", _FLOORS)
def test_planner_picks_the_reference_partition(profiles, floor):
    cfg, jcfg, tl, jl = profiles
    # the proxy's tolerance cannot move any boundary across this floor
    assert all(abs(v - floor) > LEAK_ATOL for v in jl.values())
    got = TP.PartitionPlanner(privacy_floor=floor).plan(cfg, leakage=tl)
    want = JP.PartitionPlanner(privacy_floor=floor).plan(jcfg, leakage=jl)
    assert (got.partition, got.feasible, got.source) == \
        (want.partition, want.feasible, want.source)
    assert got.runtime_s == want.runtime_s
    assert got.to_placement(cfg).digest == want.to_placement(jcfg).digest
    choice = TP.PartitionPlanner(privacy_floor=floor).placement_plan(
        cfg, leakage=tl, verify=TIG.IntegrityPolicy.full(1))
    jchoice = JP.PartitionPlanner(privacy_floor=floor).placement_plan(
        jcfg, leakage=jl, verify=repro.core.integrity.IntegrityPolicy.full(1))
    assert choice.plan.digest == jchoice.plan.digest
    assert choice.runtime_s == jchoice.runtime_s


def test_planner_with_params_runs_the_proxy():
    cfg, jcfg = get_smoke("vgg16"), jget_smoke("vgg16")
    npp = _np_params(cfg, 1)
    got = TP.PartitionPlanner(n_images=2).plan(
        cfg, V.params_from_numpy(npp, "cpu"))
    want = JP.PartitionPlanner(n_images=2).plan(
        jcfg, jax.tree.map(jnp.asarray, npp))
    assert (got.partition, got.feasible) == (want.partition, want.feasible)
    assert got.summary().split(" leakage")[0] == \
        want.summary().split(" leakage")[0]


def test_planner_fallbacks_match_reference():
    for name, kws in (("smollm_135m", ({}, {"partition": 2})),
                      ("vgg16", ({"partition": 2}, {"mode": "slalom"},
                                 {"mode": "enclave"}))):
        for kw in kws:
            got = TP.PartitionPlanner().plan(get_smoke(name), None, **kw)
            want = JP.PartitionPlanner().plan(jget_smoke(name), None, **kw)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("leak", [
    {1: 0.8, 2: 0.2, 3: 0.7, 4: 0.3, 5: 0.2, 6: 0.1, 7: 0.05},
    {p: 0.9 for p in range(1, 8)}, {p: 0.0 for p in range(1, 8)}],
    ids=["nonmonotone", "nothing-safe", "all-safe"])
def test_planner_on_synthetic_leakage(leak):
    cfg, jcfg = get_smoke("vgg16"), jget_smoke("vgg16")
    for floor in (0.9, 0.6, 0.35, 0.15, 0.06):
        got = TP.PartitionPlanner(privacy_floor=floor).plan(cfg, leakage=leak)
        want = JP.PartitionPlanner(privacy_floor=floor).plan(jcfg,
                                                             leakage=leak)
        assert (got.partition, got.feasible) == (want.partition,
                                                 want.feasible)
        tplan = TPL.from_string(cfg, "bbvvoooo", boundary=2)
        assert TP.plan_leakage(leak, tplan) == JP.plan_leakage(
            leak, JPL.from_string(jcfg, "bbvvoooo", boundary=2))


@pytest.mark.parametrize("arch", ["vgg16", "vgg19"])
@pytest.mark.parametrize("device", ["gpu", "cpu"])
def test_enclave_sim_runtimes_equal_reference(arch, device):
    cfg, jcfg = get_config(arch), jget_config(arch)
    tsim = TTR.EnclaveSim(cfg, device=device)
    jsim = JTR.EnclaveSim(jcfg, device=device)
    assert [dataclasses.astuple(l) for l in tsim.layers] == \
        [dataclasses.astuple(l) for l in jsim.layers]
    for p in range(0, len(cfg.cnn_layers) + 1, 3):
        assert {m: dataclasses.astuple(c) for m, c in
                tsim.all_strategies(p).items()} == \
            {m: dataclasses.astuple(c) for m, c in
             jsim.all_strategies(p).items()}
    for spec in ("b" * 6, "bbbeee", "bbvvvo", "eeebbb", "oooooo"):
        spec = spec + "o" * (len(cfg.cnn_layers) - 6)
        tplan, jplan = TPL.from_string(cfg, spec), JPL.from_string(jcfg, spec)
        assert dataclasses.astuple(tsim.plan_runtime(tplan)) == \
            dataclasses.astuple(jsim.plan_runtime(jplan))
        assert tsim._plan_quantities(tplan) == jsim._plan_quantities(jplan)


_COSTS = {"device_flops": 2e-12, "blind_bytes": 5e-10,
          "unblind_bytes": 7e-10, "dispatches": 3e-5}


def _obs(scale):
    q = {"device_flops": 1e9 * scale, "blind_bytes": 1e6 * scale,
         "unblind_bytes": 1e6 * scale, "dispatches": 8.0 * scale}
    t = {phase: _COSTS[feat] * q[feat]
         for phase, feat in TTR.CalibratedCostModel.PHASE_FEATURES.items()
         if feat in _COSTS}
    return q, t


def test_calibration_equals_reference():
    for device in ("gpu", "cpu"):
        tm = TTR.CalibratedCostModel(device=device)
        jm = JTR.CalibratedCostModel(device=device)
        for m in (tm, jm):
            m.observe_all([_obs(s) for s in (0.5, 1.0, 2.0)])
        assert tm.unit_costs == jm.unit_costs
        assert dataclasses.astuple(tm.fit()) == dataclasses.astuple(jm.fit())
        assert tm.gauges() == jm.gauges()

    class Stub:
        def cost_observations(self):
            return [_obs(1.0), _obs(2.0)]

    tp, jp = TP.PartitionPlanner(), JP.PartitionPlanner()
    for src in (Stub(),):
        assert dataclasses.astuple(tp.calibrate(src)) == \
            dataclasses.astuple(jp.calibrate(src))
    explicit = TTR.EnclaveParams(cpu_flops=5e10)
    assert tp.calibrate(explicit) is explicit
    leak = {p: 0.0 for p in range(1, 8)}
    cfg, jcfg = get_smoke("vgg16"), jget_smoke("vgg16")
    jp.calibrate(JTR.EnclaveParams(cpu_flops=5e10))
    assert tp.plan(cfg, leakage=leak).runtime_s == \
        jp.plan(jcfg, leakage=leak).runtime_s
