"""The port's mixture-of-experts layer (models/moe.py) against the JAX
reference on the CPU, on the same numpy inputs and parameters.

- ``moe_forward`` under the three dispatches on the Qwen3-MoE smoke
  config: float32 parameters within rtol 1e-5 (both sides compute in
  float32, in other summation orders), bf16 within 3e-2 * max|ref| (the
  bf16 tolerance of tests/test_torch_lm.py);
- ``_route``: the same experts, weights and aux within 1e-6, on the rows
  whose k-th and (k+1)-th router probabilities differ by more than 1e-6
  (a closer pair may order differently after a float32 rounding; none
  occurs at these seeds, which the test pins);
- ``_capacity``, the parameter counts, ``to_json`` and the enclave
  measurement of both MoE configs equal to the reference's;
- the reference's own behaviour tests (tests/test_moe.py) rerun on the
  port, and the port's grouped dispatch bit-equal to its per-group one.
"""
import dataclasses

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ALIASES as JALIASES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.core.attestation import measure_enclave as jmeasure  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch.configs import ALIASES, get_config, get_smoke  # noqa: E402
from repro_torch.core.attestation import measure_enclave  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402

ARCHS = ("qwen3_moe_235b", "arctic_480b")
DISPATCHES = ("gshard", "sorted", "sorted_grouped")
F32_RTOL = 1e-5
BF16_TOL = 3e-2
ROUTE_TOL = 1e-6


def _cfgs(arch="qwen3_moe_235b", **moe):
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    return (cfg.replace(moe=dataclasses.replace(cfg.moe, **moe)),
            jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe)))


def _params(cfg, jcfg, dtype=jnp.float32, seed=0):
    """The reference's MoE parameters and the same values as tensors, each
    in its definition's dtype (the router float32)."""
    jp = JL.init_params(jax.random.PRNGKey(seed), JMOE.moe_defs(jcfg), dtype)

    def walk(node, defs):
        if L.is_def(defs):
            t = torch.from_numpy(np.array(node, np.float32))
            return t.to(defs.dtype or M.torch_dtype(jnp.dtype(dtype).name))
        return {k: walk(node[k], defs[k]) for k in defs}

    return jp, walk(jp, MOE.moe_defs(cfg))


def _x(shape, d, seed=1):
    return np.random.default_rng(seed).normal(size=shape + (d,)).astype(
        np.float32)


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_float32_matches_reference(arch, dispatch):
    cfg, jcfg = _cfgs(arch, dispatch=dispatch)
    jp, params = _params(cfg, jcfg)
    x = _x((2, 64), cfg.d_model)
    y, aux = MOE.moe_forward(params, torch.from_numpy(x), cfg)
    jy, jaux = JMOE.moe_forward(jp, jnp.asarray(x), jcfg)
    want = np.asarray(jy)
    assert y.dtype == torch.float32 and y.shape == want.shape
    np.testing.assert_allclose(y.numpy(), want, rtol=F32_RTOL,
                               atol=F32_RTOL * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=F32_RTOL)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_forward_bf16_matches_reference(dispatch):
    cfg, jcfg = _cfgs(dispatch=dispatch)
    jp, params = _params(cfg, jcfg, jnp.bfloat16)
    assert params["router"]["w"].dtype == torch.float32
    assert params["w_gate"].dtype == torch.bfloat16
    x = _x((2, 64), cfg.d_model)
    y, aux = MOE.moe_forward(params, torch.from_numpy(x).to(torch.bfloat16),
                             cfg)
    jy, jaux = JMOE.moe_forward(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    want = np.asarray(jy, np.float32)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), want, rtol=0,
                               atol=BF16_TOL * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_matches_reference(seed):
    cfg, jcfg = _cfgs()
    jp, params = _params(cfg, jcfg, seed=seed)
    x = _x((256,), cfg.d_model, seed=seed + 10)
    w, e, aux = MOE._route(params, torch.from_numpy(x), cfg)
    jw, je, jaux = JMOE._route(jp, jnp.asarray(x), jcfg)
    k = cfg.moe.top_k
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jp["router"]["w"],
                                      axis=-1))
    top = -np.sort(-probs, axis=-1)
    clear = top[:, k - 1] - top[:, k] > ROUTE_TOL
    # at these seeds no row's k-th and (k+1)-th choices are that close
    assert clear.all(), int((~clear).sum())
    np.testing.assert_array_equal(e.numpy()[clear], np.asarray(je)[clear])
    np.testing.assert_allclose(w.numpy()[clear], np.asarray(jw)[clear],
                               rtol=0, atol=ROUTE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0,
                               atol=ROUTE_TOL)


def test_route_orders_ties_as_top_k():
    """lax.top_k puts the lower expert first on a tie: so does the port."""
    cfg, _ = _cfgs()
    E = cfg.moe.num_experts
    params = {"router": {"w": torch.zeros((cfg.d_model, E))}}
    w, e, _ = MOE._route(params, torch.ones((3, cfg.d_model)), cfg)
    jw, je = jax.lax.top_k(jnp.full((3, E), 1.0 / E), cfg.moe.top_k)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(w.numpy(), 1.0 / cfg.moe.top_k)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_reference(arch):
    for getter, jgetter in ((get_smoke, jget_smoke),
                            (get_config, jget_config)):
        cfg, jcfg = getter(arch), jgetter(arch)
        for cf in (0.25, 1.0, 1.25, 8.0, 16.0):
            c = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                    capacity_factor=cf))
            jc = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                      capacity_factor=cf))
            for t in (1, 2, 7, 16, 33, 128, 1000, 4096):
                assert MOE._capacity(t, c) == JMOE._capacity(t, jc), (t, cf)


def test_sorted_equals_gshard_when_no_drops():
    """The reference's behaviour test on the port: with capacity above
    the token count, both dispatchers compute the same function."""
    cfg_g, _ = _cfgs(dispatch="gshard", capacity_factor=16.0)
    cfg_s, _ = _cfgs(dispatch="sorted", capacity_factor=16.0)
    _, params = _params(cfg_g, _cfgs()[1])
    x = torch.from_numpy(_x((2, 16), cfg_g.d_model, seed=5))
    yg, auxg = MOE.moe_forward(params, x, cfg_g)
    ys, auxs = MOE.moe_forward(params, x, cfg_s)
    np.testing.assert_allclose(yg.numpy(), ys.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(auxg), float(auxs), rtol=1e-5)


def test_capacity_drop_reduces_output_norm():
    cfg_full, jcfg = _cfgs(dispatch="sorted", capacity_factor=16.0)
    cfg_tight, _ = _cfgs(dispatch="sorted", capacity_factor=0.25)
    _, params = _params(cfg_full, jcfg)
    x = torch.from_numpy(_x((1, 64), cfg_full.d_model, seed=6))
    y_full, _ = MOE.moe_forward(params, x, cfg_full)
    y_tight, _ = MOE.moe_forward(params, x, cfg_tight)
    assert float(torch.linalg.norm(y_tight)) < float(torch.linalg.norm(y_full))


def test_router_weights_normalized():
    cfg, jcfg = _cfgs()
    _, params = _params(cfg, jcfg)
    x = torch.from_numpy(_x((32,), cfg.d_model, seed=7))
    w, _, aux = MOE._route(params, x, cfg)
    np.testing.assert_allclose(torch.sum(w, -1).numpy(), 1.0, rtol=1e-5)
    assert float(aux) >= 1.0 - 1e-3     # >= 1 at uniformity (Cauchy-Schwarz)


def test_dense_residual_arctic_matches_reference():
    """Arctic's dense-residual FFN: knocking it out changes the output, and
    the output with it equals the reference's."""
    cfg, jcfg = _cfgs("arctic_480b")
    jp, params = _params(cfg, jcfg)
    x = _x((2, 8), cfg.d_model, seed=8)
    y, _ = MOE.moe_forward(params, torch.from_numpy(x), cfg)
    knocked = dict(params)
    knocked["dense_residual"] = {k: {"w": torch.zeros_like(v["w"])}
                                 for k, v in params["dense_residual"].items()}
    y2, _ = MOE.moe_forward(knocked, torch.from_numpy(x), cfg)
    assert not np.allclose(y.numpy(), y2.numpy())
    want = np.asarray(JMOE.moe_forward(jp, jnp.asarray(x), jcfg)[0])
    np.testing.assert_allclose(y.numpy(), want, rtol=F32_RTOL,
                               atol=F32_RTOL * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_dispatch_equals_per_group_dispatch(dtype):
    """One batched dispatch over the groups gives each group what the
    sorted dispatch of that group alone gives, bit for bit, and two runs
    agree bit for bit (no atomics)."""
    cfg, jcfg = _cfgs(dispatch="sorted_grouped")
    _, params = _params(cfg, jcfg)
    params = {k: (v if k == "router" else v.to(dtype))
              for k, v in params.items()}
    x = torch.from_numpy(_x((4 * 32,), cfg.d_model, seed=9)).to(dtype)
    y, aux = MOE._dispatch_sorted_grouped(params, x, cfg)
    parts = [MOE._dispatch_sorted(params, xg, cfg) for xg in x.reshape(
        32, 4, cfg.d_model)]
    assert torch.equal(y, torch.cat([p[0] for p in parts]))
    assert torch.equal(aux, torch.mean(torch.stack([p[1] for p in parts])))
    y2, _ = MOE._dispatch_sorted_grouped(params, x, cfg)
    assert torch.equal(y, y2)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    """From the definitions alone: nothing is allocated."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert M.count_params_analytic(cfg) == JM.count_params_analytic(jcfg)
    assert M.active_params_analytic(cfg) == JM.active_params_analytic(jcfg)
    smoke, jsmoke = get_smoke(arch), jget_smoke(arch)
    assert M.count_params_analytic(smoke) == JM.count_params_analytic(jsmoke)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_json_matches_reference(arch):
    for getter, jgetter in ((get_smoke, jget_smoke),
                            (get_config, jget_config)):
        assert getter(arch).to_json() == jgetter(arch).to_json()
    aliases = {k: v for k, v in JALIASES.items() if v == arch}
    assert aliases and all(ALIASES[k] == v for k, v in aliases.items())


@pytest.mark.parametrize("arch", ARCHS)
def test_measure_enclave_matches_reference(arch):
    """The enclave measurement of a MoE model's bf16 weights (router
    float32) equals the reference's: the config JSON and every leaf's
    bytes."""
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    rng = np.random.default_rng(3)

    def leaf(d):
        a = rng.normal(size=d.shape).astype(np.float32)
        return jnp.asarray(a, jnp.dtype(str(d.dtype or cfg.dtype)
                                         .removeprefix("torch.")))

    def walk(defs):
        if L.is_def(defs):
            return leaf(defs)
        return {k: walk(defs[k]) for k in defs}

    jp = walk(M.model_defs(cfg))
    params = M.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert params["blocks"]["moe"]["router"]["w"].dtype == torch.float32
    assert params["blocks"]["moe"]["w_up"].shape == (
        cfg.num_layers, cfg.moe.num_experts, cfg.d_model,
        cfg.moe.d_ff_expert)
    p = cfg.origami.tier1_layers
    got = measure_enclave(cfg, params, p)
    want = jmeasure(jcfg, jp, p)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_init_params_keeps_router_float32_and_expert_fan_in():
    """``init_params`` of a bf16 MoE model: the router stays float32 and
    the stacked expert banks (L, E, d, f) take 1/sqrt(d) (the "layers"
    and "experts" axes are not fan-in)."""
    cfg = get_config("qwen3_moe_235b").replace(
        num_layers=2, d_model=256, moe=dataclasses.replace(
            get_config("qwen3_moe_235b").moe, num_experts=16,
            d_ff_expert=64))
    params = M.init_params(cfg, 0, device="cpu")
    moe = params["blocks"]["moe"]
    assert moe["router"]["w"].dtype == torch.float32
    assert moe["w_gate"].dtype == torch.bfloat16
    assert moe["w_gate"].shape == (2, 16, 256, 64)
    assert moe["w_down"].shape == (2, 16, 64, 256)
    for name, fan_in in (("w_gate", 256), ("w_down", 64)):
        std = float(moe[name].float().std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.02, (name, std)
