"""The port's device meshes on the CPU: real multi-rank runs over gloo, and
the JAX reference over fake XLA devices, on the same numpy inputs.

Each multi-rank case runs its ranks as subprocesses over a ``FileStore``
under ``tmp_path`` (a process group is per process, and the test process
keeps none); the reference runs through ``tests/_subproc.py``'s fake
devices.

- the SmolLM smoke config with float32 weights trained 3 steps on a (2, 2)
  mesh of four gloo ranks (batch and parameters sharded: FSDP over "data",
  tensor parallel over "model") against the port's one-rank run, which
  the reference already holds: losses within 1e-5 relative and the first
  step's gradients within 1e-5 relative Frobenius a leaf (other summation
  orders over the shards, nothing else);
- the same run with the smoke config windowed (window 5) against the
  reference's mesh run of it; in both, each rank's local flash forward
  and backward (spied, every keyword passed on) at its query shard's
  offset: the query's sequence lies over "model", the reference's
  context-parallel "flash_seq" layout;
- ``sdpa`` of DTensors under the train plan's rules: each rank's call at
  its shard's offset plus the caller's, the results equal to one rank's;
  a length that "model" does not divide keeps the query whole there;
- ``train(mesh=make_host_mesh(1, 1))`` bit-equal to the mesh-less
  trainer, the one-rank group it starts, and a mesh larger than the world
  refused with the world size;
- ``compressed_psum`` over four ranks bit-equal to the reference's
  ``shard_map`` psum over four devices;
- a checkpoint saved over four ranks loads over two, bit-equal, and one
  the reference saved sharded over four fake devices loads over two;
- ``remesh``: the reference's ``test_remesh_on_fake_cpu_devices`` cases,
  on the ranks of a fake group of 8.
"""
import subprocess
import sys
import textwrap
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from tests._subproc import check  # noqa: E402

SRC = str(Path(__file__).resolve().parent.parent / "src")
REL = 1e-5
REL_REF = 1e-5                   # against the reference's mesh run
SHAPE = (16, 32)                 # (batch, tokens): 16 rows shard over "data"
TCFG = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)

PRELUDE = f"""
import sys, warnings
sys.path.insert(0, {SRC!r})
warnings.filterwarnings("ignore")
import torch, torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD, STORE, OUT = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
"""
INIT = """
dist.init_process_group("gloo", store=dist.FileStore(STORE, WORLD),
                        rank=RANK, world_size=WORLD)
"""


def run_ranks(code: str, world: int, tmp_path: Path, init: bool = True,
              timeout: int = 240) -> Path:
    """Run ``code`` on ``world`` ranks (a gloo group over a FileStore when
    ``init``), each a subprocess; -> the directory they write to."""
    tag = uuid.uuid4().hex[:8]
    script = tmp_path / f"ranks_{tag}.py"
    script.write_text(PRELUDE + (INIT if init else "")
                      + textwrap.dedent(code)
                      # no rank tears its group down while a peer may
                      # still be finishing a collective with it
                      + "\nif dist.is_initialized():\n"
                        "    dist.barrier()\n"
                        "    dist.destroy_process_group()\n")
    out = tmp_path / f"out_{tag}"
    out.mkdir()
    store = tmp_path / f"store_{tag}"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(store),
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    try:
        results = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (o, e)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, f"rank {r}:\n{o[-2000:]}\n{e[-4000:]}"
    return out


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


def _smoke():
    return get_smoke("smollm_135m").replace(dtype="float32")


def _batch(cfg):
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, SHAPE[1], SHAPE[0],
                                    seed=0))
    return {"tokens": torch.from_numpy(pipe.batch(0)["tokens"])}


SMOKE = dict(dtype="float32")
WINDOWED = dict(dtype="float32", attention="windowed", window_size=5)


def _sharded_train(cfg_kw) -> str:
    """The (2, 2) gloo ranks' 3 ``train(mesh=)`` steps and first-step
    gradients of the SmolLM smoke config replaced by ``cfg_kw``, each
    rank's flash calls (rows, ``q_offset``, window) recorded by spies that
    pass every keyword on."""
    return f"""
from repro_torch.configs import get_smoke
from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
from repro_torch.core.tree import tree_map, tree_leaves
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import steps as S
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel.sharding import distribute, make_plan
from repro_torch.models import attention as A
cfg = get_smoke("smollm_135m").replace(**{cfg_kw!r})
tcfg = TrainConfig(**{TCFG!r})
B, L = {SHAPE!r}
mesh = make_host_mesh(2, 2, device_type="cpu")
_, _, losses = T.train(cfg, tcfg, batch=B, seq=L, steps=3, mesh=mesh,
                       log_every=0)
params, _ = T.init_train_state(cfg, tcfg, "cpu")
plan = make_plan(cfg, ShapeConfig("custom", "train", L, B), mesh,
                 MeshConfig(), "train")
pipe = TokenPipeline(DataConfig(cfg.vocab_size, L, B, seed=0))
batch = {{"tokens": torch.from_numpy(pipe.batch(0)["tokens"])}}
dp = distribute(params, plan.param_shardings(cfg))
db = distribute(batch, plan.batch_shardings(cfg, "train"))
calls, fwd, bwd = [], A.flash_attention_fwd, A.flash_attention_bwd


def spy_fwd(q, k, v, **kw):
    calls.append(("fwd", q.shape[1], kw.get("q_offset"), kw.get("window")))
    return fwd(q, k, v, **kw)


def spy_bwd(q, *args, **kw):
    calls.append(("bwd", q.shape[1], kw.get("q_offset"), kw.get("window")))
    return bwd(q, *args, **kw)


A.flash_attention_fwd, A.flash_attention_bwd = spy_fwd, spy_bwd
with T._mesh_scope(plan, mesh):
    g, ce = S.loss_grads(dp, db, cfg)
A.flash_attention_fwd, A.flash_attention_bwd = fwd, bwd
torch.save({{"calls": calls, "coord": mesh.get_coordinate()}},
           OUT + f"/calls_{{RANK}}.pt")
full = tree_map(lambda t: t.full_tensor(), g)
if RANK == 0:
    torch.save({{"losses": losses, "grads": full,
                "batch_axes": plan.batch_axes,
                "placements": sorted({{str(t.placements)
                                       for t in tree_leaves(dp)}}),
                "tokens": str(db["tokens"].placements)}},
               OUT + "/mesh.pt")
"""


def _ref_sharded_train(cfg_kw) -> str:
    """The reference's ``train(mesh=)`` and first-step gradients of the
    same config on a (2, 2) mesh of four fake XLA devices."""
    return f"""
import pickle
import jax, numpy as np
from repro.configs import get_smoke
from repro.configs.base import MeshConfig, ShapeConfig, TrainConfig
from repro.data.pipeline import DataConfig, TokenPipeline
from repro.launch import train as JT
from repro.launch.mesh import make_host_mesh
from repro.models import model as M
from repro.parallel.act_sharding import activation_rules
from repro.parallel.sharding import make_plan
cfg = get_smoke("smollm_135m").replace(**{cfg_kw!r})
tcfg = TrainConfig(**{TCFG!r})
B, L = {SHAPE!r}
mesh = make_host_mesh(2, 2)
_, _, losses = JT.train(cfg, tcfg, batch=B, seq=L, steps=3, mesh=mesh,
                        log_every=0)
plan = make_plan(cfg, ShapeConfig("custom", "train", L, B), mesh,
                 MeshConfig(), "train")
params = jax.device_put(M.init_params(cfg, jax.random.PRNGKey(tcfg.seed)),
                        plan.param_shardings(cfg))
pipe = TokenPipeline(DataConfig(cfg.vocab_size, L, B, seed=0))
batch = jax.device_put({{"tokens": pipe.batch(0)["tokens"]}},
                       plan.batch_shardings(cfg, "train"))
with mesh, activation_rules(plan.act_rules):
    g = jax.jit(jax.grad(lambda p, b: M.loss_fn(p, b, cfg)[0]))(params, batch)
with open(sys.argv[1], "wb") as f:
    pickle.dump({{"losses": losses,
                 "grads": jax.tree.map(lambda a: np.asarray(a, np.float32),
                                       g)}}, f)
"""


def _load_run(out: Path):
    got = torch.load(out / "mesh.pt")
    got["ranks"] = [torch.load(out / f"calls_{r}.pt") for r in range(4)]
    return got


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """The (2, 2) gloo ranks' losses, first-step gradients, layouts and
    flash calls."""
    tmp = tmp_path_factory.mktemp("sharded")
    return _load_run(run_ranks(_sharded_train(SMOKE), 4, tmp))


@pytest.fixture(scope="module")
def windowed_run(tmp_path_factory):
    """The same with the smoke config windowed (window 5)."""
    tmp = tmp_path_factory.mktemp("windowed")
    return _load_run(run_ranks(_sharded_train(WINDOWED), 4, tmp))


def test_sharded_training_matches_one_rank(sharded_run):
    got = sharded_run
    # the plan shards the batch over "data" and parameters over both axes
    assert got["batch_axes"] == ("data",)
    assert got["tokens"] == "(Shard(dim=0), Replicate())"
    assert any("Shard" in p.split(",")[0] and "Shard" in p.split(",")[1]
               for p in got["placements"]), got["placements"]
    cfg = _smoke()
    tcfg = TrainConfig(**TCFG)
    _, _, want = T.train(cfg, tcfg, batch=SHAPE[0], seq=SHAPE[1], steps=3,
                         device="cpu", log_every=0)
    for a, b in zip(got["losses"], want):
        assert abs(a - b) <= REL * abs(b), (got["losses"], want)
    params, _ = T.init_train_state(cfg, tcfg, "cpu")
    g, _ = S.loss_grads(params, _batch(cfg), cfg)
    gaps = [_rel(a, b) for a, b in zip(tree_leaves(got["grads"]),
                                       tree_leaves(g))]
    assert max(gaps) <= REL, gaps


def _matches_reference_mesh(got, cfg_kw, tmp_path):
    import pickle
    from repro_torch.models import model as M
    ref = tmp_path / "ref.pkl"
    check("import sys\nsys.argv[1:] = [" + repr(str(ref)) + "]\n"
          + _ref_sharded_train(cfg_kw), n_devices=4)
    with open(ref, "rb") as f:
        want = pickle.load(f)
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= REL_REF * abs(b), (got["losses"],
                                                want["losses"])
    cfg = get_smoke("smollm_135m").replace(**cfg_kw)
    g = M.params_from_numpy(want["grads"], cfg, device="cpu")
    gaps = [_rel(a, b) for a, b in zip(tree_leaves(got["grads"]),
                                       tree_leaves(g))]
    assert max(gaps) <= REL_REF, gaps


def test_sharded_training_matches_reference_mesh(sharded_run, tmp_path):
    """The same run against the reference's ``train(mesh=)`` and its
    first-step gradients on a (2, 2) mesh of four fake XLA devices."""
    _matches_reference_mesh(sharded_run, SMOKE, tmp_path)


def test_windowed_sharded_training_matches_reference_mesh(windowed_run,
                                                          tmp_path):
    """A windowed smoke SmolLM (window 5 against 32-token rows) trained on
    the (2, 2) gloo mesh, each rank's query shard at its own offset,
    against the reference's mesh run of the same config."""
    _matches_reference_mesh(windowed_run, WINDOWED, tmp_path)


@pytest.mark.parametrize("run,window", [("sharded_run", 0),
                                        ("windowed_run", 5)])
def test_each_rank_attends_at_its_own_query_offset(run, window, request):
    """The query's sequence lies over "model" (the reference's
    "flash_seq"): each rank's local flash forward and backward take its
    16 of the 32 rows at offset 16 x its "model" coordinate, the window
    passed through, in every one of the smoke model's 4 blocks (the
    forward twice a block under remat)."""
    for got in request.getfixturevalue(run)["ranks"]:
        off = SHAPE[1] // 2 * got["coord"][1]
        want = [("fwd", 16, off, window)] * 4 + [("fwd", 16, off, window),
                                                  ("bwd", 16, off, window)] * 4
        assert sorted(got["calls"]) == sorted(want), (got["coord"],
                                                      got["calls"])


SDPA_SHARDS = """
import numpy as np
from torch.distributed.tensor import Replicate, distribute_tensor
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention as A
from repro_torch.parallel import act_sharding as ash
mesh = make_host_mesh(2, 2, device_type="cpu")
rules = {"batch": ("data",), "seq": None, "flash_seq": "model"}
calls, fwd = [], A.flash_attention_fwd


def spy(q, k, v, **kw):
    calls.append((q.shape[1], kw.get("q_offset")))
    return fwd(q, k, v, **kw)


A.flash_attention_fwd = spy
rep = [Replicate(), Replicate()]
out = {"coord": mesh.get_coordinate(), "cases": {}}
for Sq, off, window in ((32, 0, 5), (31, 0, 5), (24, 8, 0), (24, 8, 4)):
    rng = np.random.default_rng(Sq + off + window)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                     for s in ((4, Sq, 6, 32), (4, Sq + off, 2, 32),
                               (4, Sq + off, 2, 32), (4, Sq, 6, 32)))
    full = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = A.sdpa(*full, causal=True, q_offset=off, window=window)
    gwant = torch.autograd.grad(want, full, dout)
    dts = [distribute_tensor(t, mesh, rep).requires_grad_(True)
           for t in (q, k, v)]
    calls.clear()
    with ash.activation_rules(rules, {"data": 2, "model": 2}, mesh):
        got = A.sdpa(*dts, causal=True, q_offset=off, window=window)
        grads = torch.autograd.grad(got, dts,
                                    distribute_tensor(dout, mesh, rep))
    out["cases"][(Sq, off, window)] = {
        "calls": list(calls), "placements": str(got.placements),
        "out": (got.full_tensor() - want).abs().max().item(),
        "grads": [((g.full_tensor() - w).norm() / w.norm()).item()
                  for g, w in zip(grads, gwant)]}
torch.save(out, OUT + f"/sdpa_{RANK}.pt")
"""


def test_sdpa_query_shards_take_their_offsets(tmp_path):
    """``sdpa`` of DTensors under the train plan's rules on the (2, 2)
    gloo mesh: the query's 32 (or 24) rows over "model", each rank's
    local call at its shard's global offset plus the caller's, the output
    laid out by batch alone and equal to the one-rank result (1e-6), dq,
    dk and dv
    (dk and dv summed over the shards) within 1e-6 relative Frobenius.
    31 rows do not divide over "model": the query stays whole there and
    every rank attends all 31 rows at the caller's offset."""
    out = run_ranks(SDPA_SHARDS, 4, tmp_path)
    for r in range(4):
        got = torch.load(out / f"sdpa_{r}.pt")
        m = got["coord"][1]
        for (Sq, off, window), res in got["cases"].items():
            split = Sq % 2 == 0
            rows = Sq // 2 if split else Sq
            assert res["calls"] == [(rows, off + (rows * m if split
                                                  else 0))], res["calls"]
            assert res["placements"] == "(Shard(dim=0), Replicate())"
            assert res["out"] <= 1e-6 and max(res["grads"]) <= 1e-6, res


ONE_BY_ONE = f"""
from repro_torch.configs import get_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import train as T
from repro_torch.launch.mesh import end_local_group, make_host_mesh
cfg = get_smoke("smollm_135m")
tcfg = TrainConfig(**{TCFG!r})
assert not dist.is_initialized()
mesh = make_host_mesh(1, 1, device_type="cpu")
assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
try:
    make_host_mesh(2, 1, device_type="cpu")
    raise AssertionError("a 2 x 1 mesh over one rank was built")
except ValueError as e:
    assert "world size is 1" in str(e), e
p0, o0, l0 = T.train(cfg, tcfg, batch=4, seq=32, steps=3, device="cpu",
                     log_every=0)
p1, o1, l1 = T.train(cfg, tcfg, batch=4, seq=32, steps=3, mesh=mesh,
                     log_every=0)
assert l0 == l1, (l0, l1)
for a, b in zip(tree_leaves(p0) + tree_leaves(o0.mu) + tree_leaves(o0.nu),
                tree_leaves(p1) + tree_leaves(o1.mu) + tree_leaves(o1.nu)):
    assert torch.equal(a, b.to_local())
assert int(o0.step) == int(o1.step.to_local())
end_local_group()
assert not dist.is_initialized()
open(OUT + "/ok", "w").write("ok")
"""


def test_one_by_one_mesh_is_bit_equal_and_starts_its_group(tmp_path):
    out = run_ranks(ONE_BY_ONE, 1, tmp_path, init=False)
    assert (out / "ok").read_text() == "ok"


def _psum_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4 * 8, 16)).astype(np.float32)
    return x * np.repeat(np.array([1.0, 3.0, 0.25, 7.0], np.float32), 8)[
        :, None]


def test_compressed_psum_matches_reference_shard_map(tmp_path):
    x = _psum_inputs()
    np.save(tmp_path / "x.npy", x)
    ref = tmp_path / "ref.npy"
    check(f"""
        import jax, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.launch.mesh import _axis_types_kwargs
        from repro.parallel.compression import compressed_psum
        mesh = jax.make_mesh((4,), ("data",), **_axis_types_kwargs(1))
        f = jax.shard_map(lambda b: compressed_psum(b, "data"), mesh=mesh,
                          in_specs=P("data"), out_specs=P("data"))
        x = np.load({str(tmp_path / "x.npy")!r})
        np.save({str(ref)!r}, np.asarray(jax.jit(f)(x)))
    """, n_devices=4)
    out = run_ranks("""
        import numpy as np
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel import compression as GC
        from repro_torch.parallel.act_sharding import activation_rules
        x = np.load(OUT + "/../x.npy")
        mesh = make_mesh((4, 1), ("data", "model"), "cpu")
        mine = torch.from_numpy(x[RANK * 8:(RANK + 1) * 8].copy())
        got = GC.compressed_psum(mine, "data", mesh=mesh)
        with activation_rules({}, mesh=mesh):     # the active mesh
            again = GC.compressed_psum(mine, "data")
        assert torch.equal(got, again)
        np.save(OUT + f"/rank{RANK}.npy", got.numpy())
    """, 4, tmp_path)
    want = np.load(ref)
    for r in range(4):
        got = np.load(out / f"rank{r}.npy")
        np.testing.assert_array_equal(got, want[r * 8:(r + 1) * 8])


def test_checkpoint_saved_over_four_ranks_loads_over_two(tmp_path):
    ckpt = tmp_path / "ckpt"
    run_ranks(f"""
        from repro_torch.configs import get_smoke
        from repro_torch.configs.base import (MeshConfig, ShapeConfig,
                                              TrainConfig)
        from repro_torch.launch import train as T
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.parallel.sharding import distribute, make_plan
        from repro_torch.runtime.checkpoint import AsyncCheckpointer
        cfg = get_smoke("smollm_135m")
        tcfg = TrainConfig()
        mesh = make_host_mesh(2, 2, device_type="cpu")
        plan = make_plan(cfg, ShapeConfig("c", "train", 32, 16), mesh,
                         MeshConfig(), "train")
        state = T.init_train_state(cfg, tcfg, "cpu")
        state = distribute(state, (plan.param_shardings(cfg),
                                   plan.opt_shardings(cfg)))
        ac = AsyncCheckpointer({str(ckpt)!r})
        ac.save(3, state, meta={{"ranks": WORLD}})
        ac.wait()
    """, 4, tmp_path)
    out = run_ranks(f"""
        from repro_torch.configs import get_smoke
        from repro_torch.configs.base import (MeshConfig, ShapeConfig,
                                              TrainConfig)
        from repro_torch.core.tree import tree_leaves
        from repro_torch.launch import train as T
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel.sharding import make_plan
        from repro_torch.runtime.checkpoint import load
        cfg = get_smoke("smollm_135m")
        mesh = make_mesh((1, 2), ("data", "model"), "cpu")
        plan = make_plan(cfg, ShapeConfig("c", "train", 32, 16), mesh,
                         MeshConfig(), "train")
        like = T.init_train_state(cfg, TrainConfig(seed=1), "cpu")
        (p, o), m = load({str(ckpt)!r}, like, shardings=(
            plan.param_shardings(cfg), plan.opt_shardings(cfg)))
        want = T.init_train_state(cfg, TrainConfig(), "cpu")
        assert m["step"] == 3 and m["meta"] == {{"ranks": 4}}
        got = tree_leaves(p) + tree_leaves(o.mu) + tree_leaves(o.nu)
        ref = (tree_leaves(want[0]) + tree_leaves(want[1].mu)
               + tree_leaves(want[1].nu))
        for a, b in zip(got, ref):
            assert a.device_mesh.shape == (1, 2)
            assert torch.equal(a.full_tensor(), b)
        assert any(pl.is_shard() for a in got for pl in a.placements)
        open(OUT + f"/ok{{RANK}}", "w").write("ok")
    """, 2, tmp_path)
    assert sorted(p.name for p in out.iterdir()) == ["ok0", "ok1"]


def test_reference_checkpoint_over_four_devices_loads_over_two_ranks(
        tmp_path):
    ckpt = tmp_path / "ref"
    check(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.runtime import checkpoint as C
        mesh4 = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("data",))
        x = jnp.arange(32.0).reshape(8, 4)
        w = jnp.arange(24.0, dtype=jnp.bfloat16).reshape(4, 6) / 7
        C.save({str(ckpt)!r}, 5, {{
            "x": jax.device_put(x, NamedSharding(mesh4, P("data", None))),
            "w": jax.device_put(w, NamedSharding(mesh4, P(None, None)))}})
    """, n_devices=8)
    out = run_ranks(f"""
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.layers import PartitionSpec as P
        from repro_torch.parallel.sharding import NamedSharding
        from repro_torch.runtime.checkpoint import load
        mesh2 = make_mesh((2,), ("data",), "cpu")
        like = {{"x": torch.zeros(8, 4),
                "w": torch.zeros(4, 6, dtype=torch.bfloat16)}}
        sh = {{"x": NamedSharding(mesh2, P("data", None)),
              "w": NamedSharding(mesh2, P(None, "data"))}}
        got, m = load({str(ckpt)!r}, like, shardings=sh)
        assert m["step"] == 5
        assert got["x"].to_local().shape == (4, 4)
        assert got["w"].to_local().shape == (4, 3)
        assert torch.equal(got["x"].full_tensor(),
                           torch.arange(32.0).reshape(8, 4))
        torch.save(got["w"].full_tensor(), OUT + f"/w{{RANK}}.pt")
    """, 2, tmp_path)
    # jnp's bf16 arange / 7 is torch's, rounded once to bf16
    want = torch.arange(24.0).reshape(4, 6).to(torch.bfloat16) / 7
    for r in range(2):
        w = torch.load(out / f"w{r}.pt")
        assert w.dtype == torch.bfloat16 and torch.equal(w, want)


def test_remesh_on_fake_ranks(tmp_path):
    out = run_ranks("""
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.runtime.elastic import plan_degraded_mesh, remesh
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
        ranks = list(range(8))
        healthy = ranks[:4]                      # 4 "survived"
        cand = plan_degraded_mesh(len(healthy))
        assert cand.shape == (1, 4), cand
        mesh = remesh(cand, devices=healthy, device_type="cpu")
        assert mesh.shape == (1, 4) and mesh.mesh_dim_names == (
            "data", "model")
        assert set(mesh.mesh.flatten().tolist()) == set(healthy)
        full = remesh(plan_degraded_mesh(len(ranks)), device_type="cpu")
        assert full.shape == (1, 8)
        # the first six of seven survivors, laid out (3, 2)
        six = plan_degraded_mesh(6, prefer_model=2)
        laid = remesh(six, devices=[0, 1, 2, 3, 4, 5, 7], device_type="cpu")
        assert laid.shape == six.shape == (3, 2)
        assert laid.mesh.flatten().tolist() == [0, 1, 2, 3, 4, 5]
        try:
            remesh(plan_degraded_mesh(8), devices=healthy,
                   device_type="cpu")
            raise AssertionError("8 ranks meshed out of 4")
        except ValueError:
            pass
        open(OUT + "/ok", "w").write(str(cand.devices_needed))
    """, 1, tmp_path, init=False)
    assert (out / "ok").read_text() == "4"


def test_make_host_mesh_needs_a_group_for_more_than_one_rank():
    from repro_torch.launch.mesh import make_host_mesh
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="4 ranks"):
        make_host_mesh(2, 2, device_type="cpu")
    assert not dist.is_initialized()


# (name, placements over ("data", "model")) of a (B, S, KH, D) cache
# sharded over its sequence: over "model" with the batch over "data" (the
# decode_32k layout), over "data" alone, over both (long_500k's); lengths
# that split evenly, unevenly, and leave the last rank no row (3 over 4)
WRITE_LAYOUTS = ("seq over model", "seq over data", "seq over both")
WRITE_LENGTHS = (8, 7, 5, 3)
# (arch, batch): decode steps from an empty cache of DECODE_LEN positions,
# the batch over "data" and the cache's sequence over "model" (16 rows:
# the production mesh's batch rule), or batch 1 with the sequence over
# both axes; SmolLM windowed at 3 so the window bites
DECODE_CASES = (("smollm_135m", 16), ("smollm_135m", 1),
                ("zamba2_1_2b", 1))
DECODE_LEN = 7

SEQ_SHARDED = f"""
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_smoke
from repro_torch.configs.base import MeshConfig, ShapeConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.parallel import act_sharding as ash
from repro_torch.parallel.sharding import distribute, make_plan
mesh = make_host_mesh(2, 2, device_type="cpu")
layouts = dict(zip({WRITE_LAYOUTS!r}, ((Shard(0), Shard(1)),
                                       (Shard(1), Replicate()),
                                       (Shard(1), Shard(1)))))
gen = torch.Generator().manual_seed(0)
writes = {{}}
for name, places in layouts.items():
    for S in {WRITE_LENGTHS!r}:
        cache = torch.randn((2, S, 2, 4), generator=gen)
        want = cache.clone()
        d = distribute_tensor(cache, mesh, places, src_data_rank=None)
        local = d.to_local().shape
        for p in range(S):       # every row: each shard's edges and inside
            new = torch.randn((2, 1, 2, 4), generator=gen)
            want.index_copy_(1, torch.tensor([p]), new)
            if p % 2:            # a DTensor row, laid out by batch
                new = distribute_tensor(new, mesh, (Shard(0), Replicate()),
                                        src_data_rank=None)
            assert ash.write_at(d, torch.tensor([p]), new) is d
            assert tuple(d.placements) == places
            assert d.to_local().shape == local
        writes[(name, S)] = (d.full_tensor(), want)
steps = {{}}
for arch, B in {DECODE_CASES!r}:
    cfg = get_smoke(arch).replace(dtype="float32")
    if arch == "smollm_135m":
        cfg = cfg.replace(attention="windowed", window_size=3)
    S = {DECODE_LEN}
    plan = make_plan(cfg, ShapeConfig("custom", "decode", S, B), mesh,
                     MeshConfig(), "serve")
    params = M.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (S, B, 1), generator=gen)
    ref = M.init_caches(cfg, B, S, dtype=torch.float32, device="cpu")
    caches = distribute(M.init_caches(cfg, B, S, dtype=torch.float32,
                                      device="cpu"),
                        plan.cache_shardings(cfg))
    dp = distribute(params, plan.param_shardings(cfg))
    logits = []
    for p in range(S):
        want, _ = M.decode_step(params, tokens[p], ref, p, cfg)
        # the dry-run's scope: a dim the axes do not divide is replicated
        with ash.activation_rules(plan.act_rules, plan.axis_sizes, mesh), \\
                implicit_replication():
            got, _ = M.decode_step(dp, distribute(tokens[p],
                                                  plan.token_sharding()),
                                   caches, p, cfg)
        logits.append((got.full_tensor(), want))
    kv = caches["shared"] if arch == "zamba2_1_2b" else caches
    ref_kv = ref["shared"] if arch == "zamba2_1_2b" else ref
    steps[(arch, B)] = dict(
        logits=logits, seq=plan.seq_axes, placements=str(kv.k.placements),
        caches=[(kv.k.full_tensor(), ref_kv.k),
                (kv.v.full_tensor(), ref_kv.v)])
if RANK == 0:
    torch.save({{"writes": writes, "steps": steps}}, OUT + "/seq.pt")
"""


@pytest.fixture(scope="module")
def seq_sharded(tmp_path_factory):
    """``SEQ_SHARDED`` run once on a (2, 2) mesh of four gloo ranks."""
    out = run_ranks(SEQ_SHARDED, 4, tmp_path_factory.mktemp("seq"))
    return torch.load(out / "seq.pt")


@pytest.mark.parametrize("layout", WRITE_LAYOUTS)
@pytest.mark.parametrize("length", WRITE_LENGTHS)
def test_write_at_on_a_sequence_sharded_cache(seq_sharded, layout, length):
    """``act_sharding.write_at`` at every position of a cache sharded over
    its sequence: the gathered cache equals ``index_copy_`` on the plain
    tensor, bit for bit, and every rank's shard keeps its placements and
    shape (checked on the ranks)."""
    got, want = seq_sharded["writes"][(layout, length)]
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch,batch", DECODE_CASES)
def test_decode_steps_on_a_sequence_sharded_cache(seq_sharded, arch, batch):
    """``decode_step`` from an empty cache, every position, with the
    parameters and the caches laid out by the serve plan on a (2, 2) mesh
    (the attention's cache written through ``write_at``): logits and the
    attention caches within ``REL`` of the mesh-less step's (other
    summation orders over the shards)."""
    rec = seq_sharded["steps"][(arch, batch)]
    assert rec["seq"] == (() if batch > 1 else ("data", "model"))
    assert "Shard(dim=2)" in rec["placements"]
    for got, want in rec["logits"] + rec["caches"]:
        assert _rel(got, want) <= REL, (arch, batch, _rel(got, want))
