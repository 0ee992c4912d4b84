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


SHARDED_TRAIN = f"""
from repro_torch.configs import get_smoke
from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
from repro_torch.core.tree import tree_map, tree_leaves
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import steps as S
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel.sharding import distribute, make_plan
cfg = get_smoke("smollm_135m").replace(dtype="float32")
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
with T._mesh_scope(plan, mesh):
    g, ce = S.loss_grads(dp, db, cfg)
full = tree_map(lambda t: t.full_tensor(), g)
if RANK == 0:
    torch.save({{"losses": losses, "grads": full,
                "batch_axes": plan.batch_axes,
                "placements": sorted({{str(t.placements)
                                       for t in tree_leaves(dp)}}),
                "tokens": str(db["tokens"].placements)}},
               OUT + "/mesh.pt")
"""


REF_SHARDED_TRAIN = f"""
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
cfg = get_smoke("smollm_135m").replace(dtype="float32")
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


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """The (2, 2) gloo ranks' losses, first-step gradients and layouts."""
    tmp = tmp_path_factory.mktemp("sharded")
    return torch.load(run_ranks(SHARDED_TRAIN, 4, tmp) / "mesh.pt")


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


def test_sharded_training_matches_reference_mesh(sharded_run, tmp_path):
    """The same run against the reference's ``train(mesh=)`` and its
    first-step gradients on a (2, 2) mesh of four fake XLA devices."""
    import pickle
    from repro_torch.models import model as M
    ref = tmp_path / "ref.pkl"
    check("import sys\nsys.argv[1:] = [" + repr(str(ref)) + "]\n"
          + REF_SHARDED_TRAIN, n_devices=4)
    with open(ref, "rb") as f:
        want = pickle.load(f)
    got = sharded_run
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= REL_REF * abs(b), (got["losses"],
                                                want["losses"])
    g = M.params_from_numpy(want["grads"], _smoke(), device="cpu")
    gaps = [_rel(a, b) for a, b in zip(tree_leaves(got["grads"]),
                                       tree_leaves(g))]
    assert max(gaps) <= REL_REF, gaps


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
