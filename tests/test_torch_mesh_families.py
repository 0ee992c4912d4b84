"""The mesh trainer beyond the dense families, on the CPU: the MoE's sorted
dispatch and xLSTM's gates under DTensor, against the reference's mesh run.

Each multi-rank case runs its ranks as subprocesses over a ``FileStore``
(``test_torch_mesh.run_ranks``; the test process keeps no process group);
the reference runs on fake XLA devices through ``tests/_subproc.py``.

- the Qwen3-MoE smoke config with ``dispatch="sorted_grouped"`` (the full
  configs' dispatch; the smoke config's own is gshard) and the xLSTM
  smoke config, float32, each trained 2 steps on a (2, 2) mesh of four
  gloo ranks, against the reference's ``train(mesh=)`` and first-step
  gradients on a (2, 2) mesh of four fake devices: losses within 1e-5
  relative; every gradient leaf within 1e-5 relative Frobenius of the
  reference's and of the port's one-rank gradients (what the mesh
  changes: other summation orders over the shards), but xLSTM's within
  ``XLSTM_REL``: its exponential gates carry a summation order's
  rounding into its gradients, which lie up to 5.5e-5 from the
  reference's on one rank (tests/test_torch_train_families.py holds them
  at 1e-4) and up to 2.1e-5 from one rank's on the (2, 2) mesh;
- the same MoE config in the smoke config's bf16 through
  ``train(mesh=make_host_mesh(1, 1))`` bit-equal to the mesh-less
  trainer (losses, parameters, moments), as the card runs it;
- ``ssm.log_sigmoid`` of a DTensor sharded over the four ranks and its
  gradient: bit-equal to ``F.logsigmoid`` of the plain tensor, and within
  float32 rounding of ``jax.nn.log_sigmoid`` and its ``jax.grad``.
"""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from tests._subproc import check  # noqa: E402
from tests.test_torch_mesh import run_ranks  # noqa: E402

REL = 1e-5                       # losses; gradients but xLSTM's
XLSTM_REL = 1e-4                 # xLSTM's gradients (module docstring)
SHAPE = (16, 32)                 # (batch, tokens): 16 rows shard over "data"
STEPS = 2
TCFG = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
ARCHS = ("qwen3_moe_235b", "xlstm_1_3b")
LOGSIG_SHAPE = (8, 64)           # rows shard over the four ranks

# the config of each arch: float32 smoke widths, the MoE on the full
# configs' sorted_grouped dispatch
CONFIG = """
import dataclasses

def config(get_smoke, arch):
    cfg = get_smoke(arch).replace(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, dispatch="sorted_grouped"))
    return cfg
"""


def _config(arch):
    cfg = get_smoke(arch).replace(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, dispatch="sorted_grouped"))
    return cfg


def _logsig_input():
    rng = np.random.default_rng(0)
    return (rng.standard_normal(LOGSIG_SHAPE) * 8).astype(np.float32)


SHARDED_TRAIN = CONFIG + f"""
import numpy as np
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard
from repro_torch.configs import get_smoke
from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
from repro_torch.core.tree import tree_map
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import steps as S
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import ssm
from repro_torch.parallel.sharding import distribute, make_plan
tcfg = TrainConfig(**{TCFG!r})
B, L = {SHAPE!r}
mesh = make_host_mesh(2, 2, device_type="cpu")
out = {{}}
for arch in {ARCHS!r}:
    cfg = config(get_smoke, arch)
    _, _, losses = T.train(cfg, tcfg, batch=B, seq=L, steps={STEPS},
                           mesh=mesh, log_every=0)
    params, _ = T.init_train_state(cfg, tcfg, "cpu")
    plan = make_plan(cfg, ShapeConfig("custom", "train", L, B), mesh,
                     MeshConfig(), "train")
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, L, B, seed=0))
    batch = {{"tokens": torch.from_numpy(pipe.batch(0)["tokens"])}}
    dp = distribute(params, plan.param_shardings(cfg))
    db = distribute(batch, plan.batch_shardings(cfg, "train"))
    with T._mesh_scope(plan, mesh):
        g, _ = S.loss_grads(dp, db, cfg)
    out[arch] = {{"losses": losses,
                 "grads": tree_map(lambda t: t.full_tensor(), g)}}

# log_sigmoid of a DTensor whose rows shard over the four ranks
x = torch.from_numpy(np.load(OUT + "/../logsig.npy"))
flat = make_mesh((4,), ("data",), "cpu")
rows = x.shape[0] // WORLD
local = x[RANK * rows:(RANK + 1) * rows].clone().requires_grad_(True)
dx = DTensor.from_local(local, flat, (Shard(0),), run_check=False)
y = ssm.log_sigmoid(dx)
y.sum().backward()
plain = x.clone().requires_grad_(True)
want = F.logsigmoid(plain)
want.sum().backward()
out["logsig"] = {{"y": y.full_tensor().detach(), "grad": local.grad,
                 "rank_rows": slice(RANK * rows, (RANK + 1) * rows),
                 "plain_y": want.detach(), "plain_grad": plain.grad,
                 "placements": str(y.placements)}}
torch.save(out, OUT + f"/mesh{{RANK}}.pt")
"""


REF_SHARDED_TRAIN = CONFIG + f"""
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
tcfg = TrainConfig(**{TCFG!r})
B, L = {SHAPE!r}
mesh = make_host_mesh(2, 2)
out = {{}}
for arch in {ARCHS!r}:
    cfg = config(get_smoke, arch)
    _, _, losses = JT.train(cfg, tcfg, batch=B, seq=L, steps={STEPS},
                            mesh=mesh, log_every=0)
    plan = make_plan(cfg, ShapeConfig("custom", "train", L, B), mesh,
                     MeshConfig(), "train")
    params = jax.device_put(
        M.init_params(cfg, jax.random.PRNGKey(tcfg.seed)),
        plan.param_shardings(cfg))
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, L, B, seed=0))
    batch = jax.device_put({{"tokens": pipe.batch(0)["tokens"]}},
                           plan.batch_shardings(cfg, "train"))
    with mesh, activation_rules(plan.act_rules):
        g = jax.jit(jax.grad(lambda p, b: M.loss_fn(p, b, cfg)[0]))(
            params, batch)
    out[arch] = {{"losses": losses,
                 "grads": jax.tree.map(lambda a: np.asarray(a, np.float32),
                                       g)}}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the (2, 2) gloo ranks' results, rank by rank; the reference's
    (2, 2) mesh run) for each of ``ARCHS``, and log_sigmoid's input."""
    tmp = tmp_path_factory.mktemp("families")
    x = _logsig_input()
    np.save(tmp / "logsig.npy", x)
    out = run_ranks(SHARDED_TRAIN, 4, tmp, timeout=600)
    ranks = [torch.load(out / f"mesh{r}.pt", weights_only=False)
             for r in range(4)]
    ref = tmp / "ref.pkl"
    check("import sys\nsys.argv[1:] = [" + repr(str(ref)) + "]\n"
          + REF_SHARDED_TRAIN, n_devices=4, timeout=600)
    with open(ref, "rb") as f:
        want = pickle.load(f)
    return ranks, want, x


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_training_matches_reference_mesh(runs, arch):
    """Losses and first-step gradients of the (2, 2) gloo run against the
    reference's (2, 2) mesh run and the port's one-rank gradients."""
    ranks, want, _ = runs
    got = ranks[0][arch]
    for a, b in zip(got["losses"], want[arch]["losses"]):
        assert abs(a - b) <= REL * abs(b), (got["losses"],
                                            want[arch]["losses"])
    cfg = _config(arch)
    g = M.params_from_numpy(want[arch]["grads"], cfg, device="cpu")
    gaps = [_rel(a, b) for a, b in zip(tree_leaves(got["grads"]),
                                       tree_leaves(g))]
    bound = XLSTM_REL if cfg.family == "ssm" else REL
    assert len(gaps) == len(tree_leaves(g)) and max(gaps) <= bound, gaps
    params, _ = T.init_train_state(cfg, TrainConfig(**TCFG), "cpu")
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, SHAPE[1], SHAPE[0],
                                    seed=0))
    one, _ = S.loss_grads(params, {"tokens": torch.from_numpy(
        pipe.batch(0)["tokens"])}, cfg)
    gaps = [_rel(a, b) for a, b in zip(tree_leaves(got["grads"]),
                                       tree_leaves(one))]
    assert max(gaps) <= bound, gaps
    # every rank reads the same losses
    assert all(r[arch]["losses"] == got["losses"] for r in ranks)


def test_log_sigmoid_of_a_dtensor(runs):
    """Bit-equal to the one-kernel form on the plain tensor, forward and
    gradient, on every rank; within float32 rounding of jax.nn."""
    ranks, _, x = runs
    want_y = np.asarray(jax.nn.log_sigmoid(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jax.nn.log_sigmoid(v)))(
        jnp.asarray(x)))
    for r in ranks:
        got = r["logsig"]
        assert got["placements"] == "(Shard(dim=0),)"
        assert torch.equal(got["y"], got["plain_y"])
        assert torch.equal(got["grad"], got["plain_grad"][got["rank_rows"]])
        np.testing.assert_allclose(got["y"].numpy(), want_y, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got["grad"].numpy(),
                                   want_g[got["rank_rows"]], rtol=1e-6,
                                   atol=1e-7)


ONE_BY_ONE = CONFIG + f"""
from repro_torch.configs import get_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import train as T
from repro_torch.launch.mesh import end_local_group, make_host_mesh
cfg = config(get_smoke, "qwen3_moe_235b").replace(
    dtype=get_smoke("qwen3_moe_235b").dtype)
assert cfg.moe.dispatch == "sorted_grouped" and cfg.dtype == "bfloat16"
tcfg = TrainConfig(**{TCFG!r})
mesh = make_host_mesh(1, 1, device_type="cpu")
p0, o0, l0 = T.train(cfg, tcfg, batch=8, seq=32, steps=3, device="cpu",
                     log_every=0)
p1, o1, l1 = T.train(cfg, tcfg, batch=8, seq=32, steps=3, mesh=mesh,
                     log_every=0)
assert l0 == l1, (l0, l1)
for a, b in zip(tree_leaves(p0) + tree_leaves(o0.mu) + tree_leaves(o0.nu),
                tree_leaves(p1) + tree_leaves(o1.mu) + tree_leaves(o1.nu)):
    assert torch.equal(a, b.to_local())
assert int(o0.step) == int(o1.step.to_local())
end_local_group()
open(OUT + "/ok", "w").write("ok")
"""


def test_moe_one_by_one_mesh_is_bit_equal(tmp_path):
    out = run_ranks(ONE_BY_ONE, 1, tmp_path, init=False)
    assert (out / "ok").read_text() == "ok"
