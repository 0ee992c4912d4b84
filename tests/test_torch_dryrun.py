"""The port's step analysis and dry-run on the CPU, against the reference's
HLO analysis.

Each case that needs a ``fake`` process group (8, 256 or 512 ranks) runs
in a subprocess: a process group is per process, and the test process
keeps none.

- the reference's ``SCAN_PROG`` known answer (``tests/test_hlo_analysis.py``)
  on an 8-rank fake (2, 4) mesh: six layers of ``c @ w`` pinned to
  ("data", "model"); the per-rank matmul operations are exactly
  2 B D D L / 8, and an all-gather or all-reduce is among the
  collectives;
- a smoke train step's matmul operations on one device against
  ``analyze_hlo`` of the reference's jitted step: equal but for the
  flash backward's recompute of the scores (2 B S^2 H D a layer), which
  the reference's autograd of its plain core at this size keeps from its
  forward, with remat on and off;
- ``dryrun.run_cell`` on the production meshes with smoke widths: a
  train, a prefill and a decode cell "ok", each one's per-rank parameter
  bytes equal to the reference's spec arithmetic, the record's keys the
  reference's plus the written reasons, and a cell that fails written as
  "error" with its error.
"""
import json
import math
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import MeshConfig as JMeshConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.parallel import sharding as JSH  # noqa: E402
from repro.parallel.hlo_analysis import analyze_hlo  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.parallel.hlo_analysis import HLOStats, analyze_step  # noqa

SRC = str(Path(__file__).resolve().parent.parent / "src")
SMOKE_KEYS = ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size")


def _run(code: str, timeout: int = 300) -> str:
    prelude = (f"import sys, warnings\nsys.path.insert(0, {SRC!r})\n"
               "warnings.filterwarnings('ignore')\n"
               "import torch\ntorch.set_num_threads(1)\n")
    r = subprocess.run([sys.executable, "-c",
                        prelude + textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return r.stdout


SCAN_PROG = """
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel.act_sharding import activation_rules, constrain
from repro_torch.parallel.hlo_analysis import analyze_step
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_mesh((2, 4), ("data", "model"), "cpu")
D, L, B = 128, 6, 64

def f(x, ws):
    c = x
    for i in range(L):
        c = constrain(c @ ws[i], "batch", "feat")
    return c.sum()

with FakeTensorMode():
    x = DTensor.from_local(torch.empty(B // 2, D), mesh,
                           (Shard(0), Replicate()), run_check=False,
                           shape=(B, D), stride=(D, 1))
    ws = DTensor.from_local(torch.empty(L, D, D // 4), mesh,
                            (Replicate(), Shard(2)), run_check=False,
                            shape=(L, D, D), stride=(D * D, D, 1))
    with activation_rules({"batch": "data", "feat": "model"}, mesh=mesh):
        st = analyze_step(f, x, ws)
print("TRIPS", st.trip_counts)
print("FLOPS", st.dot_flops)
print("EXPECTED", 2 * B * D * D * L / 8)
print("COLL", sorted(st.bytes_by_kind))
"""


def test_scan_prog_flops_exact_on_a_fake_mesh():
    out = _run(SCAN_PROG)
    lines = dict(line.split(" ", 1) for line in out.strip().splitlines()
                 if line.split(" ", 1)[0] in ("TRIPS", "FLOPS", "EXPECTED",
                                              "COLL"))
    assert lines["TRIPS"] == "[]"          # no loop body counted once
    assert float(lines["FLOPS"]) == float(lines["EXPECTED"])
    assert "all-gather" in lines["COLL"] or "all-reduce" in lines["COLL"]


def test_analyze_empty():
    st = analyze_step(lambda: None)
    assert st.dot_flops == 0 and st.total_collective_bytes == 0
    assert isinstance(st, HLOStats) and st.trip_counts == []


@pytest.mark.parametrize("remat", ("block", "none"))
def test_train_step_matmul_operations_match_reference(remat):
    B, L = 2, 64
    jcfg = jget_smoke("smollm_135m").replace(dtype="float32", remat=remat)
    cfg = get_smoke("smollm_135m").replace(dtype="float32", remat=remat)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    batch = {"tokens": jnp.zeros((B, L), jnp.int32)}
    hlo = jax.jit(JS.make_train_step(jcfg, JTrainConfig())).lower(
        params, JA.init(params, JTrainConfig()), batch).compile().as_text()
    want = analyze_hlo(hlo).dot_flops
    p, o = T.init_train_state(cfg, TrainConfig(), "cpu")
    got = analyze_step(S.make_train_step(cfg, TrainConfig()), p, o,
                       {"tokens": torch.zeros((B, L), dtype=torch.int32)})
    # the flash backward recomputes the scores from q and k (one B S^2 H D
    # product a layer); the reference's autograd of its plain core keeps
    # them from the forward
    recompute = 2 * B * L * L * cfg.num_heads * cfg.resolved_head_dim \
        * cfg.num_layers
    assert got.dot_flops == want + recompute, (got.dot_flops, want)
    assert got.bytes_by_kind == {}         # one device: no collective


CELLS = (("train_4k", True), ("prefill_32k", False), ("decode_32k", True))


def _param_bytes(arch, overrides, shape_name, multi_pod):
    """One rank's parameter bytes by the reference's specs and its spec
    arithmetic."""
    jcfg = jget_config(arch).replace(**overrides)
    mcfg = JMeshConfig(multi_pod=multi_pod)
    sizes = dict(zip(mcfg.axes, mcfg.shape))
    rules = (JSH.train_rules if shape_name == "train_4k"
             else JSH.serve_rules)(jcfg, mcfg)
    specs = jax.tree.leaves(JL.param_specs(JM.model_defs(jcfg), rules, sizes),
                            is_leaf=lambda x: isinstance(x, JP))
    total = 0
    for spec, a in zip(specs, jax.tree.leaves(JM.abstract_params(jcfg))):
        local = [dim // math.prod(sizes[x] for x in (
            e if isinstance(e, tuple) else (e,))) if e else dim
            for dim, e in zip(a.shape, tuple(spec) + (None,) * a.ndim)]
        total += math.prod(local) * a.dtype.itemsize
    return total


def test_dryrun_cells_trace_on_the_production_meshes(tmp_path):
    sm = get_smoke("smollm_135m")
    overrides = {k: getattr(sm, k) for k in SMOKE_KEYS}
    moe = get_smoke("qwen3_moe_235b")
    moe_overrides = {k: getattr(moe, k) for k in SMOKE_KEYS}
    out = _run(f"""
        import json
        from pathlib import Path
        from repro_torch.launch import dryrun as D
        out = Path({str(tmp_path)!r})
        for shape, mp in {CELLS!r}:
            D.run_cell("smollm_135m", shape, mp, out,
                       overrides={overrides!r})
        # a cell whose trace fails (the MoE's sorted dispatch: DTensor has
        # no sharding strategy for searchsorted) is written as an error,
        # as the reference writes one
        D.run_cell("qwen3_moe_235b", "train_4k", False, out / "bad",
                   overrides={moe_overrides!r})
    """, timeout=600)
    assert out.count(": OK") == 3 and out.count(": FAILED") == 1, out
    for shape, mp in CELLS:
        name = f"smollm_135m__{shape}__{'pod2' if mp else 'pod1'}.json"
        rec = json.loads((tmp_path / name).read_text())
        assert rec["status"] == "ok", rec.get("error")
        assert rec["mesh"] == ([2, 16, 16] if mp else [16, 16])
        assert rec["memory_analysis"]["params_bytes"] == _param_bytes(
            "smollm_135m", overrides, shape, mp)
        h = rec["hlo_analysis"]
        assert h["dot_flops_per_device"] > 0
        assert rec["cost_analysis"]["flops"] == h["dot_flops_per_device"]
        assert h["trip_counts"] == []
        assert "hlo_analysis.trip_counts" in rec["no_counterpart"]
        if shape == "train_4k":
            assert rec["microbatches"] == 2
            assert h["collective_bytes_per_device"]["all-gather"] > 0
            assert rec["memory_analysis"]["opt_state_bytes"] > 0
        if shape == "decode_32k":
            assert rec["memory_analysis"]["caches_bytes"] > 0
    bad = json.loads((tmp_path / "bad" /
                      "qwen3_moe_235b__train_4k__pod1.json").read_text())
    assert bad["status"] == "error"
    assert bad["error"].startswith("NotImplementedError"), bad["error"]
    assert "searchsorted" in bad["error"], bad["error"]
    assert bad["memory_analysis"]["params_bytes"] == _param_bytes(
        "qwen3_moe_235b", moe_overrides, "train_4k", False)


def test_dryrun_cli_writes_a_cell(tmp_path):
    out = _run(f"""
        from repro_torch.launch import dryrun as D
        import repro_torch.configs as C
        smoke = C.get_smoke("smollm_135m")
        real = C.get_config
        D.get_config = lambda name: smoke
        D.main(["--arch", "smollm_135m", "--shape", "prefill_32k",
                "--out", {str(tmp_path)!r}])
        D.main(["--arch", "smollm_135m", "--shape", "prefill_32k",
                "--skip-existing", "--out", {str(tmp_path)!r}])
    """)
    assert "1 ok, 0 failed, 0 skipped" in out
    assert "0 ok, 0 failed, 1 skipped" in out
    rec = json.loads((tmp_path / "smollm_135m__prefill_32k__pod1.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["kind"] == "prefill"
    np.testing.assert_equal(rec["axes"], ["data", "model"])
