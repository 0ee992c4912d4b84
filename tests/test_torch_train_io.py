"""The port's training I/O against the JAX reference on the CPU: the
checkpoint format, the data pipeline, elastic re-mesh planning and the
gradient compression.

- the reference's checkpoint tests on the port (round trip, latest step
  and garbage collection, no partial checkpoint on a failed write, a
  structure mismatch refused, the async writer and its error); a None
  sharding loads as no sharding (the reshard onto a mesh is
  tests/test_torch_mesh.py's);
- a checkpoint of a training state (parameters with bf16 leaves, the
  AdamW state) written by the reference loads in the port, and one
  written by the port loads in the reference: the same manifest keys and
  tree string, every array bit-equal, bf16 included;
- ``TokenPipeline`` batches equal to the reference's;
- ``plan_degraded_mesh`` and ``rescale_batch`` equal to the reference's
  over a grid, ``remesh`` laying the chosen ranks out in its shape and
  axes (over a one-rank group here; over eight in test_torch_mesh.py);
- the compression functions bit-equal to the reference's, and
  ``compressed_psum`` asking for a mesh when none is given or active.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.parallel import compression as JGC  # noqa: E402
from repro.runtime import checkpoint as JC  # noqa: E402
from repro.runtime import elastic as JE  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data import pipeline as P  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import compression as GC  # noqa: E402
from repro_torch.runtime import checkpoint as C  # noqa: E402
from repro_torch.runtime import elastic as E  # noqa: E402


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 16), generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int32),
                       "scale": torch.tensor(2.5)}}


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def test_save_load_roundtrip(tmp_path):
    t = _tree()
    C.save(tmp_path, 3, t)
    loaded, manifest = C.load(tmp_path, _zeros_like(t))
    assert manifest["step"] == 3
    for a, b in zip(tree_leaves(t), tree_leaves(loaded)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_step_and_gc(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        C.save(tmp_path, s, t, keep=2)
    assert C.latest_step(tmp_path) == 5
    kept = sorted(p.name for p in Path(tmp_path).glob("step_*"))
    assert len(kept) == 2


def test_no_partial_checkpoint_on_failure(tmp_path, monkeypatch):
    t = _tree()
    C.save(tmp_path, 1, t)

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError):
        C.save(tmp_path, 2, t)
    assert C.latest_step(tmp_path) == 1
    assert not list(Path(tmp_path).glob(".tmp_*"))
    C.load(tmp_path, _zeros_like(t))


def test_structure_mismatch_rejected(tmp_path):
    C.save(tmp_path, 1, _tree())
    with pytest.raises(AssertionError):
        C.load(tmp_path, {"w": torch.zeros((8, 16))})


def test_async_checkpointer(tmp_path):
    t = _tree()
    w = t["w"].clone()
    ac = C.AsyncCheckpointer(tmp_path)
    ac.save(7, t, meta={"loss": 1.0})
    t["w"].add_(1.0)                     # the snapshot was taken at save
    ac.wait()
    loaded, m = C.load(tmp_path, _zeros_like(t))
    assert m["meta"]["loss"] == 1.0
    assert torch.equal(loaded["w"], w)


def test_async_error_propagates(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a dir")          # mkdir under a file must fail
    ac = C.AsyncCheckpointer(blocker / "ckpt")
    ac.save(1, _tree())
    with pytest.raises(BaseException):
        ac.wait()


def test_reshard_on_load_is_not_ported(tmp_path):
    """Reshard on load is ported now; the name is the test's earlier one.
    What stays here: a None sharding (the reference's default device)
    loads the leaf as load without shardings does. A NamedSharding
    reshards onto its mesh in tests/test_torch_mesh.py
    (test_checkpoint_saved_over_four_ranks_loads_over_two)."""
    C.save(tmp_path, 1, _tree())
    plain, _ = C.load(tmp_path, _zeros_like(_tree()))
    loaded, _ = C.load(tmp_path, _zeros_like(_tree()), shardings={"w": None})
    for a, b in zip(tree_leaves(loaded), tree_leaves(plain)):
        assert torch.equal(a, b)


def _train_states(seed=0):
    """The same training state in both packages: parameters (bf16 and
    float32 leaves) and AdamW state after one update."""
    rng = np.random.default_rng(seed)
    arrays = {"blocks": {"w": rng.normal(size=(2, 6, 4)),
                         "scale": rng.normal(size=(2, 4))},
              "embed": {"table": rng.normal(size=(10, 4))}}
    dtypes = {"w": "bfloat16", "scale": "float32", "table": "bfloat16"}

    def jtree(node, name=None):
        if isinstance(node, dict):
            return {k: jtree(v, k) for k, v in node.items()}
        return jnp.asarray(node, dtypes[name])

    def ttree(node, name=None):
        if isinstance(node, dict):
            return {k: ttree(v, k) for k, v in node.items()}
        return torch.from_numpy(node.astype(np.float32)).to(
            getattr(torch, dtypes[name]))

    jp, tp = jtree(arrays), ttree(arrays)
    jt, tt = JTrainConfig(moment_dtype="bfloat16"), TrainConfig(
        moment_dtype="bfloat16")
    jg = jax.tree.map(lambda a: a * 0.5, jp)
    _, jopt, _ = JA.update(jg, JA.init(jp, jt), jp, jt, 1e-3)
    tg = {k: {kk: vv * 0.5 for kk, vv in v.items()} for k, v in tp.items()}
    _, topt, _ = adamw.update(tg, adamw.init(tp, tt), tp, tt, 1e-3)
    return (jp, jopt), (tp, topt)


def _assert_same(ttree, jtree):
    tleaves = [leaf for part in (ttree[0], ttree[1].mu, ttree[1].nu)
               for leaf in tree_leaves(part)]
    jleaves = (jax.tree.leaves(jtree[0]) + jax.tree.leaves(jtree[1].mu)
               + jax.tree.leaves(jtree[1].nu))
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
    assert int(ttree[1].step) == int(jtree[1].step)


def test_reference_checkpoint_loads_in_port(tmp_path):
    (jstate, tstate) = _train_states()
    JC.save(tmp_path, 4, jstate, meta={"loss": 2.0})
    zeros = (jax.tree.map(torch.zeros_like, tstate[0]),
             type(tstate[1])(torch.zeros_like(tstate[1].step),
                             jax.tree.map(torch.zeros_like, tstate[1].mu),
                             jax.tree.map(torch.zeros_like, tstate[1].nu)))
    loaded, manifest = C.load(tmp_path, zeros)
    assert manifest["step"] == 4 and manifest["meta"] == {"loss": 2.0}
    _assert_same(loaded, jstate)


def test_port_checkpoint_loads_in_reference(tmp_path):
    (jstate, tstate) = _train_states(1)
    C.save(tmp_path / "port", 4, tstate)
    JC.save(tmp_path / "ref", 4, jstate)
    manifests = [__import__("json").loads(
        (tmp_path / d / "step_0000000004" / "manifest.json").read_text())
        for d in ("port", "ref")]
    for key in ("keys", "dtypes", "treedef", "step"):
        assert manifests[0][key] == manifests[1][key], key
    assert "[1]/.step" in manifests[0]["keys"]
    loaded, _ = JC.load(tmp_path / "port", jax.tree.map(jnp.zeros_like,
                                                        jstate))
    _assert_same(tstate, loaded)
    # and the arrays on disk are the reference's, byte for byte
    a = np.load(tmp_path / "port" / "step_0000000004" / "arrays.npz")
    b = np.load(tmp_path / "ref" / "step_0000000004" / "arrays.npz")
    for key in manifests[0]["keys"]:
        assert a[key].dtype == b[key].dtype
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("seed,shard,num_shards", [(0, 0, 1), (3, 1, 2),
                                                   (7, 3, 4)])
def test_pipeline_batches_equal_reference(seed, shard, num_shards):
    cfg = dict(vocab_size=512, seq_len=96, global_batch=8, seed=seed)
    ours = P.TokenPipeline(P.DataConfig(**cfg), shard, num_shards)
    ref = JP.TokenPipeline(JP.DataConfig(**cfg), shard, num_shards)
    for step in (0, 1, 17):
        a, b = ours.batch(step), ref.batch(step)
        assert a.keys() == b.keys()
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    first = next(iter(ours))
    np.testing.assert_array_equal(first["tokens"], ref.batch(0)["tokens"])


def test_degraded_mesh_and_rescale_equal_reference():
    for healthy in range(1, 40):
        for prefer in (1, 2, 4, 8, 16, 32):
            ours = E.plan_degraded_mesh(healthy, prefer)
            ref = JE.plan_degraded_mesh(healthy, prefer)
            assert (ours.shape, ours.axes, ours.devices_needed) == (
                ref.shape, ref.axes, ref.devices_needed)
    for g in (1, 2, 7, 32, 256):
        for old in (1, 2, 3, 4, 8):
            for new in (1, 2, 4, 6):
                assert E.rescale_batch(g, old, new) == \
                    JE.rescale_batch(g, old, new)
    with pytest.raises(AssertionError):
        E.plan_degraded_mesh(0)


def test_remesh_lays_out_the_chosen_devices():
    """remesh over the one rank of a gloo group; the (3, 2) layout over 6
    of 7 ranks is tests/test_torch_mesh.py::test_remesh_on_fake_ranks."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import end_local_group, start_local_group
    start_local_group("cpu")
    try:
        cand = E.plan_degraded_mesh(1, prefer_model=2)
        mesh = E.remesh(cand, device_type="cpu")
        assert mesh.shape == cand.shape == (1, 1)
        assert mesh.mesh_dim_names == cand.axes == ("data", "model")
        assert mesh.mesh.flatten().tolist() == [0]
        with pytest.raises(ValueError):
            E.remesh(E.plan_degraded_mesh(8), device_type="cpu")
    finally:
        end_local_group()
    assert not dist.is_initialized()
    with pytest.raises(Exception):
        cand.shape = (2, 2)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_compression_bit_equal_reference(dtype):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(33, 17)) * np.logspace(-3, 2, 17)).astype(
        np.float32)
    x[0, 0] = 0.0
    xt = torch.from_numpy(np.array(jnp.asarray(x, dtype), np.float32))
    if dtype != np.float32:
        xt = xt.to(torch.bfloat16)
    xj = jnp.asarray(x, dtype)
    q, s = GC.quantize_int8(xt)
    jq, js = JGC.quantize_int8(xj)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(GC.dequantize_int8(q, s).numpy(),
                                  np.asarray(JGC.dequantize_int8(jq, js)))
    np.testing.assert_array_equal(GC.compress_decompress(xt).numpy(),
                                  np.asarray(JGC.compress_decompress(xj)))
    zero = GC.compress_decompress(torch.zeros(4))
    assert torch.equal(zero, torch.zeros(4))

    grads = {"a": xt, "b": {"c": xt[:5] * 3}}
    jgrads = {"a": xj, "b": {"c": xj[:5] * 3}}
    res, jres = GC.init_residual(grads), JGC.init_residual(jgrads)
    for _ in range(3):
        comp, res = GC.apply_error_feedback(grads, res)
        jcomp, jres = JGC.apply_error_feedback(jgrads, jres)
        for a, b in zip(tree_leaves(comp), jax.tree.leaves(jcomp)):
            assert a.dtype == grads["a"].dtype
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
        for a, b in zip(tree_leaves(res), jax.tree.leaves(jres)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="needs a mesh"):
        GC.compressed_psum(xt, "pod")
