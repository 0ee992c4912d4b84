"""The port's trace plane (``core/tracing.py``) and metrics registry
(``runtime/observability.py``) against the JAX reference, on the CPU.

Redaction outputs, rejections, Chrome and JSONL exports and the span trees
of a served batch must equal the reference's, timestamps, thread ids and
span ids excluded. Two trees are compared: a batch served through an
executable (the reference's jit; the port's executable records no inner
span, as a CUDA-graph replay records none) and an eager infer, whose
``plan.segment``, ``op.*`` and ``kernel.*`` spans must match one for one.
A kernel span's ``shapes`` attribute is left out of that comparison: the
port pads the limb planes' K to 32, the reference to 128 lanes.
"""
import json

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (before kernels: circular import)
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.core import integrity as JIG  # noqa: E402
from repro.core import tracing as JT  # noqa: E402
from repro.core.origami import OrigamiExecutor as JEx  # noqa: E402
from repro.runtime import observability as JO  # noqa: E402
from repro.runtime import serving as JS  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import integrity as TIG  # noqa: E402
from repro_torch.core import tracing as TT  # noqa: E402
from repro_torch.core.origami import OrigamiExecutor  # noqa: E402
from repro_torch.kernels.limb_matmul.ops import field_matmul  # noqa: E402
from repro_torch.kernels.limb_matmul.ref import P  # noqa: E402
from repro_torch.models import vgg as V  # noqa: E402
from repro_torch.runtime import observability as TO  # noqa: E402
from repro_torch.runtime import serving as TS  # noqa: E402
from repro_torch.runtime.aot import CompileCache  # noqa: E402

_GOOD = [None, True, False, 7, -3, 0.5, "digest:ab12", "x" * 10_000,
         [1, 2, (3, "x")], {"shape": [224, 224, 3]}, (), {"a": {"b": [1]}},
         {1: "int key"}]


@pytest.mark.parametrize("value", _GOOD, ids=range(len(_GOOD)))
def test_redact_allowlist_matches_reference(value):
    assert TT.redact(value) == JT.redact(value)


_BAD = [np.zeros(4, np.int32), b"\x00keymaterial", bytearray(b"kk"),
        memoryview(b"kk"), object(), {"ok": 1, "oops": np.arange(3)},
        [[[[1]]]], list(range(100))]


@pytest.mark.parametrize("value", _BAD, ids=range(len(_BAD)))
def test_redact_rejects_what_the_reference_rejects(value):
    with pytest.raises(JT.RedactionError):
        JT.redact(value)
    with pytest.raises(TT.RedactionError):
        TT.redact(value)


@pytest.mark.parametrize("tensor", [
    torch.zeros(3), torch.tensor(5), torch.ones((2, 2), dtype=torch.int32),
    torch.zeros(0, dtype=torch.bool)], ids=["f32", "0d", "i32", "empty"])
def test_redact_rejects_torch_tensors(tensor):
    with pytest.raises(TT.RedactionError, match="arrays"):
        TT.redact(tensor)
    with pytest.raises(TT.RedactionError):
        TT.redact({"nested": [tensor]})


def test_span_attach_fails_closed():
    tr = TT.Tracer()
    with pytest.raises(TT.RedactionError):
        tr.start_span("bad", "step", r=torch.arange(8))
    assert tr.spans() == []
    s = tr.start_span("ok", "step", n=1)
    with pytest.raises(TT.RedactionError):
        tr.annotate(s, leak=torch.ones(3))
    assert s.attrs == {"n": 1}
    tr.end(s)


def _script(mod):
    """One fixed span script through a tracer of ``mod``."""
    tr = mod.Tracer()
    with tr.span("request", "request", model="m", shape=[2, 8, 8, 3]):
        with mod.maybe_span("unseal", "crypto", n_requests=2) as s:
            mod.annotate(s, n_valid=2)
        with mod.maybe_span("infer", "infer", attempt="blinded"):
            assert mod.current_span().name == "infer"
            assert mod.current_tracer() is tr
        open_ = tr.start_span("left-open", "step")
    assert mod.current_tracer() is None
    return tr, open_


def _strip(ev):
    ev = dict(ev)
    for k in ("ts", "dur", "tid"):
        ev.pop(k, None)
    args = dict(ev.get("args", {}))
    for k in ("trace_id", "span_id", "parent_id"):
        args.pop(k, None)
    ev["args"] = args
    return ev


def test_chrome_and_jsonl_exports_match_reference(tmp_path):
    ttr, _ = _script(TT)
    jtr, _ = _script(JT)
    tdoc, jdoc = ttr.to_chrome(), jtr.to_chrome()
    assert [_strip(e) for e in tdoc["traceEvents"]] == \
        [_strip(e) for e in jdoc["traceEvents"]]
    assert tdoc["otherData"]["truncated"] == jdoc["otherData"]["truncated"]
    n = ttr.dump_chrome(tmp_path / "t.json")
    assert n == len(json.loads((tmp_path / "t.json").read_text())[
        "traceEvents"])
    assert ttr.dump_jsonl(tmp_path / "t.jsonl") == len(ttr.spans()) == 4
    # the parent structure: every child's parent is the request root
    root = ttr.roots()[0]
    assert [s.name for s in ttr.children(root)] == ["unseal", "infer",
                                                    "left-open"]


def test_tracer_truncation_markers(tmp_path):
    for mod in (TT, JT):
        tr = mod.Tracer(max_spans=3)
        for i in range(5):
            tr.end(tr.start_span(f"s{i}", "step"))
        assert tr.dropped == 2 and len(tr.spans()) == 3
        doc = tr.to_chrome()
        assert doc["otherData"] == {**doc["otherData"], "dropped_spans": 2,
                                    "truncated": True}
        path = tmp_path / f"{mod.__name__}.jsonl"
        tr.dump_jsonl(path)
        last = json.loads(path.read_text().splitlines()[-1])
        assert last == {"truncated": True, "dropped_spans": 2}


def test_profiled_kernel_records_only_under_a_kernel_tracer():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, P, (8, 8), dtype=np.int32))
    w = torch.from_numpy(rng.integers(0, P, (8, 8), dtype=np.int32))
    tr = TT.Tracer()                         # kernel spans on by default
    with tr.span("request", "request"):
        field_matmul(x, w)
    kernels = [s for s in tr.spans() if s.kind == "kernel"]
    assert [s.name for s in kernels] == ["kernel.limb_matmul"]
    assert kernels[0].attrs["shapes"] == [[8, 8], [8, 8]]
    assert kernels[0].t1 is not None
    before = len(tr.spans())
    field_matmul(x, w)                       # no ambient tracer
    with TT.activate(tr):
        with TT.suspended():
            field_matmul(x, w)               # suspended: nothing
    off = TT.Tracer(kernel_spans=False)
    with off.span("request", "request"):
        field_matmul(x, w)
    assert len(tr.spans()) == before
    assert [s.name for s in off.spans()] == ["request"]


def test_metrics_registry_matches_reference():
    regs = [TO.MetricsRegistry(), JO.MetricsRegistry()]
    for reg, mod in zip(regs, (TO, JO)):
        reg.inc("engine.submitted")
        reg.inc("engine.submitted", 2)
        reg.inc_many(**{"shard.retries": 3, "shard.hedges": 0})
        reg.gauge("aot.compile_seconds", 1.5)
        for v in (5.0, 1.0, 3.0, 2.0, 4.0):
            reg.observe("lat", v)

        class Stats:
            calls = 4
            ok = True
            name = "x"
        mod.sync_struct(reg, "tele", Stats(), ("calls", "ok", "name",
                                               "missing"))
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].quantile("lat", 0.5) == regs[1].quantile("lat", 0.5)
    for q in (0.0, 0.01, 0.5, 0.99, 1.0):
        assert TO.nearest_rank([1.0, 2.0, 3.0], q) == JO.nearest_rank(
            [1.0, 2.0, 3.0], q)
    regs[0].reset("shard.")
    assert "shard.retries" not in regs[0].snapshot()["counters"]


# -- span trees of served batches ------------------------------------------

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


@pytest.fixture(scope="module")
def executors():
    cfg, jcfg = get_smoke("vgg16"), jget_smoke("vgg16")
    npp = _np_params(cfg, 5)
    jex = JEx(jcfg, jax.tree.map(jnp.asarray, npp), precompute=True,
              integrity=JIG.IntegrityPolicy.full(2))
    tex = OrigamiExecutor(cfg, V.params_from_numpy(npp, "cpu"),
                          precompute=True,
                          integrity=TIG.IntegrityPolicy.full(2), device="cpu")
    return cfg, jex, tex


def _tree(tracer, drop_shapes=False):
    by_id = {s.span_id: s for s in tracer.spans()}
    out = []
    for s in tracer.spans():
        attrs = dict(s.attrs)
        if drop_shapes and s.kind == "kernel":
            attrs.pop("shapes", None)
        parent = by_id[s.parent_id].name if s.parent_id in by_id else None
        out.append((s.name, s.kind, parent, attrs, s.t1 is not None))
    return out


def _requests(mod, cfg, n):
    rng = np.random.default_rng(21)
    reqs = []
    for rid in range(n):
        img = (rng.normal(size=(cfg.image_size, cfg.image_size, 3))
               * 0.5).astype(np.float32)
        key = rng.integers(0, 2 ** 32 - 1, size=(2,), dtype=np.uint32)
        box = mod.PrivateInferenceServer.client_seal(key, img, rid)
        reqs.append(mod.Request(rid=rid, box=box, shape=img.shape,
                                session_key=key))
    return reqs


def test_served_batch_span_tree_matches_reference(executors):
    cfg, jex, tex = executors
    tex.attach_aot(CompileCache())           # an executable, as jit
    key = np.asarray(jax.random.PRNGKey(31))
    ttr, jtr = TT.Tracer(), JT.Tracer()
    with ttr.span("request", "request", model=cfg.name, shape=[2, 32, 32, 3]):
        prep = TS.prepare_sealed_batch(_requests(TS, cfg, 2), max_batch=2)
        tboxes, _, _, tinteg = TS.complete_prepared_batch(
            tex, prep, session_key=lambda: key)
    with jtr.span("request", "request", model=cfg.name, shape=[2, 32, 32, 3]):
        jprep = JS.prepare_sealed_batch(_requests(JS, cfg, 2), max_batch=2)
        jboxes, _, _, jinteg = JS.complete_prepared_batch(
            jex, jprep, input_key="images",
            session_key=lambda: jnp.asarray(key))
    assert _tree(ttr) == _tree(jtr)
    names = [s.name for s in ttr.spans()]
    for stage in ("unseal", "session.acquire", "infer", "verify", "seal"):
        assert stage in names
    assert not any(n.startswith(("plan.", "op.")) for n in names)
    # the only kernel spans are the session's factor draws (u = r @ W_q,
    # eager on the request path in both packages when nothing prefetched)
    assert {n for n in names if n.startswith("kernel.")} == {
        "kernel.limb_matmul"}
    assert tinteg.checks == jinteg.checks > 0


def test_eager_infer_span_tree_matches_reference(executors):
    cfg, jex, tex = executors
    x = (np.random.default_rng(8).normal(
        size=(2, cfg.image_size, cfg.image_size, 3)) * 0.5).astype(np.float32)
    key = jax.random.PRNGKey(32)
    ttr, jtr = TT.Tracer(), JT.Tracer()
    with ttr.span("infer", "infer", attempt="blinded"):
        tex.infer({"images": x}, session_key=np.asarray(key), jit=False)
    with jtr.span("infer", "infer", attempt="blinded"):
        jex.infer({"images": jnp.asarray(x)}, session_key=key, jit=False)
    got, want = _tree(ttr, drop_shapes=True), _tree(jtr, drop_shapes=True)
    # first_call follows each executor's own signature memo
    for g, w in zip(got, want):
        g[3].pop("first_call", None)
        w[3].pop("first_call", None)
    assert got == want
    names = [s.name for s in ttr.spans()]
    for inner in ("plan.segment", "op.blinded", "kernel.fused_blind_matmul",
                  "kernel.fold", "kernel.limb_matmul"):
        assert inner in names, inner
    # the port's eager enclave recompute records its ops too (the
    # reference runs that trace only through its executable)
    rtr = TT.Tracer()
    with rtr.span("infer", "infer", attempt="recompute", trusted=True):
        tex.infer({"images": x}, trusted=True, jit=False)
    rnames = [s.name for s in rtr.spans()]
    assert rnames.count("op.trusted") == rnames.count("kernel.limb_matmul") \
        == tex.telemetry_trusted.trusted_matmuls > 0
