"""The port's performance attribution (``runtime/profiling.py``) against
the JAX reference on the CPU: the same hand-built span trees fold into the
same phase profiles, reports, compile estimates and cost observations in
both packages (exact), and the flight recorder keeps its ring, its dump
bundles, its rate limit and its redaction (torch tensors rejected). A tree
recorded by the port's own serving stages folds too, and the planner
calibrates from it.
"""
import json

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

pytest.importorskip("jax")

from repro.core import tracing as JT  # noqa: E402
from repro.runtime import observability as JO  # noqa: E402
from repro.runtime import profiling as JP  # noqa: E402
from repro_torch.core import tracing as TT  # noqa: E402
from repro_torch.runtime import observability as TO  # noqa: E402
from repro_torch.runtime import profiling as TP  # noqa: E402

PAIRS = [(TT, TP, TO), (JT, JP, JO)]


class FakeTracer:
    """Hand-built span store: ``ingest`` only needs ``spans()``."""

    def __init__(self, spans):
        self._spans = list(spans)
        self.dropped = 0

    def spans(self):
        return list(self._spans)


def _span(tr, sid, parent, name, t0, t1, kind="step", **attrs):
    return tr.Span(trace_id=1, span_id=sid, parent_id=parent, name=name,
                   kind=kind, t0=t0, t1=t1, attrs=attrs)


def _tree(tr, rid=1, t0=0.0, infer_dur=1.0, first_call=False, base_sid=0,
          flops=1000):
    """request(4 s) -> queue(1 s) + batch -> unseal(0.5) + infer + seal."""
    sid = base_sid
    return [
        _span(tr, sid + 1, None, "request", t0, t0 + 4.0, model="m",
              plan="abc", shape=[8, 8, 3], rid=rid),
        _span(tr, sid + 2, sid + 1, "queue", t0, t0 + 1.0),
        _span(tr, sid + 3, sid + 1, "batch", t0 + 1.0, t0 + 3.5, plan="abc"),
        _span(tr, sid + 4, sid + 3, "unseal", t0 + 1.0, t0 + 1.5),
        _span(tr, sid + 5, sid + 3, "infer", t0 + 1.5, t0 + 1.5 + infer_dur,
              first_call=first_call, device_flops=flops, blind_bytes=64,
              unblind_bytes=32),
        _span(tr, sid + 6, sid + 3, "seal", t0 + 3.2, t0 + 3.5),
    ]


def _parallel(tr):
    return [
        _span(tr, 1, None, "request", 0.0, 3.0, model="m", plan="d",
              shape=[4]),
        _span(tr, 2, 1, "shard.matmul", 0.0, 3.0),
        _span(tr, 3, 2, "shard.dispatch", 0.5, 2.0),
        _span(tr, 4, 2, "shard.dispatch", 1.0, 2.5),
    ]


def _compile_trees(tr):
    spans = _tree(tr, rid=1, infer_dur=1.7, first_call=True)
    for i in range(3):
        spans += _tree(tr, rid=2 + i, t0=10.0 * (i + 1), infer_dur=0.5,
                       base_sid=100 * (i + 1))
    return spans


def _junk(tr):
    return [_span(tr, 1, None, "request", 0.0, None, model="m"),
            _span(tr, 2, None, "batch", 0.0, 1.0)]


CASES = {"tree": _tree, "parallel": _parallel, "compile": _compile_trees,
         "unfinished": _junk}


@pytest.mark.parametrize("case", sorted(CASES))
def test_profiler_folds_like_the_reference(case):
    out = []
    for tr, prof_mod, obs_mod in PAIRS:
        prof = prof_mod.CriticalPathProfiler()
        n = prof.ingest(FakeTracer(CASES[case](tr)))
        again = prof.ingest(FakeTracer(CASES[case](tr)))
        reg = obs_mod.MetricsRegistry()
        prof.export_gauges(reg)
        out.append((n, again, prof.report(), prof.cost_observations(),
                    reg.snapshot()))
    assert out[0] == out[1]
    assert out[0][1] == 0                         # ingest is incremental


def test_fold_attributes_every_instant_exactly_once():
    prof = TP.CriticalPathProfiler()
    assert prof.ingest(FakeTracer(_tree(TT))) == 1
    (key, p), = prof.profiles.items()
    assert key == ("m", "abc", "8x8x3")
    crit = p.critical_s
    assert crit["queue_wait"] == pytest.approx(1.0)
    assert crit["unseal"] == pytest.approx(0.5)
    assert crit["device_compute"] == pytest.approx(1.0)
    assert crit["seal"] == pytest.approx(0.3)
    assert crit["other"] == pytest.approx(1.2)
    assert sum(crit.values()) == pytest.approx(p.wall_s) == pytest.approx(4.0)


def test_compile_isolation_first_call_minus_warm_median():
    prof = TP.CriticalPathProfiler()
    prof.ingest(FakeTracer(_compile_trees(TT)))
    p = prof.profiles[("m", "abc", "8x8x3")]
    assert p.compile_s == pytest.approx(1.2)
    summ = p.summary()
    assert summ["critical_s"]["compile"] == pytest.approx(1.2)
    assert summ["critical_sum_s"] == pytest.approx(summ["wall_s"])


def test_phase_taxonomy_and_intervals_match_reference():
    names = ("queue", "compile.aot", "unseal", "seal", "session.acquire",
             "kernel.blind_encode", "kernel.fused_blind_matmul",
             "kernel.limb_matmul", "kernel.unblind", "kernel.fold",
             "op.blinded", "op.trusted", "shard.matmul", "shard.dispatch",
             "shard.enclave", "infer", "plan.segment", "verify", "batch",
             "request", "some.future.span")
    assert TP.PHASES == JP.PHASES
    assert [TP.phase_of(n) for n in names] == [JP.phase_of(n) for n in names]
    for iv in ([], [(0, 1), (2, 3)], [(0, 2), (1, 3), (2.5, 4)],
               [(1, 2), (0, 5)]):
        assert TP._merge_intervals(iv) == JP._merge_intervals(iv)


def _recorder_script(tr_mod, prof_mod, obs_mod, out_dir):
    rec = prof_mod.FlightRecorder(capacity=4, out_dir=str(out_dir),
                                  min_interval_s=0.0)
    for i in range(6):
        rec.event("shard_crash", device="dev0", i=i)
    tr = tr_mod.Tracer()
    tr.end(tr.start_span("request", "request", model="m"))
    reg = obs_mod.MetricsRegistry()
    reg.inc("integrity.quarantines")
    b1 = rec.dump("quarantine", tracer=tr, registry=reg, model="m")
    reg.inc("integrity.quarantines", 2)
    b2 = rec.dump("quarantine", tracer=tr, registry=reg)
    strip = ("ts_unix",)
    return ([{k: v for k, v in b.items() if k not in strip}
             for b in (b1, b2)], rec.snapshot(),
            sorted(f.name for f in out_dir.glob("postmortem_*.json")))


def test_flight_recorder_matches_reference(tmp_path):
    got = []
    for i, (tr_mod, prof_mod, obs_mod) in enumerate(PAIRS):
        d = tmp_path / str(i)
        bundles, snap, files = _recorder_script(tr_mod, prof_mod, obs_mod, d)
        for b in bundles:
            b["events"] = [{k: v for k, v in ev.items() if k != "t"}
                           for ev in b["events"]]
            b["spans"] = [{k: v for k, v in sp.items()
                           if k not in ("trace_id", "span_id", "t0", "t1",
                                        "tid")} for sp in b["spans"]]
        got.append((bundles, snap, files))
        json.loads((d / files[0]).read_text())
    assert got[0] == got[1]
    bundles = got[0][0]
    assert [e["attrs"]["i"] for e in bundles[0]["events"]] == [2, 3, 4, 5]
    assert bundles[1]["metrics"]["counter_delta"] == {
        "integrity.quarantines": 2}


def test_flight_recorder_rate_limits_and_caps(tmp_path):
    rec = TP.FlightRecorder(min_interval_s=3600.0)
    assert rec.dump("verify_failure") is not None
    assert rec.dump("verify_failure") is None
    assert rec.dump("degradation") is not None
    assert rec.suppressed == 1
    cap = TP.FlightRecorder(out_dir=str(tmp_path), min_interval_s=0.0,
                            max_dumps=2)
    for _ in range(4):
        cap.dump("manual")
    assert len(list(tmp_path.glob("*.json"))) == 2
    assert cap.snapshot()["dumps"] == 4


def test_flight_recorder_redaction_fails_closed():
    rec = TP.FlightRecorder()
    for bad in (torch.arange(8), np.arange(8), b"key"):
        with pytest.raises(TT.RedactionError):
            rec.event("oops", payload=bad)
    assert len(rec.events) == 0
    with pytest.raises(TT.RedactionError):
        rec.dump("manual", secret=torch.ones(2))


def test_served_trees_fold_and_calibrate_the_planner():
    """Requests served by the port's stages under its tracer fold into one
    profile whose phases sum to the wall, and the planner re-prices from
    the warm trees (the first call is left out of the fit)."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.integrity import IntegrityPolicy
    from repro_torch.core.origami import OrigamiExecutor
    from repro_torch.core.planner import PartitionPlanner
    from repro_torch.core.trust import EnclaveParams
    from repro_torch.models import vgg as V
    from repro_torch.runtime.serving import (PrivateInferenceServer, Request,
                                             complete_prepared_batch,
                                             prepare_sealed_batch)
    cfg = get_smoke("vgg16")
    ex = OrigamiExecutor(cfg, V.init_params(cfg, 0, device="cpu"),
                         precompute=True, integrity=IntegrityPolicy.full(1),
                         device="cpu")
    tracer = TT.Tracer()
    rng = np.random.default_rng(0)
    for rid in range(3):
        img = rng.random((cfg.image_size, cfg.image_size, 3), np.float32)
        key = rng.integers(0, 2 ** 32 - 1, size=(2,), dtype=np.uint32)
        req = Request(rid, PrivateInferenceServer.client_seal(key, img, rid),
                      img.shape, key)
        with tracer.span("request", "request", model=cfg.name,
                         plan=ex.plan.digest, shape=[1, *img.shape]):
            prep = prepare_sealed_batch([req], max_batch=1)
            complete_prepared_batch(ex, prep, session_key=np.asarray(
                [rid, 7], np.uint32))
    prof = TP.CriticalPathProfiler()
    assert prof.ingest(tracer) == 3
    (key, p), = prof.profiles.items()
    assert key == (cfg.name, ex.plan.digest, "1x32x32x3")
    assert sum(p.critical_s.values()) == pytest.approx(p.wall_s)
    obs = prof.cost_observations()
    assert len(obs) == 2                          # the first call excluded
    assert obs[0][0]["device_flops"] > 0
    planner = PartitionPlanner()
    fitted = planner.calibrate(prof)
    assert isinstance(fitted, EnclaveParams)
    assert fitted != EnclaveParams() and planner.enclave_params is fitted
