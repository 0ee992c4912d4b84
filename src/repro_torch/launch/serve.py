"""Private-inference serving launcher (the paper's deployment, Fig. 3a).

Port of ``repro/launch/serve.py``. Everything runs on the card unless
``--device cpu`` asks for the CPU (where the kernels' plain versions run).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --model vgg16 \
        --requests 16 --mode origami

    # the engine over a mixed vgg16/vgg19 fleet, each response
    # cross-checked bit-exactly against a synchronous server:
    PYTHONPATH=src python -m repro_torch.launch.serve --engine --aot-warm

    # integrity drill: Freivalds-verify every offloaded op while a
    # dishonest device flips bits; every corruption must be detected and
    # recovered (still bit-exact) and the backend quarantined:
    PYTHONPATH=src python -m repro_torch.launch.serve --engine \
        --models vgg16 --verify full --inject bit_flip

    # sharded drill: blinded matmuls row-shard across 2 simulated devices
    # with device 1 dishonest; only its shards are retried and only it is
    # quarantined:
    PYTHONPATH=src python -m repro_torch.launch.serve --engine \
        --models vgg16 --devices 2 --shard rows --inject bit_flip

    # liveness chaos drill: a scripted schedule crashes device 0 and hangs
    # device 1 (the engine degrades to verified enclave-only serving, then
    # recovers through breaker probes), fails session refills and corrupts
    # sealed requests in flight; every future must resolve and every
    # served response stay bit-exact:
    PYTHONPATH=src python -m repro_torch.launch.serve --engine \
        --models vgg16 --devices 2 --chaos

    # any of the above at the smoke size on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.serve --engine --smoke \
        --device cpu

The compile cache is memory only (a CUDA graph cannot be serialized), so
``--compile-cache-dir`` is refused.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs import get_config, get_smoke
from repro_torch.core import plan as PL
from repro_torch.core.integrity import IntegrityPolicy
from repro_torch.core.tracing import Tracer
from repro_torch.models import model as M
from repro_torch.parallel.offload_sharding import LivenessConfig
from repro_torch.privacy.data import make_batch
from repro_torch.runtime.chaos import ChaosController, ChaosSchedule
from repro_torch.runtime.devices import DeviceHealthConfig, DevicePool
from repro_torch.runtime.engine import EngineConfig, ServingEngine
from repro_torch.runtime.faults import DishonestDevice, FaultSpec
from repro_torch.runtime.profiling import FlightRecorder
from repro_torch.runtime.serving import PrivateInferenceServer, Request


def _integrity_args(args):
    """(policy, fault_factory) from the --verify / --inject flags."""
    policy = None
    if args.verify != "off":
        policy = (IntegrityPolicy.full(args.verify_k)
                  if args.verify == "full"
                  else IntegrityPolicy.sampled(args.verify_rate,
                                               args.verify_k))
    def fault():
        if args.inject == "none":
            return None
        return DishonestDevice(FaultSpec(args.inject))
    return policy, fault


def _device_pool(args):
    """A fresh DevicePool per model from --devices/--inject flags.

    With a pool, --inject targets ONE device (--inject-device, default the
    last slot) instead of the executor-wide injector — the "one dishonest
    accelerator in the fleet" drill the tier-1 smoke runs."""
    if not args.devices:
        return None
    faults = {}
    if args.inject != "none":
        bad = (args.inject_device if args.inject_device is not None
               else args.devices - 1)
        assert 0 <= bad < args.devices, (bad, args.devices)
        faults[bad] = DishonestDevice(FaultSpec(args.inject))
    return DevicePool(args.devices, faults=faults)


def _placement_for(cfg, args):
    """Resolve --plan to a PlacementPlan (None = legacy --mode path).

    Accepted specs: a legacy mode name ("origami", "slalom", ...); "mixed"
    (blind the first half of tier-1, enclave-reside the rest — a plan no
    mode string can express); "vopen" (origami prefix + verified-open
    tier-2 linear layers under the --verify policy); or an explicit
    per-layer string over the ``oebv`` alphabet (core/plan.py).
    """
    spec = args.plan
    if spec is None:
        return None
    policy, _ = _integrity_args(args)
    verify = policy or IntegrityPolicy.full(1)
    if spec in PL.LEGACY_MODES:
        return PL.compile_mode(cfg, spec)
    if spec == "mixed":
        return PL.make_mixed(cfg)
    if spec == "vopen":
        return PL.make_vopen(cfg, verify=verify)
    return PL.from_string(cfg, spec, verify=verify)


def _print_plans(names, get) -> None:
    """--plan print: the compiled legacy plans + digests per model."""
    for name in names:
        cfg = get(name)
        print(f"[plan] {name} ({cfg.family}, "
              f"{PL.num_blocks(cfg)} blocks, tier1="
              f"{cfg.origami.tier1_layers}):")
        for mode in PL.LEGACY_MODES:
            print(f"  {mode:8s} {PL.compile_mode(cfg, mode).summary()}")


def _flight_recorder(args):
    """A FlightRecorder for --postmortem-dir (None keeps the engine's
    default in-memory ring)."""
    if not args.postmortem_dir:
        return None
    return FlightRecorder(out_dir=args.postmortem_dir)


def _dump_observability(args, engine, tag) -> None:
    """--metrics-out / --postmortem-dir exit dump: one JSON file with the
    unified registry snapshot, the profiler's phase decomposition and the
    flight recorder's ring summary."""
    rec = engine.recorder.snapshot()
    if args.postmortem_dir:
        print(f"[{tag}] flight recorder: {rec['dumps']} post-mortem "
              f"bundle(s), {rec['suppressed']} suppressed "
              f"-> {args.postmortem_dir}")
    if not args.metrics_out:
        return
    snap = engine.snapshot()
    with open(args.metrics_out, "w") as f:
        json.dump({"metrics": snap["metrics"], "phases": snap["phases"],
                   "aot": snap["aot"], "buckets": snap["buckets"],
                   "ttfb_cold_s": snap["ttfb_cold_s"],
                   "ttfb_warm_s": snap["ttfb_warm_s"],
                   "flight_recorder": rec}, f, indent=2, sort_keys=True,
                  default=str)
    print(f"[{tag}] metrics snapshot "
          f"({len(snap['metrics']['counters'])} counters, "
          f"{len(snap['metrics']['gauges'])} gauges) -> {args.metrics_out}")


def _sealed_requests(cfg, n, rid0=0, rng=None):
    rng = rng or np.random.default_rng(rid0)
    keys, reqs = [], []
    for i in range(n):
        rid = rid0 + i
        img = make_batch(rid, 1, cfg.image_size)[0]
        key = rng.integers(0, 2 ** 32 - 1, size=(2,), dtype=np.uint32)
        box = PrivateInferenceServer.client_seal(key, img, rid)
        keys.append(key)
        reqs.append(Request(rid=rid, box=box, shape=img.shape,
                            session_key=key))
    return reqs, keys


def run_engine(args) -> None:
    """Mixed-model continuous batching: vgg16 + vgg19 through one
    ServingEngine, each request's logits cross-checked bit-exactly against
    a legacy synchronous server of the same model."""
    get = get_smoke if args.smoke else get_config
    names = [m.strip() for m in args.models.split(",") if m.strip()]
    policy, fault = _integrity_args(args)
    tracer = None
    if args.trace_out:
        tracer = Tracer(kernel_spans=args.trace_kernels)
    engine = ServingEngine(
        EngineConfig(max_batch=args.batch, max_wait_ms=args.max_wait_ms,
                     aot_warm=args.aot_warm),
        tracer=tracer, recorder=_flight_recorder(args))
    legacy, per_model = {}, {}
    for i, name in enumerate(names):
        cfg = get(name)
        params = M.init_params(cfg, i, device=args.device)
        pool = _device_pool(args)
        entry = engine.register_model(name, cfg, params, mode=args.mode,
                                      privacy_floor=args.privacy_floor,
                                      integrity=policy,
                                      # with a pool the injector is
                                      # per-DEVICE (pool slots), not
                                      # executor-wide
                                      fault=None if pool else fault(),
                                      placement=_placement_for(cfg, args),
                                      devices=pool, shard=args.shard,
                                      device=args.device)
        print(f"[engine] registered {entry.plan.summary()} "
              f"plan={entry.placement.summary()} "
              f"quote={entry.quote.measurement[:12]}…"
              + (f" devices={pool.size} shard={args.shard}" if pool else ""))
        legacy[name] = PrivateInferenceServer(cfg, params, mode=args.mode,
                                              max_batch=args.batch,
                                              plan=_placement_for(cfg, args),
                                              device=args.device)
        if pool is None:
            # same weights, same cache — but NEVER for pooled runs: the
            # cross-check oracle must stay a genuinely single-device
            # executor, or a sharding bug would corrupt both sides alike
            legacy[name].executor = entry.executor
        per_model[name] = cfg

    # interleave the models' request streams (worst case for a
    # fixed-stride batcher, the normal case for the bucket batcher);
    # disjoint rid spaces per model, keys looked up by rid
    n_each = args.requests // len(names)
    streams, key_by_rid = {}, {}
    for i, m in enumerate(per_model):
        reqs, keys = _sealed_requests(per_model[m], n_each,
                                      rid0=n_each * i)
        streams[m] = (reqs, keys)
        key_by_rid.update({r.rid: k for r, k in zip(reqs, keys)})
    t0 = time.time()
    futures = []
    for j in range(n_each):
        for m in names:
            futures.append((m, j, engine.submit(m, streams[m][0][j])))
    responses = [(m, j, f.result(timeout=300)) for m, j, f in futures]
    dt = time.time() - t0
    ok = sum(r.ok for _, _, r in responses)

    # cross-check: every engine response must be bit-identical to the
    # legacy synchronous server run over the same per-model stream
    mismatches = 0
    for m in names:
        reqs, _ = streams[m]
        want = []
        for i in range(0, n_each, args.batch):
            want += legacy[m].serve_batch(reqs[i:i + args.batch])
        want_logits = {r.rid: PrivateInferenceServer.client_open(
            key_by_rid[r.rid], r.box, (per_model[m].num_classes,))
            for r in want if r.ok}
        for _, j, resp in [t for t in responses if t[0] == m]:
            got = PrivateInferenceServer.client_open(
                key_by_rid[resp.rid], resp.box,
                (per_model[m].num_classes,))
            if not np.array_equal(got, want_logits[resp.rid]):
                mismatches += 1
    order = list(engine.completion_order)
    ooo = any(order[k][0] != order[k + 1][0] for k in range(len(order) - 1))
    stats = engine.stats.snapshot(engine)
    print(f"[engine] {ok}/{len(responses)} ok in {dt:.2f}s "
          f"({dt / max(len(responses), 1) * 1e3:.0f} ms/req) "
          f"batches={stats['batches']} padded={stats['padded_slots']} "
          f"out_of_order={ooo}")
    print(f"[engine] p50={stats['p50_latency_s']:.3f}s "
          f"p95={stats['p95_latency_s']:.3f}s "
          f"ttfb={stats['time_to_first_batch_s']:.3f}s "
          f"(cold={stats['ttfb_cold_s']:.3f}s "
          f"warm={stats['ttfb_warm_s']:.3f}s) "
          f"sessions={stats['sessions']}")
    aot = stats["aot"]
    print(f"[engine] aot: compiles={aot['compiles']} "
          f"memo_hits={aot['memo_hits']} disk_hits={aot['disk_hits']} "
          f"compile_s={aot['compile_seconds']:.2f} "
          f"request_compile_s={aot['request_compile_seconds']:.2f} "
          f"buckets={stats['buckets']}")
    print(f"[engine] bit-identical vs legacy: "
          f"{'OK' if mismatches == 0 else f'{mismatches} MISMATCHES'}")
    integ = stats["integrity"]
    if args.verify != "off":
        print(f"[engine] integrity: checks={integ['verify_checks']} "
              f"failures={integ['verify_failures']} "
              f"retries={integ['device_retries']} "
              f"recomputes={integ['recomputes']} "
              f"quarantines={integ['quarantines']} "
              f"flagged={sum(r.flagged for _, _, r in responses)}")
    if args.devices:
        print(f"[engine] offload plane: shard_checks={integ['shard_checks']} "
              f"shard_failures={integ['shard_failures']} "
              f"shard_retries={integ['shard_retries']} "
              f"shard_hedges={integ['shard_hedges']}")
        for name, snap in stats["devices"].items():
            for s in snap["pool"]["slots"]:
                print(f"[engine]   {name} {s['name']}: "
                      f"dispatches={s['dispatches']} "
                      f"failures={s['verify_failures']} "
                      f"quarantined={s['quarantined']} "
                      f"restores={s['restores']}")
    engine.close()
    if tracer is not None:
        n_events = tracer.dump_chrome(args.trace_out)
        print(f"[engine] trace: {len(tracer.spans())} spans "
              f"({n_events} chrome events, dropped={tracer.dropped}) "
              f"-> {args.trace_out}")
        phases = engine.profile_phases()
        roll = phases.get("critical_s", {})
        top = sorted(roll.items(), key=lambda kv: -kv[1])[:4]
        print(f"[engine] phases ({phases['requests']} requests): "
              + " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in top))
    _dump_observability(args, engine, "engine")
    if mismatches or ok != len(responses):
        raise SystemExit(1)
    if args.devices:
        # the sharded plane always verifies shard-locally
        if integ["shard_checks"] == 0:
            print("[engine] FAIL: sharded plane ran no shard checks")
            raise SystemExit(1)
        if args.inject not in ("none", "adaptive"):
            # drill contract: the dishonest DEVICE was caught shard-locally
            # and ONLY its shards were recovered — re-dispatched to a
            # healthy device in rows mode, enclave-recomputed in shares
            # mode (a share may never visit a second device) — it alone
            # was quarantined, and the model kept offloading on the
            # healthy devices (the bit-exact cross-check above already
            # proved recovery)
            bad = (args.inject_device if args.inject_device is not None
                   else args.devices - 1)
            recovered = (integ["shard_retries"] if args.shard == "rows"
                         else integ["shard_enclave"])
            if integ["shard_failures"] == 0 or recovered == 0:
                print("[engine] FAIL: dishonest device not detected "
                      "shard-locally")
                raise SystemExit(1)
            for name, snap in stats["devices"].items():
                slots = snap["pool"]["slots"]
                if not slots[bad]["quarantined"]:
                    print(f"[engine] FAIL: {name} device {bad} not "
                          "quarantined")
                    raise SystemExit(1)
                healthy = [s for j, s in enumerate(slots) if j != bad]
                if any(s["quarantined"] for s in healthy) or not any(
                        s["dispatches"] > 0 and s["verify_failures"] == 0
                        for s in healthy):
                    print(f"[engine] FAIL: {name} healthy devices not "
                          "serving blinded offload")
                    raise SystemExit(1)
                if stats["models"][name]["quarantined"]:
                    print(f"[engine] FAIL: {name} quarantined per-model — "
                          "expected per-device only")
                    raise SystemExit(1)
    if args.verify != "off" and integ["verify_checks"] == 0:
        print("[engine] FAIL: verification enabled but no checks ran")
        raise SystemExit(1)
    if args.inject == "adaptive" and args.verify != "off":
        # the adaptive adversary corrupts only unchecked ops: under full
        # (or sampled at rate 1.0) it is neutralized — zero corruptions,
        # zero failures IS the success condition (the bit-exact cross-check
        # above already proved no corruption slipped through); under a
        # sparser sampled policy it evades by design, so detection cannot
        # be asserted either way.
        print("[engine] adaptive drill: evasion bounded by policy "
              f"(failures={integ['verify_failures']}), responses bit-exact")
    elif args.inject != "none" and args.verify != "off" and not args.devices:
        # the drill contract: the injected faults were caught (nonzero
        # failed checks) AND every response above was still bit-exact.
        # (With --devices the injector is per-device and recovery is
        # shard-local — no op-level failure or recompute ever happens;
        # that drill's contract is asserted in the sharded block above.)
        if integ["verify_failures"] == 0 or integ["recomputes"] == 0:
            print("[engine] FAIL: injected faults were not detected")
            raise SystemExit(1)


def run_chaos(args) -> None:
    """Liveness chaos drill: serial request stream through
    the engine while a scripted ChaosSchedule crashes/hangs devices, fails
    session refills and corrupts sealed requests in flight.

    The chaos invariant asserted here: every submitted future resolves,
    the engine never stops serving (degrading to verified enclave-only
    when every device is benched, recovering via breaker half-open
    probes), every non-seal-window response is bit-exact against a
    healthy single-device oracle, and seal-window requests fail with
    ``mac_failed`` and nothing else."""
    get = get_smoke if args.smoke else get_config
    name = [m.strip() for m in args.models.split(",") if m.strip()][0]
    cfg = get(name)
    params = M.init_params(cfg, 0, device=args.device)

    schedule = ChaosSchedule.parse(args.chaos)
    dev_events = [ev for ev in schedule.events if ev.layer == "device"]
    for ev in dev_events:
        if ev.device >= args.devices:
            raise SystemExit(f"[chaos] schedule targets dev{ev.device} but "
                             f"--devices {args.devices}")
    kinds = {ev.kind for ev in dev_events}
    refill_scheduled = any(ev.layer == "refill" for ev in schedule.events)
    seal_batches = {b for ev in schedule.events if ev.layer == "seal"
                    for b in range(ev.start, ev.stop + 1)}
    # a batch where EVERY device is under an armed fault must degrade the
    # engine to enclave-only serving (the assertion below keys off this)
    blackout = any(
        {ev.device for ev in dev_events if ev.active(b)}
        == set(range(args.devices))
        for b in range(schedule.horizon))

    per = args.batch
    n_batches = schedule.horizon + args.chaos_margin
    reqs, keys = _sealed_requests(cfg, per * n_batches)
    key_by_rid = {r.rid: k for r, k in zip(reqs, keys)}

    # healthy oracle FIRST (chaos mutates seal-window request MACs in
    # flight, so the oracle must see the pristine boxes), on a genuinely
    # single-device executor so a plane bug can't corrupt both sides
    # alike; grouped in the engine's exact batches
    oracle = PrivateInferenceServer(cfg, params, mode=args.mode,
                                    max_batch=per, device=args.device)
    want = {}
    for j in range(n_batches):
        for r in oracle.serve_batch(reqs[per * j:per * (j + 1)]):
            assert r.ok, f"oracle failed on rid={r.rid}"
            want[r.rid] = PrivateInferenceServer.client_open(
                key_by_rid[r.rid], r.box, (cfg.num_classes,))

    pool = DevicePool(args.devices,
                      health=DeviceHealthConfig(breaker_after=2,
                                                breaker_cooldown=2))
    chaos = ChaosController(schedule)
    tracer = None
    if args.trace_out:
        tracer = Tracer(kernel_spans=args.trace_kernels)
    engine = ServingEngine(EngineConfig(max_batch=per, max_wait_ms=50.0),
                           tracer=tracer, recorder=_flight_recorder(args))
    engine.register_model(name, cfg, params, mode=args.mode,
                          devices=pool, shard=args.shard,
                          liveness=LivenessConfig(cold_timeout_s=2.0),
                          chaos=chaos, device=args.device)
    print(f"[chaos] schedule={schedule} horizon={schedule.horizon} "
          f"batches={n_batches}x{per} devices={args.devices}")

    t0 = time.time()
    timeline, ok_served = [], 0
    for j in range(n_batches):
        futs = [engine.submit(name, r) for r in reqs[per * j:per * (j + 1)]]
        resps = [f.result(timeout=120) for f in futs]
        snap = engine.snapshot()
        degraded = snap["models"][name]["degraded"]
        timeline.append((j, resps, degraded))
        ok_served += sum(r.ok for r in resps)
        if refill_scheduled and any(
                ev.layer == "refill" and ev.active(j)
                for ev in schedule.events):
            # the refill thread is async: give it a beat to hit the armed
            # window (bounded — the drill stays deterministic in outcome)
            for _ in range(40):
                if chaos.refill_faults > 0:
                    break
                time.sleep(0.05)
        time.sleep(args.chaos_pace)
    dt = time.time() - t0

    snap = engine.snapshot()
    liv = snap["liveness"]
    slots = next(iter(snap["devices"].values()))["pool"]["slots"]
    marks = "".join("D" if d else ("X" if not all(r.ok for r in rs)
                                   else ".")
                    for _, rs, d in timeline)
    print(f"[chaos] timeline [{marks}]  (.=ok D=degraded X=rejected)")
    for b, label, action in chaos.log:
        print(f"[chaos]   batch {b}: {action} {label}")
    print(f"[chaos] {ok_served}/{per * n_batches} ok in {dt:.1f}s "
          f"(goodput {ok_served / dt:.1f} req/s) liveness={liv} "
          f"refill_errors={snap['refill_errors']} "
          f"seal_corruptions={chaos.seal_corruptions}")
    for s in slots:
        print(f"[chaos]   {s['name']}: breaker={s['breaker']} "
              f"opens={s['breaker_opens']} probes={s['breaker_probes']} "
              f"closes={s['breaker_closes']} abandons={s['abandons']} "
              f"available={s['available']}")
    engine.close()
    if tracer is not None:
        n_events = tracer.dump_chrome(args.trace_out)
        print(f"[chaos] trace: {len(tracer.spans())} spans "
              f"({n_events} chrome events) -> {args.trace_out}")
    _dump_observability(args, engine, "chaos")

    # the chaos invariant, clause by clause
    fails = []
    if chaos.batch != n_batches - 1:
        fails.append(f"chaos clock drift: controller saw batch "
                     f"{chaos.batch}, drill drove {n_batches} "
                     f"(partial flush?) — scripted windows shifted")
    for j, resps, _ in timeline:
        for resp in resps:
            if j in seal_batches:
                if resp.ok or resp.error != "mac_failed":
                    fails.append(f"batch {j} rid={resp.rid}: seal-window "
                                 f"request not rejected with mac_failed "
                                 f"(ok={resp.ok}, error={resp.error})")
            elif not resp.ok:
                fails.append(f"batch {j} rid={resp.rid}: rejected outside "
                             f"any seal window (error={resp.error})")
            elif not np.array_equal(
                    PrivateInferenceServer.client_open(
                        key_by_rid[resp.rid], resp.box,
                        (cfg.num_classes,)),
                    want[resp.rid]):
                fails.append(f"batch {j} rid={resp.rid}: logits not "
                             f"bit-exact vs oracle")
    if blackout:
        if liv["degradations"] == 0:
            fails.append("total device blackout never degraded the engine "
                         "to enclave-only serving")
        if liv["recoveries"] == 0 or snap["models"][name]["degraded"]:
            fails.append("engine did not recover from degraded mode")
    if "crash" in kinds and liv["shard_crashes"] == 0:
        fails.append("crash scheduled but no shard crash contained")
    if "hang" in kinds and liv["shard_timeouts"] == 0:
        fails.append("hang scheduled but no dispatch timeout fired")
    if dev_events:
        if not any(s["breaker_opens"] > 0 for s in slots):
            fails.append("device faults scheduled but no breaker opened")
        bad = [s["name"] for s in slots if not s["available"]]
        if bad:
            fails.append(f"devices still benched after recovery margin: "
                         f"{bad}")
    if refill_scheduled and (chaos.refill_faults == 0
                             or snap["refill_errors"] == 0):
        fails.append("refill faults scheduled but none contained")
    if seal_batches and chaos.seal_corruptions == 0:
        fails.append("seal corruption scheduled but never applied")
    if chaos.snapshot()["armed"]:
        fails.append(f"events still armed: {chaos.snapshot()['armed']}")
    for f in fails:
        print(f"[chaos] FAIL: {f}")
    if fails:
        raise SystemExit(1)
    print("[chaos] OK: every future resolved, degradation/recovery as "
          "scheduled, all served logits bit-exact")


DEFAULT_CHAOS = "dev0.crash@1-2,dev1.hang@1-2,refill@7-8,seal@10"


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Private-inference serving launcher of the PyTorch port")
    ap.add_argument("--model", default="vgg16")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the executors (default cuda; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--mode", default="origami",
                    choices=("open", "enclave", "split", "slalom", "origami"))
    ap.add_argument("--requests", type=int, default=None,
                    help="default: 16 (legacy loop) / 32 (--engine, the "
                         "mixed-smoke acceptance floor)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--engine", action="store_true",
                    help="drive the async ServingEngine over --models")
    ap.add_argument("--models", default="vgg16,vgg19",
                    help="comma list for --engine (mixed traffic)")
    ap.add_argument("--max-wait-ms", type=float, default=50.0)
    ap.add_argument("--compile-cache-dir", default=None, metavar="DIR",
                    help="refused: the compile cache is memory only, a "
                         "CUDA graph cannot be serialized (a restart "
                         "captures each (trace kind, bucket) again; "
                         "--aot-warm moves that to registration)")
    ap.add_argument("--aot-warm", action="store_true",
                    help="with --engine, capture every (model, trace kind, "
                         "shape bucket) executable (a CUDA graph on the "
                         "card) at register_model time, so the first "
                         "request never pays a capture")
    ap.add_argument("--plan", default=None,
                    help="per-layer PlacementPlan (core/plan.py): 'print' "
                         "lists compiled plans; a legacy mode name; "
                         "'mixed' (enclave/blinded tier-1); 'vopen' "
                         "(verified-open tier-2); or an explicit oebv "
                         "per-layer string. Overrides --mode.")
    ap.add_argument("--privacy-floor", type=float, default=None,
                    help="SSIM leakage floor for the partition planner "
                         "(default: use the config's declared partition)")
    ap.add_argument("--verify", default="off",
                    choices=("off", "sampled", "full"),
                    help="Freivalds verification policy over offloaded "
                         "field matmuls")
    ap.add_argument("--verify-rate", type=float, default=0.25,
                    help="per-op check probability under --verify sampled")
    ap.add_argument("--verify-k", type=int, default=1,
                    help="Freivalds repetitions (soundness 1-p^-k)")
    ap.add_argument("--inject", default="none",
                    choices=("none", "bit_flip", "row_swap", "stale",
                             "adaptive"),
                    help="dishonest-device drill: corrupt every offloaded "
                         "op with this fault class (runtime/faults.py)")
    ap.add_argument("--devices", type=int, default=0,
                    help="shard blinded offload across N simulated devices "
                         "(runtime/devices.py DevicePool + "
                         "parallel/offload_sharding.py); 0 = single-device "
                         "path. Requires --engine.")
    ap.add_argument("--shard", default="rows", choices=("rows", "shares"),
                    help="shard geometry: row-shard the blinded operand, "
                         "or additive secret shares (no single device sees "
                         "the full blinded tensor)")
    ap.add_argument("--inject-device", type=int, default=None,
                    help="with --devices, the slot --inject corrupts "
                         "(default: the last device)")
    ap.add_argument("--chaos", nargs="?", const=DEFAULT_CHAOS, default=None,
                    help="liveness chaos drill (runtime/chaos.py): a "
                         "scripted schedule like "
                         "'dev0.crash@1-2,dev1.hang@1-2,refill@7-8,seal@10' "
                         f"(no value = '{DEFAULT_CHAOS}'). Requires "
                         "--engine and --devices.")
    ap.add_argument("--chaos-margin", type=int, default=10,
                    help="recovery batches served past the schedule "
                         "horizon (breaker half-open probes need a few)")
    ap.add_argument("--chaos-pace", type=float, default=0.02,
                    help="inter-batch sleep in the chaos drill")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON span tree of "
                         "the run (core/tracing.py): request admission -> "
                         "micro-batch -> plan steps -> shard dispatches -> "
                         "verify -> seal, redacted to shapes/timings. "
                         "Requires --engine.")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the unified metrics-registry snapshot plus "
                         "the profiler's phase decomposition as JSON at "
                         "exit. Requires --engine.")
    ap.add_argument("--postmortem-dir", default=None, metavar="DIR",
                    help="write redaction-safe flight-recorder post-mortem "
                         "bundles (last spans + metric deltas + engine "
                         "events) on quarantine/breaker-open/degradation/"
                         "verify-failure. Requires --engine.")
    ap.add_argument("--trace-kernels", action="store_true",
                    help="with --trace-out, also record fenced wall-time "
                         "kernel spans (blind_encode/limb_matmul/fold) — "
                         "adds device synchronizations, so only for "
                         "profiling runs")
    args = ap.parse_args(argv)
    if args.compile_cache_dir:
        ap.error("--compile-cache-dir: the compile cache is memory only "
                 "(a CUDA graph cannot be serialized); use --aot-warm to "
                 "capture every executable at registration")
    if args.devices and not args.engine:
        ap.error("--devices requires --engine")
    if args.trace_out and not args.engine:
        ap.error("--trace-out requires --engine")
    if args.chaos is not None and (not args.engine or args.devices < 1):
        ap.error("--chaos requires --engine and --devices >= 1")
    if (args.metrics_out or args.postmortem_dir) and not args.engine:
        ap.error("--metrics-out/--postmortem-dir require --engine")
    if args.aot_warm and not args.engine:
        ap.error("--aot-warm requires --engine")

    if args.requests is None:
        args.requests = 32 if args.engine else 16
    if args.plan == "print":
        get = get_smoke if args.smoke else get_config
        names = ([m.strip() for m in args.models.split(",") if m.strip()]
                 if args.engine else [args.model])
        _print_plans(names, get)
        return
    if args.chaos is not None:
        run_chaos(args)
        return
    if args.engine:
        run_engine(args)
        return

    cfg = get_smoke(args.model) if args.smoke else get_config(args.model)
    params = M.init_params(cfg, 0, device=args.device)
    policy, fault = _integrity_args(args)
    server = PrivateInferenceServer(cfg, params, mode=args.mode,
                                    max_batch=args.batch,
                                    integrity=policy, fault=fault(),
                                    plan=_placement_for(cfg, args),
                                    device=args.device)

    # client: attest, then send sealed requests
    quote = server.attest()
    print(f"[serve] attested enclave measurement={quote.measurement[:16]}… "
          f"partition={quote.partition} mode={args.mode}")
    reqs, keys = _sealed_requests(cfg, args.requests)
    t0 = time.time()
    try:
        responses = server.serve(reqs)
    finally:
        server.close()
    dt = time.time() - t0
    ok = sum(r.ok for r in responses)
    # client decrypts a response to verify the loop
    r0 = next(r for r in responses if r.ok)
    logits = PrivateInferenceServer.client_open(
        keys[r0.rid], r0.box, (cfg.num_classes,))
    print(f"[serve] {ok}/{len(responses)} ok in {dt:.2f}s "
          f"({dt/max(len(responses),1)*1e3:.0f} ms/req); "
          f"logits[:3]={np.round(logits[:3], 3)}")
    tele = server.executor.telemetry
    print(f"[serve] telemetry: blinded={tele.blinded_bytes/1e6:.2f}MB "
          f"offloaded={tele.offloaded_flops/1e9:.2f}GFLOP "
          f"calls={tele.calls}")
    if args.verify != "off":
        it = server.integrity_totals
        print(f"[serve] integrity: checks={it.checks} "
              f"failures={it.failures} retries={it.retries} "
              f"recomputes={it.recomputes}")
    if ok != len(responses):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
