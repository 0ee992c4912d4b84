"""Trust domains and the enclave cost/residency model.

Port of ``repro/core/trust.py`` (a copy: it has no framework code, and the
port imports nothing of the reference). There is no SGX part, so absolute
enclave timings are *modeled*, calibrated to the paper's own measurements
(§VI), while all byte/FLOP quantities are computed from the model configs.

Calibration constants (from the paper):
  - blinding/unblinding throughput: 6 MB per 4 ms          (§VI-C)
  - GPU ≈ 49× CPU on VGG inference (321× / 6.5×)           (§III-A)
  - enclave(JIT-loading) ≈ CPU / 6.4..6.5                  (Fig. 2)
  - enclave pre-loaded ≈ CPU / 16.7..18.3 (paging-bound)   (Fig. 2)
  - power-event recovery ≈ re-init + EPC re-encryption      (Table II)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class EnclaveParams:
    """Calibrated so the VGG-16 strategy costs land on the paper's numbers
    (see benchmarks/paper_fig9_10.py for the target-vs-model table)."""
    epc_limit_mb: float = 128.0
    epc_usable_mb: float = 93.0
    cpu_flops: float = 1.0e11          # effective CPU conv/matmul throughput
    gpu_speedup: float = 49.0          # paper: 321x / 6.5x
    sgx_slowdown: float = 5.2          # compute-only slowdown (solved from
                                       # Split/6 ≈ 4x, Fig. 4)
    blind_bytes_per_s: float = 6e6 / 4e-3   # 1.5 GB/s (§VI-C, 4ms/6MB)
    # enclave elementwise/copy bandwidth (EPC-bound ReLU, quantize, ECALL
    # copies) — solved from Slalom = enclave/10 (Fig. 9)
    enclave_mem_bytes_per_s: float = 0.9e9
    # lazy-load paging of >8MB dense layers — solved from enclave = 6.4x CPU
    paging_bytes_per_s: float = 1.47e9
    epc_init_bytes_per_s: float = 86e6 / 0.190     # Table II: ~201ms/86MB
    recovery_base_s: float = 0.012
    runtime_overhead_mb: float = 4.0
    # per-offloaded-op host dispatch overhead (ECALL/OCALL transition +
    # host-side fan-out). The paper folds this into its throughputs, so
    # the calibrated default is 0.0 — keeping every Fig 9/10 number
    # bit-identical; CalibratedCostModel fits a measured value from the
    # profiler's dispatch_wait phase.
    dispatch_overhead_s: float = 0.0

    @property
    def gpu_flops(self) -> float:
        return self.cpu_flops * self.gpu_speedup

    @property
    def sgx_flops(self) -> float:
        return self.cpu_flops / self.sgx_slowdown


@dataclass
class LayerProfile:
    name: str
    flops: int                 # linear-op FLOPs
    param_bytes: int
    out_bytes: int             # output feature-map bytes (batch 1, fp32)
    linear: bool               # offloadable under blinding?


def vgg_layer_profiles(cfg: ModelConfig) -> List[LayerProfile]:
    from repro_torch.models.vgg import _parse
    h = w = cfg.image_size
    c = cfg.image_channels
    out: List[LayerProfile] = []
    flat = None
    for spec in cfg.cnn_layers:
        kind, n = _parse(spec)
        if kind == "conv":
            flops = 2 * h * w * 9 * c * n
            pbytes = (9 * c * n + n) * 4
            c = n
            obytes = h * w * c * 4
            out.append(LayerProfile(spec, flops, pbytes, obytes, True))
        elif kind == "pool":
            h, w = h // 2, w // 2
            obytes = h * w * c * 4
            out.append(LayerProfile(spec, h * w * c * 4 // 4, 0, obytes,
                                    False))
        else:
            d_in = flat if flat is not None else h * w * c
            d_out = n if kind == "fc" else cfg.num_classes
            flops = 2 * d_in * d_out
            out.append(LayerProfile(spec, flops, (d_in * d_out + d_out) * 4,
                                    d_out * 4, True))
            flat = d_out
    return out


@dataclass
class StrategyCost:
    name: str
    runtime_s: float
    enclave_resident_mb: float
    recovery_s: float
    breakdown: Dict[str, float]


class EnclaveSim:
    """Prices an execution strategy for a CNN model on (SGX + device)."""

    def __init__(self, cfg: ModelConfig, params: EnclaveParams = None,
                 device: str = "gpu"):
        self.cfg = cfg
        self.p = params or EnclaveParams()
        self.device_flops = (self.p.gpu_flops if device == "gpu"
                             else self.p.cpu_flops)
        self.layers = vgg_layer_profiles(cfg)

    # -- residency (Table I) ------------------------------------------------
    def residency_bytes(self, mode: str, partition: int) -> float:
        L = self.layers
        p = self.p
        act = max(l.out_bytes for l in L)                  # working buffer
        overhead = p.runtime_overhead_mb * 2 ** 20
        if mode == "enclave":
            # baseline 2: convs resident; >8MB FC layers lazy-load in slices
            conv_params = sum(l.param_bytes for l in L
                              if not l.name.startswith(("fc", "logits")))
            return conv_params + 8 * 2 ** 20 + act + overhead
        if mode == "split":
            return (sum(l.param_bytes for l in L[:partition]) + 2 * act
                    + overhead)
        if mode in ("slalom", "origami"):
            blind_layers = L[:partition] if mode == "origami" else L
            feat = max((l.out_bytes for l in blind_layers), default=act)
            # blinding-factor buffer (paper: ~12MB) + quantized feature + act
            return feat + 12 * 2 ** 20 + act + overhead
        return 0.0

    # -- runtime (Figs 9/10/12/13) -------------------------------------------
    def runtime(self, mode: str, partition: int) -> StrategyCost:
        p = self.p
        L = self.layers
        t_enclave = t_device = t_blind = t_page = t_disp = 0.0
        resident = self.residency_bytes(mode, partition)

        for i, l in enumerate(L):
            in_tier1 = i < partition
            if mode == "open":
                t_device += l.flops / self.device_flops
            elif mode == "enclave":
                t_enclave += l.flops / p.sgx_flops
                if (l.name.startswith(("fc", "logits"))
                        and l.param_bytes > 8 * 2 ** 20):   # lazy-loaded FC
                    t_page += l.param_bytes / p.paging_bytes_per_s
            elif mode == "split":
                if in_tier1:
                    t_enclave += l.flops / p.sgx_flops
                else:
                    t_device += l.flops / self.device_flops
            elif mode in ("slalom", "origami"):
                blinded = (mode == "slalom") or in_tier1
                if blinded and l.linear:
                    t_device += l.flops / self.device_flops
                    # blind+unblind passes and the EPC-bound elementwise /
                    # copy work (quantize, ReLU, ECALL buffers)
                    t_blind += 2 * l.out_bytes / p.blind_bytes_per_s
                    t_enclave += 2 * l.out_bytes / p.enclave_mem_bytes_per_s
                    t_disp += p.dispatch_overhead_s
                elif blinded:                       # pool etc. in enclave
                    t_enclave += l.out_bytes / p.enclave_mem_bytes_per_s
                else:
                    t_device += l.flops / self.device_flops
        total = t_enclave + t_device + t_blind + t_page + t_disp
        return StrategyCost(
            name=mode,
            runtime_s=total,
            enclave_resident_mb=resident / 2 ** 20,
            recovery_s=self.recovery_s(resident),
            breakdown={"enclave": t_enclave, "device": t_device,
                       "blind": t_blind, "paging": t_page,
                       "dispatch": t_disp})

    def recovery_s(self, resident_bytes: float) -> float:
        return (self.p.recovery_base_s
                + resident_bytes / self.p.epc_init_bytes_per_s)

    def all_strategies(self, partition: int) -> Dict[str, StrategyCost]:
        return {m: self.runtime(m, partition)
                for m in ("open", "enclave", "split", "slalom", "origami")}

    # -- PlacementPlan pricing (core/plan.py, DESIGN.md §10) -----------------
    def plan_runtime(self, plan) -> StrategyCost:
        """Price an arbitrary PlacementPlan per-step.

        Plans that are exactly a legacy prefix shape delegate to
        ``runtime(mode, p)`` — bit-identical to the paper-calibrated
        per-mode formulas. Mixed plans walk the steps: open → device
        FLOPs (+ quantize/fold elementwise when verified-open); enclave →
        SGX FLOPs (paging for >8MB fc weights); blinded linear → device
        FLOPs + blind traffic + EPC elementwise. Non-linear enclave steps
        are EPC-bandwidth-bound whenever the plan offloads anything (the
        enclave is then a thin elementwise stage between device matmuls),
        FLOPs-bound in a pure-enclave deployment — matching the legacy
        enclave/slalom formulas at both endpoints.
        """
        from repro_torch.core.plan import classify_legacy
        legacy = classify_legacy(plan)
        if legacy is not None:
            mode, p_cut = legacy
            cost = self.runtime(mode, p_cut)
            return StrategyCost(plan.mode_label, cost.runtime_s,
                                cost.enclave_resident_mb, cost.recovery_s,
                                cost.breakdown)
        p = self.p
        L = self.layers
        assert len(L) == plan.n_layers, (len(L), plan.n_layers)
        epc_bound = plan.has_offload
        t_enclave = t_device = t_blind = t_page = t_disp = 0.0
        for st, l in zip(plan.steps, L):
            if st.placement == "blinded" and l.linear:
                t_device += l.flops / self.device_flops
                t_blind += 2 * l.out_bytes / p.blind_bytes_per_s
                t_enclave += 2 * l.out_bytes / p.enclave_mem_bytes_per_s
                t_disp += p.dispatch_overhead_s
            elif st.placement == "enclave" or st.placement == "blinded":
                # enclave-resident (incl. non-linear layers in a blinded
                # tier — pools can't blind)
                if epc_bound and not l.linear:
                    t_enclave += l.out_bytes / p.enclave_mem_bytes_per_s
                else:
                    t_enclave += l.flops / p.sgx_flops
                    if (l.name.startswith(("fc", "logits"))
                            and l.param_bytes > 8 * 2 ** 20):
                        t_page += l.param_bytes / p.paging_bytes_per_s
            else:                                   # open
                t_device += l.flops / self.device_flops
                if st.verified_open:
                    # quantize + Freivalds fold are enclave elementwise
                    t_enclave += 2 * l.out_bytes / p.enclave_mem_bytes_per_s
                    t_disp += p.dispatch_overhead_s
        resident = self.plan_residency(plan)
        total = t_enclave + t_device + t_blind + t_page + t_disp
        return StrategyCost(
            name=plan.mode_label, runtime_s=total,
            enclave_resident_mb=resident / 2 ** 20,
            recovery_s=self.recovery_s(resident),
            breakdown={"enclave": t_enclave, "device": t_device,
                       "blind": t_blind, "paging": t_page,
                       "dispatch": t_disp})

    def _plan_quantities(self, plan) -> Dict[str, float]:
        """The cost-model feature quantities a plan moves per inference —
        the same features CalibratedCostModel fits unit costs for, so a
        calibrated prediction is literally ``sum(c_f * q_f)``."""
        p = self.p  # noqa: F841 — quantities are params-independent
        L = self.layers
        q = {"device_flops": 0.0, "enclave_flops": 0.0, "blind_bytes": 0.0,
             "unblind_bytes": 0.0, "dispatches": 0.0}
        epc_bound = plan.has_offload
        for st, l in zip(plan.steps, L):
            if st.placement == "blinded" and l.linear:
                q["device_flops"] += l.flops
                q["blind_bytes"] += 2 * l.out_bytes
                q["unblind_bytes"] += 2 * l.out_bytes
                q["dispatches"] += 1
            elif st.placement in ("enclave", "blinded"):
                if not (epc_bound and not l.linear):
                    q["enclave_flops"] += l.flops
            else:
                q["device_flops"] += l.flops
                if st.verified_open:
                    q["unblind_bytes"] += 2 * l.out_bytes
                    q["dispatches"] += 1
        return q

    def plan_residency(self, plan) -> float:
        """EPC residency of a mixed plan: enclave-placed weights (fc
        lazy-loads in 8MB slices), the blinding-factor buffer + widest
        offloaded feature when anything offloads, working activations and
        runtime overhead."""
        p = self.p
        L = self.layers
        act = max(l.out_bytes for l in L)
        total = act + p.runtime_overhead_mb * 2 ** 20
        enclave_params = sum(
            min(l.param_bytes, 8 * 2 ** 20)
            if l.name.startswith(("fc", "logits")) else l.param_bytes
            for st, l in zip(plan.steps, L) if st.placement == "enclave")
        total += enclave_params
        offl = [l.out_bytes for st, l in zip(plan.steps, L) if st.offloaded]
        if offl:
            total += max(offl) + 12 * 2 ** 20
        return total


# -- measured calibration (runtime/profiling.py feedback loop) --------------

class CalibratedCostModel:
    """Fits per-phase unit costs from measured phase profiles.

    The paper-constant ``EnclaveParams`` were transcribed from §VI SGX
    measurements that no run of this system has validated; the profiler
    (runtime/profiling.CriticalPathProfiler) measures what each phase
    *actually* costs here. Each observation pairs feature quantities
    (FLOPs moved, bytes blinded/unblinded, dispatch count — from executor
    telemetry stamped onto infer spans) with measured phase seconds; the
    per-feature unit cost is the 1-D least-squares slope through the
    origin, ``c = sum(q*t) / sum(q^2)`` — exact for one observation,
    noise-averaging for many. Only warm observations enter (first-call
    trees carry compile time, which has its own phase, not a unit cost).

    Timing threat-model note (DESIGN.md §14): observations are per-tree
    *aggregates* of shape-dependent phases — the same counts/timings the
    redacted trace already exposes; no payload-dependent value enters.
    """

    # phase -> the feature quantity whose unit cost it measures
    PHASE_FEATURES = {
        "device_compute": "device_flops",
        "blind": "blind_bytes",
        "unblind": "unblind_bytes",
        "dispatch_wait": "dispatches",
        "seal": "seal_bytes",
        "unseal": "seal_bytes",
    }

    def __init__(self, base: EnclaveParams = None, device: str = "gpu"):
        self.base = base or EnclaveParams()
        self.device = device
        self.n_observations = 0
        self._sqt: Dict[str, float] = {}     # feature -> sum(q * t)
        self._sqq: Dict[str, float] = {}     # feature -> sum(q^2)

    def observe(self, quantities: Dict[str, float],
                seconds: Dict[str, float]) -> None:
        """One measured tree: feature quantities + per-phase seconds."""
        self.n_observations += 1
        for phase, feat in self.PHASE_FEATURES.items():
            q = float(quantities.get(feat, 0.0))
            t = float(seconds.get(phase, 0.0))
            if q > 0.0 and t > 0.0:
                self._sqt[feat] = self._sqt.get(feat, 0.0) + q * t
                self._sqq[feat] = self._sqq.get(feat, 0.0) + q * q

    def observe_all(self, observations) -> None:
        """Bulk-feed ``CriticalPathProfiler.cost_observations()``."""
        for quantities, seconds in observations:
            self.observe(quantities, seconds)

    @property
    def unit_costs(self) -> Dict[str, float]:
        """Fitted seconds-per-unit for every feature with data."""
        return {f: self._sqt[f] / self._sqq[f]
                for f in self._sqt if self._sqq.get(f, 0.0) > 0.0}

    def fit(self) -> EnclaveParams:
        """Measured ``EnclaveParams``: every parameter a unit cost pins is
        replaced; everything unmeasured keeps its paper value. The SGX
        compute ratio (``sgx_slowdown``) is a paper relation, not a local
        observable (there is no SGX part) — it is held fixed
        and ``cpu_flops`` moves instead, so enclave-mode pricing scales
        with the measured hardware while Fig 2's ratio structure holds."""
        import dataclasses as _dc
        c = self.unit_costs
        kw = {}
        if "device_flops" in c:
            device_flops = 1.0 / c["device_flops"]
            if self.device == "gpu":
                # keep the paper's CPU:GPU ratio, move the absolute scale
                kw["cpu_flops"] = device_flops / self.base.gpu_speedup
            else:
                kw["cpu_flops"] = device_flops
        if "blind_bytes" in c:
            kw["blind_bytes_per_s"] = 1.0 / c["blind_bytes"]
        if "unblind_bytes" in c:
            kw["enclave_mem_bytes_per_s"] = 1.0 / c["unblind_bytes"]
        if "dispatches" in c:
            kw["dispatch_overhead_s"] = c["dispatches"]
        return _dc.replace(self.base, **kw)

    def gauges(self, prefix: str = "costmodel") -> Dict[str, float]:
        """Fitted unit costs + observation count as registry gauges."""
        out = {f"{prefix}.observations": float(self.n_observations)}
        for feat, cost in self.unit_costs.items():
            out[f"{prefix}.unit_s.{feat}"] = cost
        return out

    def predict_plan_s(self, sim: "EnclaveSim", plan) -> float:
        """Plan runtime under the *fitted* params (convenience: rebuilds
        the sim's pricing with ``fit()`` applied)."""
        cal = EnclaveSim(sim.cfg, params=self.fit(),
                         device=self.device)
        return cal.plan_runtime(plan).runtime_s
