"""Cost-model partition planner: pick the Origami switch layer per model.

Port of ``repro/core/planner.py``. The paper picks the partition with
Algorithm 1 (a c-GAN adversary per candidate layer, minutes of GPU per
layer); serving needs the decision at registration time, in milliseconds.
``PartitionPlanner`` uses two calibrated stand-ins:

- **privacy**: a reconstruction proxy built on ``privacy/ssim.py``: SSIM
  between the (normalized, grayscale) input and the channel-mean boundary
  feature map upsampled back to image resolution. ``verify_depth`` layers
  past the candidate are checked too (Algorithm 1's non-monotonicity
  guard). The proxy's forward runs on the device that holds ``params``.
- **cost**: ``EnclaveSim.runtime(mode, p)`` (core/trust.py) prices every
  feasible partition; the planner returns the cheapest one (smallest ``p``
  on ties). ``calibrate`` swaps the paper constants for unit costs fitted
  from a runtime/profiling.CriticalPathProfiler's measured trees.

Tightening the privacy floor only shrinks the feasible set, and the modeled
runtime is non-decreasing in the number of blinded layers, so the chosen
partition never shrinks as the floor tightens. LM families have no
image-SSIM analogue: the planner honours the config's declared partition
and marks the plan's ``source``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import plan as PL
from repro_torch.core.integrity import IntegrityPolicy
from repro_torch.core.trust import CalibratedCostModel, EnclaveParams, EnclaveSim
from repro_torch.privacy.data import make_batch
from repro_torch.privacy.ssim import ssim


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    model: str
    mode: str
    partition: int                      # chosen tier-1 depth p
    source: str                         # "planner" | "config" | "explicit"
    privacy_floor: Optional[float]
    leakage: Dict[int, float]           # boundary layer -> proxy leakage
    runtime_s: Dict[int, float]         # candidate p -> modeled runtime
    feasible: Tuple[int, ...]           # candidates meeting the floor

    def summary(self) -> str:
        leak = self.leakage.get(self.partition)
        leak_s = f"{leak:.3f}" if leak is not None else "n/a"
        rt = self.runtime_s.get(self.partition)
        rt_s = f"{rt * 1e3:.1f}ms" if rt is not None else "n/a"
        return (f"{self.model}: p={self.partition} ({self.source}) "
                f"leakage={leak_s} floor={self.privacy_floor} "
                f"modeled_runtime={rt_s}")

    def to_placement(self, cfg: ModelConfig) -> PL.PlacementPlan:
        """Compile this prefix decision to the per-layer PlacementPlan IR
        (core/plan.py) — what the executor and serving layer consume."""
        return PL.compile_mode(cfg, self.mode, self.partition)


def _grayscale_unit(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, 1) channel-mean, min-max to [0, 1]."""
    g = x.to(torch.float32).mean(dim=-1, keepdim=True)
    lo = g.amin(dim=(1, 2, 3), keepdim=True)
    hi = g.amax(dim=(1, 2, 3), keepdim=True)
    return (g - lo) / (hi - lo + 1e-9)


def _params_device(params) -> torch.device:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


def boundary_leakage(params, cfg: ModelConfig, layer: int,
                     n_images: int = 4) -> Optional[float]:
    """Reconstruction proxy for the boundary after ``layer`` (1-based).

    Channel-mean the boundary feature map, nearest-upsample it back to
    image resolution, and SSIM it against the grayscale input; contrast
    inversions leak as much as the identity, so take ``|SSIM|`` and the max
    over the feature and its negative. fc boundaries carry no spatial grid
    for this proxy to score — returns ``None`` (unmeasurable), which
    ``leakage_profile`` resolves fail-closed.
    """
    from repro_torch.models import vgg as V
    x = torch.from_numpy(make_batch(0, n_images, cfg.image_size)).to(
        _params_device(params))
    with torch.no_grad():
        _, feat = V.vgg_forward(params, x, cfg, capture=layer)
        if feat.dim() != 4:                  # fc features: no spatial layout
            return None
        f = _grayscale_unit(feat)
        rep = cfg.image_size // f.shape[1]
        if rep > 1:
            f = f.repeat_interleave(rep, dim=1).repeat_interleave(rep, dim=2)
        g = _grayscale_unit(x)
        return max(abs(float(ssim(f, g))), abs(float(ssim(1.0 - f, g))))


def leakage_profile(params, cfg: ModelConfig, *,
                    n_images: int = 4) -> Dict[int, float]:
    """Proxy leakage for every candidate boundary layer.

    Boundaries the proxy cannot score (fc layers — no spatial grid)
    inherit the last measurable boundary's leakage rather than scoring 0:
    a 0 would make them feasible under *any* floor (fail-open), even
    though feature-inversion attacks reconstruct fc features too. The
    carry-forward is fail-closed — an fc boundary is treated as no safer
    than the features feeding it until the offline c-GAN/probe says
    otherwise (inject its numbers via ``plan(..., leakage=...)``).
    """
    n = len(cfg.cnn_layers)
    profile: Dict[int, float] = {}
    carry = 1.0                              # nothing measured yet: unsafe
    for p in range(1, n):
        v = boundary_leakage(params, cfg, p, n_images)
        if v is None:
            v = carry
        else:
            carry = v
        profile[p] = v
    return profile


def plan_leakage(profile: Dict[int, float], plan: PL.PlacementPlan) -> float:
    """Fail-closed proxy leakage of an arbitrary PlacementPlan.

    The device observes every boundary in ``plan.exposed_boundaries()``
    (the declared boundary plus both sides of every open layer). Exposing
    boundary 0 — the raw input, i.e. the first layer runs open — is total
    leakage (1.0) by definition. Each other exposed boundary scores its
    measured proxy leakage; a boundary the proxy could not measure
    **inherits the worst upstream measured leakage** (1.0 if nothing
    upstream was measured) — so a custom or non-contiguous plan can never
    report lower leakage than the layers feeding its open steps. The
    plan's leakage is the max over all exposed boundaries; a plan
    exposing nothing (all layers protected, boundary at the logits —
    e.g. slalom/enclave) scores 0.0.
    """
    exposed = plan.exposed_boundaries()
    if not exposed:
        return 0.0
    if 0 in exposed:
        return 1.0
    worst = 0.0
    carry: Optional[float] = None            # max of measured boundaries
    n = plan.n_layers
    for p in range(1, n):
        v = profile.get(p)
        if v is not None:
            carry = v if carry is None else max(carry, v)
        if p in exposed:
            worst = max(worst, v if v is not None
                        else (1.0 if carry is None else carry))
    return worst


@dataclasses.dataclass(frozen=True)
class PlacementChoice:
    """One scored candidate from the per-layer placement sweep."""
    plan: PL.PlacementPlan
    leakage: float
    runtime_s: float

    def summary(self) -> str:
        return (f"{self.plan.summary()} leakage={self.leakage:.3f} "
                f"modeled_runtime={self.runtime_s * 1e3:.1f}ms")


class PartitionPlanner:
    """Sweeps ``EnclaveSim.runtime(mode, p)`` under a privacy floor."""

    def __init__(self, privacy_floor: float = 0.35, verify_depth: int = 2,
                 n_images: int = 4, device: str = "gpu"):
        self.privacy_floor = privacy_floor
        self.verify_depth = verify_depth
        self.n_images = n_images
        self.device = device
        # measured cost-model override (calibrate()); None = paper constants
        self.enclave_params: Optional[EnclaveParams] = None

    def _sim(self, cfg: ModelConfig) -> EnclaveSim:
        return EnclaveSim(cfg, params=self.enclave_params,
                          device=self.device)

    def calibrate(self, source) -> EnclaveParams:
        """Re-price future plans with *measured* per-phase unit costs.

        ``source`` may be a runtime/profiling.CriticalPathProfiler (its
        ``cost_observations()`` feed the fit), a pre-fitted
        CalibratedCostModel, or an explicit EnclaveParams. Returns the
        params now in force; every subsequent ``plan()`` /
        ``placement_plan()`` prices with them instead of the paper
        constants (core/trust.py keeps the paper model untouched — this
        only swaps the parameter vector this planner instance uses)."""
        if isinstance(source, EnclaveParams):
            self.enclave_params = source
        elif isinstance(source, CalibratedCostModel):
            self.enclave_params = source.fit()
        else:                      # profiler (anything with observations)
            model = CalibratedCostModel(device=self.device)
            model.observe_all(source.cost_observations())
            self.enclave_params = model.fit()
        return self.enclave_params

    def plan(self, cfg: ModelConfig, params=None, *, mode: str = "origami",
             partition: Optional[int] = None,
             leakage: Optional[Dict[int, float]] = None) -> PartitionPlan:
        """Returns the serving plan for one model.

        ``partition`` pins the choice (source="explicit"); ``leakage``
        injects a precomputed/offline profile (e.g. real c-GAN SSIMs from
        privacy/reconstruct.py) in place of the proxy.
        """
        if partition is not None:
            return PartitionPlan(cfg.name, mode, partition, "explicit",
                                 None, {}, {}, ())
        if cfg.family != "cnn" or mode not in ("origami", "split"):
            # no image-reconstruction metric (LM) or partition-free mode
            # (open/enclave/slalom): honour the config's declared point.
            return PartitionPlan(cfg.name, mode, cfg.origami.tier1_layers,
                                 "config", None, {}, {}, ())
        if leakage is None:
            assert params is not None, "planner needs params for the proxy"
            leakage = leakage_profile(params, cfg, n_images=self.n_images)
        candidates = sorted(leakage)
        n_max = max(candidates)
        n_blind_all = len(cfg.cnn_layers)   # tier-1 covers every layer
        sim = self._sim(cfg)
        runtime_s = {p: sim.runtime(mode, p).runtime_s
                     for p in candidates + [n_blind_all]}

        # Algorithm 1's verify-deeper rule: a candidate is safe only if the
        # next ``verify_depth`` boundaries are also below the floor
        # (max-pool boundaries can be safe while the next conv leaks again).
        def safe(p: int) -> float:
            window = range(p, min(p + self.verify_depth, n_max) + 1)
            return max(leakage[q] for q in window if q in leakage)

        feasible = tuple(p for p in candidates
                         if safe(p) <= self.privacy_floor)
        if not feasible:
            # no boundary is safe to expose: blind every layer (partition =
            # num layers, i.e. the Slalom regime — nothing leaves the
            # blinded tier), not the deepest *candidate*, whose boundary
            # would still be revealed.
            chosen = n_blind_all
        else:
            chosen = min(feasible, key=lambda p: (runtime_s[p], p))
        return PartitionPlan(cfg.name, mode, chosen, "planner",
                             self.privacy_floor, dict(leakage), runtime_s,
                             feasible)

    # -- per-layer placement sweep (beyond prefix cuts) ----------------------
    def placement_candidates(self, cfg: ModelConfig, boundary: int, *,
                             verify: Optional[IntegrityPolicy] = None
                             ) -> List[PL.PlacementPlan]:
        """Candidate plans for one boundary, beyond the pure blinded
        prefix: every mixed enclave/blinded tier-1 split (an enclave
        suffix of tier-1 is cheaper when its blind/unblind traffic
        outweighs SGX compute) and, when ``verify`` is set, a
        verified-open tier-2 variant (tier-2 linear layers offload
        unblinded under a Freivalds policy). All candidates expose
        exactly the same boundaries, so leakage is shared."""
        cands = [PL.compile_mode(cfg, "origami", boundary)]
        for b in range(boundary):            # blinded prefix length
            cands.append(PL.make_mixed(cfg, boundary, b,
                                       label=f"mixed@{boundary}-b{b}"))
        if verify is not None and boundary < PL.num_blocks(cfg):
            cands.append(PL.make_vopen(cfg, boundary, verify,
                                       label=f"vopen@{boundary}"))
        return cands

    def placement_plan(self, cfg: ModelConfig, params=None, *,
                       leakage: Optional[Dict[int, float]] = None,
                       verify: Optional[IntegrityPolicy] = None
                       ) -> PlacementChoice:
        """Per-layer sweep under the privacy floor: every feasible prefix
        boundary spawns ``placement_candidates``; each candidate is scored
        fail-closed (``plan_leakage``) and priced per-step
        (``EnclaveSim.plan_runtime``); the cheapest feasible plan wins
        (ties: fewer blinded layers). Falls back to all-blinded (Slalom)
        when no boundary is safe — same fail-closed rule as ``plan``."""
        assert cfg.family == "cnn", "placement sweep needs the SSIM proxy"
        if leakage is None:
            assert params is not None, "planner needs params for the proxy"
            leakage = leakage_profile(params, cfg, n_images=self.n_images)
        n = len(cfg.cnn_layers)
        sim = self._sim(cfg)
        scored: List[PlacementChoice] = []
        for boundary in sorted(leakage):
            for cand in self.placement_candidates(cfg, boundary,
                                                  verify=verify):
                leak = plan_leakage(leakage, cand)
                if leak > self.privacy_floor:
                    continue
                scored.append(PlacementChoice(
                    cand, leak, sim.plan_runtime(cand).runtime_s))
        if not scored:
            slalom = PL.compile_mode(cfg, "slalom", n)
            return PlacementChoice(slalom, 0.0,
                                   sim.plan_runtime(slalom).runtime_s)
        return min(scored, key=lambda c: (c.runtime_s,
                                          c.plan.num_blinded))
