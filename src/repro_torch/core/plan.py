"""PlacementPlan IR: per-layer placement compiled once, interpreted once.

Port of the CNN part of ``repro/core/plan.py`` (a copy: the port imports
nothing of the reference). Each layer is ``open`` (plain on the untrusted
device), ``enclave`` or ``blinded`` (Slalom offload); an open layer with an
enabled integrity policy is a verified-open offload. ``segments`` are the
maximal runs of one execution regime (``plain`` | ``blinded`` |
``verified``), split at the revealed ``boundary``. ``digest`` hashes the
plan exactly as the reference does, so the same plan has the same digest
(and attestation quote) in both packages.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from functools import cached_property
from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core import integrity as IG

PLACEMENTS = ("open", "enclave", "blinded")
LEGACY_MODES = ("open", "enclave", "split", "slalom", "origami")
SHARD_MODES = ("rows", "shares")


def num_blocks(cfg: ModelConfig) -> int:
    assert cfg.family == "cnn", f"the port runs the cnn family, not {cfg.family}"
    return len(cfg.cnn_layers)


@dataclass(frozen=True)
class ShardPolicy:
    """Per-step multi-device offload policy (parallel/offload_sharding.py).
    ``mode``: "rows" (row-shard the blinded operand) | "shares" (additive
    secret shares: no single device holds the full blinded tensor).
    ``devices``: the slot indices of the executor's DevicePool this step may
    dispatch to (``None``: the whole pool). Inert without a plane."""
    mode: str = "rows"
    devices: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        assert self.mode in SHARD_MODES, self.mode


def _shard_key(s: Optional[ShardPolicy]):
    return None if s is None else (s.mode, s.devices)


@dataclass(frozen=True)
class LayerStep:
    """One per-layer placement decision. ``integrity``: per-step Freivalds
    policy (``None`` inherits the executor's for blinded steps, means
    unverified for open steps). ``precompute_slot``: index of this step's
    blinded op in the BlindedLayerCache (``None``: none). ``shard``:
    per-step ShardPolicy (``None`` inherits the plane's default)."""
    layer_id: int
    placement: str
    integrity: Optional[IG.IntegrityPolicy] = None
    precompute_slot: Optional[int] = None
    shard: Optional[ShardPolicy] = None

    def __post_init__(self):
        assert self.placement in PLACEMENTS, self.placement

    @property
    def verified_open(self) -> bool:
        return (self.placement == "open" and self.integrity is not None
                and self.integrity.enabled)

    @property
    def offloaded(self) -> bool:
        """Does the untrusted device execute this step's linear ops?"""
        return self.placement == "blinded" or self.verified_open


@dataclass(frozen=True)
class Segment:
    """A maximal run of steps sharing one regime ("plain" | "blinded" |
    "verified"), one policy override and one shard policy."""
    lo: int
    hi: int
    regime: str
    policy: Optional[IG.IntegrityPolicy] = None
    shard: Optional[ShardPolicy] = None


def _policy_key(p: Optional[IG.IntegrityPolicy]):
    return None if p is None else (p.mode, p.rate, p.k)


@dataclass(frozen=True)
class PlacementPlan:
    """Ordered per-layer placements + the revealed-boundary index."""
    model: str
    family: str
    steps: Tuple[LayerStep, ...]
    boundary: int
    mode_label: str = "custom"

    def __post_init__(self):
        assert 0 <= self.boundary <= len(self.steps), self.boundary
        for i, st in enumerate(self.steps):
            assert st.layer_id == i, (st.layer_id, i)

    def _regime(self, st: LayerStep):
        if st.placement == "blinded":
            return "blinded", st.integrity
        if st.verified_open:
            return "verified", st.integrity
        return "plain", None

    @cached_property
    def segments(self) -> Tuple[Segment, ...]:
        segs = []
        for i, st in enumerate(self.steps):
            regime, policy = self._regime(st)
            shard = st.shard if regime != "plain" else None
            if (segs and segs[-1].regime == regime
                    and _policy_key(segs[-1].policy) == _policy_key(policy)
                    and _shard_key(segs[-1].shard) == _shard_key(shard)
                    and i != self.boundary):
                segs[-1] = Segment(segs[-1].lo, i + 1, regime, policy, shard)
            else:
                segs.append(Segment(i, i + 1, regime, policy, shard))
        return tuple(segs)

    @cached_property
    def digest(self) -> str:
        body = {
            "model": self.model, "family": self.family,
            "boundary": self.boundary,
            "steps": [(s.layer_id, s.placement, _policy_key(s.integrity))
                      for s in self.steps],
        }
        if any(s.shard is not None for s in self.steps):
            # only when present, so shard-free plans keep their digests
            # (cache keys, attested measurements)
            body["shards"] = [(s.layer_id, _shard_key(s.shard))
                              for s in self.steps if s.shard is not None]
        return hashlib.sha256(
            json.dumps(body, sort_keys=True).encode()).hexdigest()

    @property
    def n_layers(self) -> int:
        return len(self.steps)

    @property
    def has_offload(self) -> bool:
        return any(s.offloaded for s in self.steps)

    @property
    def cache_ops(self) -> Tuple[LayerStep, ...]:
        """Steps with a precompute slot, in slot (= call) order."""
        ops = [s for s in self.steps if s.precompute_slot is not None]
        return tuple(sorted(ops, key=lambda s: s.precompute_slot))


def linear_layers(cfg: ModelConfig) -> Tuple[bool, ...]:
    """Per-layer "carries a linear op" mask (conv, fc, logits)."""
    from repro_torch.models import vgg as V
    return tuple(V.layer_kind(cfg, i)[0] in ("conv", "fc", "logits")
                 for i in range(num_blocks(cfg)))


def _assign_slots(cfg: ModelConfig,
                  steps: Sequence[LayerStep]) -> Tuple[LayerStep, ...]:
    linear = linear_layers(cfg)
    out, slot = [], 0
    for st in steps:
        ps = None
        if st.offloaded and linear[st.layer_id]:
            ps, slot = slot, slot + 1
        out.append(LayerStep(st.layer_id, st.placement, st.integrity, ps,
                             st.shard))
    return tuple(out)


def make_plan(cfg: ModelConfig, placements: Sequence[str], *,
              integrity: Optional[Dict[int, IG.IntegrityPolicy]] = None,
              shard: Optional[Dict[int, ShardPolicy]] = None,
              boundary: Optional[int] = None,
              label: str = "custom") -> PlacementPlan:
    """Build a plan from per-layer placement names. ``integrity``:
    {layer_id: policy} and ``shard``: {layer_id: ShardPolicy} per-step
    overrides. ``boundary`` defaults to the start of the trailing open
    suffix."""
    n = num_blocks(cfg)
    placements = list(placements)
    assert len(placements) == n, (len(placements), n)
    integrity = integrity or {}
    shard = shard or {}
    if boundary is None:
        boundary = n
        while boundary > 0 and placements[boundary - 1] == "open":
            boundary -= 1
    steps = [LayerStep(i, p, integrity.get(i), shard=shard.get(i))
             for i, p in enumerate(placements)]
    return PlacementPlan(cfg.name, cfg.family, _assign_slots(cfg, steps),
                         boundary, label)


def compile_mode(cfg: ModelConfig, mode: str,
                 partition: Optional[int] = None) -> PlacementPlan:
    """Compile a legacy mode string (+ prefix partition) to a plan.

        open     all open                     boundary 0
        enclave  all enclave                  boundary n
        split    enclave^p + open^(n-p)       boundary p
        slalom   blinded everywhere           boundary n
        origami  blinded^p + open^(n-p)       boundary p
    """
    assert mode in LEGACY_MODES, mode
    n = num_blocks(cfg)
    p = partition if partition is not None else cfg.origami.tier1_layers
    if mode == "open":
        placements, boundary = ["open"] * n, 0
    elif mode == "enclave":
        placements, boundary = ["enclave"] * n, n
    elif mode == "slalom":
        placements, boundary = ["blinded"] * n, n
    elif mode == "split":
        placements, boundary = ["enclave"] * p + ["open"] * (n - p), p
    else:                                   # origami
        placements, boundary = ["blinded"] * p + ["open"] * (n - p), p
    return make_plan(cfg, placements, boundary=boundary, label=mode)


@dataclass(frozen=True)
class PlanProgram:
    """Family walk: ``prologue(params, batch) -> (x, memory)``,
    ``segment(params, x, lo, hi, memory) -> x`` over layers [lo, hi),
    ``epilogue(params, x, batch, memory) -> logits``."""
    n_layers: int
    blind_convs: bool
    prologue: Callable
    segment: Callable
    epilogue: Callable


def program_for(cfg: ModelConfig) -> PlanProgram:
    from repro_torch.models import vgg as V
    pro, seg, epi = V.layer_program(cfg)
    return PlanProgram(num_blocks(cfg), True, pro, seg, epi)
