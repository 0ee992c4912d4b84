"""PlacementPlan IR: per-layer placement compiled once, interpreted once.

Port of ``repro/core/plan.py`` (a copy: the port imports nothing of the
reference). Each layer is ``open`` (plain on
the untrusted device), ``enclave`` or ``blinded`` (Slalom offload); an open
layer with an enabled integrity policy is a verified-open offload.
``segments`` are the maximal runs of one execution regime (``plain`` |
``blinded`` | ``verified``), split at the revealed ``boundary``. ``digest``
hashes the plan exactly as the reference does, so the same plan has the
same digest (and attestation quote) in both packages.

Decode plans (``make_decode_plan``) apply a plan token-wise: ``ScanSegment``
walks blocks [lo, hi) once per token under one regime, binding each
offloaded op to a per-(session, token, layer) slot of a streaming
TokenSlotRing (runtime/sessions.py). ``DecodePlan.digest`` extends the base
plan's digest exactly as the reference does. Families without a per-op
addressable decode walk raise ``ScanExclusion`` with the reference's
reason.
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


# families whose decode walk is per-op addressable (every block a uniform
# stack of static-weight linear ops); the rest raise ScanExclusion
DECODE_FAMILIES = ("dense",)

_DECODE_EXCLUSIONS = {
    "cnn": "feed-forward family: no autoregressive decode loop exists",
    "moe": "expert weights are data-dependent gathers (top-k routing), so "
           "per-op unblinding factors u = r @ W cannot be precomputed — "
           "run MoE decode enclave-resident or blinded-unverified",
    "hybrid": "decode walks grouped mamba super-blocks under lax.scan; the "
              "recurrent state update is not a static-weight linear map",
    "ssm": "decode walks grouped m/sLSTM super-blocks under lax.scan; the "
           "recurrent state update is not a static-weight linear map",
    "audio": "decoder blocks carry cross-attention against the encoder "
             "memory and decode under lax.scan (grouped super-blocks)",
    "vlm": "decoder blocks carry cross-attention against the vision "
           "memory and decode under lax.scan (grouped super-blocks)",
}


class ScanExclusion(ValueError):
    """A placement or decode feature is structurally unavailable for this
    family; the message names the reason."""

# placement-string alphabet (``from_string`` / ``placement_string``):
# o = open, e = enclave, b = blinded, v = verified-open (open + Freivalds)
_CHAR_PLACEMENT = {"o": "open", "e": "enclave", "b": "blinded", "v": "open"}
_PLACEMENT_CHAR = {"open": "o", "enclave": "e", "blinded": "b"}


def num_blocks(cfg: ModelConfig) -> int:
    """Plan length: CNN layer specs or transformer blocks."""
    return len(cfg.cnn_layers) if cfg.family == "cnn" else cfg.num_layers


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
    def num_blinded(self) -> int:
        return sum(s.placement == "blinded" for s in self.steps)

    @property
    def has_blinded(self) -> bool:
        return any(s.placement == "blinded" for s in self.steps)

    @property
    def has_offload(self) -> bool:
        return any(s.offloaded for s in self.steps)

    @property
    def has_step_policies(self) -> bool:
        """Any step carrying its own enabled Freivalds policy."""
        return any(s.integrity is not None and s.integrity.enabled
                   for s in self.steps)

    @property
    def cache_ops(self) -> Tuple[LayerStep, ...]:
        """Steps with a precompute slot, in slot (= call) order."""
        ops = [s for s in self.steps if s.precompute_slot is not None]
        return tuple(sorted(ops, key=lambda s: s.precompute_slot))

    @property
    def placement_string(self) -> str:
        return "".join("v" if s.verified_open
                       else _PLACEMENT_CHAR[s.placement] for s in self.steps)

    def exposed_boundaries(self) -> Tuple[int, ...]:
        """Every boundary index the untrusted device observes in the clear:
        the declared ``boundary`` plus both sides of every open step. Index
        0 is the raw input (the planner scores it as total leakage); the
        final index n (the logits) is public and never listed."""
        n = len(self.steps)
        exposed = set()
        if self.boundary <= n - 1:
            exposed.add(self.boundary)
        if self.steps and self.steps[0].placement == "open":
            exposed.add(0)
        for p in range(1, n):
            if (self.steps[p - 1].placement == "open"
                    or self.steps[p].placement == "open"):
                exposed.add(p)
        return tuple(sorted(exposed))

    def summary(self) -> str:
        return (f"{self.model}[{self.mode_label}] "
                f"{self.placement_string} boundary={self.boundary} "
                f"plan={self.digest[:12]}")


def linear_layers(cfg: ModelConfig) -> Optional[Tuple[bool, ...]]:
    """Per-layer "carries an individually addressable linear op" mask
    (conv, fc, logits). ``None`` for the LM families, whose forward trace
    in the reference runs blocks under ``lax.scan``: their ops are neither
    cached by slot nor verified per op there, and the port keeps the same
    plans (and digests). Token-wise verification of LM ops lives in decode
    plans (``make_decode_plan``)."""
    if cfg.family != "cnn":
        return None
    from repro_torch.models import vgg as V
    return tuple(V.layer_kind(cfg, i)[0] in ("conv", "fc", "logits")
                 for i in range(num_blocks(cfg)))


def _assign_slots(cfg: ModelConfig,
                  steps: Sequence[LayerStep]) -> Tuple[LayerStep, ...]:
    linear = linear_layers(cfg)
    out, slot = [], 0
    for st in steps:
        ps = None
        if linear is not None and st.offloaded and linear[st.layer_id]:
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
    if linear_layers(cfg) is None and any(
            p is not None and p.enabled for p in integrity.values()):
        # an enabled per-step policy could not bind per op in the LM
        # forward trace; on an open step the op would run unblinded and
        # unchecked while the digest advertised verified offload
        raise ScanExclusion(
            f"{cfg.name} ({cfg.family}): per-step integrity policies need "
            "per-op verification, which the forward trace of this family "
            "does not have; use 'blinded' placements with an executor-wide "
            "policy, or a decode plan (make_decode_plan)")
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


def from_string(cfg: ModelConfig, spec: str, *,
                verify: Optional[IG.IntegrityPolicy] = None,
                boundary: Optional[int] = None,
                label: Optional[str] = None) -> PlacementPlan:
    """Compact per-layer spec: one char per layer from ``oebv``
    (v = verified-open; its policy is ``verify`` or full(k=1))."""
    spec = spec.strip().lower()
    n = num_blocks(cfg)
    assert len(spec) == n, f"spec {spec!r} has {len(spec)} chars, want {n}"
    placements, integrity = [], {}
    for i, ch in enumerate(spec):
        assert ch in _CHAR_PLACEMENT, ch
        placements.append(_CHAR_PLACEMENT[ch])
        if ch == "v":
            integrity[i] = verify or IG.IntegrityPolicy.full(1)
    return make_plan(cfg, placements, integrity=integrity, boundary=boundary,
                     label=label or spec)


def make_mixed(cfg: ModelConfig, boundary: Optional[int] = None,
               blinded_prefix: Optional[int] = None,
               label: str = "mixed") -> PlacementPlan:
    """Mixed enclave/blinded tier-1: layers [0, blinded_prefix) blinded,
    [blinded_prefix, boundary) enclave-resident, the rest open. The
    default splits tier-1 in half."""
    n = num_blocks(cfg)
    p = boundary if boundary is not None else cfg.origami.tier1_layers
    b = blinded_prefix if blinded_prefix is not None else max(p // 2, 1)
    assert 0 <= b <= p <= n, (b, p, n)
    return make_plan(cfg, ["blinded"] * b + ["enclave"] * (p - b)
                     + ["open"] * (n - p), boundary=p, label=label)


def make_vopen(cfg: ModelConfig, boundary: Optional[int] = None,
               verify: Optional[IG.IntegrityPolicy] = None,
               label: str = "vopen") -> PlacementPlan:
    """Verified-open tier-2: blinded prefix up to ``boundary``, then every
    linear layer offloads unblinded under the ``verify`` Freivalds policy
    (default full(k=1)). Raises for families without per-op verification
    in the forward trace (``linear_layers``)."""
    n = num_blocks(cfg)
    p = boundary if boundary is not None else cfg.origami.tier1_layers
    pol = verify or IG.IntegrityPolicy.full(1)
    linear = linear_layers(cfg)
    if linear is None:
        raise ScanExclusion(
            f"{cfg.name}: verified-open needs per-op verification in the "
            "forward trace (see linear_layers); for LM decode use "
            "make_decode_plan's verified scan segments")
    integ = {i: pol for i in range(p, n) if linear[i]}
    return make_plan(cfg, ["blinded"] * p + ["open"] * (n - p),
                     integrity=integ, boundary=p, label=label)


def classify_legacy(plan: PlacementPlan) -> Optional[Tuple[str, int]]:
    """(mode, partition) iff the plan is exactly a legacy prefix shape with
    no per-step integrity overrides, so the cost model can use the per-mode
    formulas."""
    if any(s.integrity is not None for s in plan.steps):
        return None
    ps = [s.placement for s in plan.steps]
    n, b = len(ps), plan.boundary
    if ps == ["open"] * n and b == 0:
        return "open", 0
    if ps == ["enclave"] * n and b == n:
        return "enclave", n
    if ps == ["blinded"] * n and b == n:
        return "slalom", n
    if ps == ["enclave"] * b + ["open"] * (n - b):
        return "split", b
    if ps == ["blinded"] * b + ["open"] * (n - b):
        return "origami", b
    return None


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
    if cfg.family == "cnn":
        from repro_torch.models import vgg as V
        pro, seg, epi = V.layer_program(cfg)
        return PlanProgram(num_blocks(cfg), True, pro, seg, epi)
    from repro_torch.models import model as M
    pro, seg, epi = M.layer_program(cfg)
    return PlanProgram(cfg.num_layers, False, pro, seg, epi)


@dataclass(frozen=True)
class ScanSegment:
    """The per-token walk of blocks [lo, hi) under one regime, for decode
    steps [steps[0], steps[1]). ``policy`` is per step: each token
    re-derives its fold vectors and check decisions from (session, op,
    token). ``slot_binding``: "token" (blinded and verified segments take
    the per-(session, token, layer) slot of a TokenSlotRing) or "none"
    (plain segments touch no factor material)."""
    lo: int
    hi: int
    regime: str
    steps: Tuple[int, int]
    policy: Optional[IG.IntegrityPolicy] = None
    shard: Optional[ShardPolicy] = None
    slot_binding: str = "token"

    def __post_init__(self):
        assert self.regime in ("plain", "blinded", "verified"), self.regime
        assert self.slot_binding in ("token", "none"), self.slot_binding
        assert 0 <= self.steps[0] <= self.steps[1], self.steps


@dataclass(frozen=True)
class DecodePlan:
    """A PlacementPlan applied token-wise: the decode loop walks ``scan``
    once per token. ``digest`` extends the base plan's with the scan
    structure and the step range, so a decode plan is attested distinctly
    from its base plan."""
    base: PlacementPlan
    scan: Tuple[ScanSegment, ...]
    max_steps: int

    @cached_property
    def digest(self) -> str:
        body = {
            "base": self.base.digest,
            "max_steps": self.max_steps,
            "scan": [(s.lo, s.hi, s.regime, list(s.steps),
                      _policy_key(s.policy), _shard_key(s.shard),
                      s.slot_binding) for s in self.scan],
        }
        return hashlib.sha256(
            json.dumps(body, sort_keys=True).encode()).hexdigest()

    @property
    def has_offload(self) -> bool:
        return any(s.regime != "plain" for s in self.scan)

    @property
    def has_verification(self) -> bool:
        return any(s.regime != "plain" and s.policy is not None
                   and s.policy.enabled for s in self.scan)

    def summary(self) -> str:
        segs = " ".join(f"[{s.lo},{s.hi}){s.regime[0]}" for s in self.scan)
        return (f"{self.base.model}[decode] {segs} steps={self.max_steps} "
                f"plan={self.digest[:12]}")


def make_decode_plan(cfg: ModelConfig, plan: Optional[PlacementPlan] = None,
                     *, max_steps: int, partition: Optional[int] = None,
                     integrity: Optional[IG.IntegrityPolicy] = None
                     ) -> DecodePlan:
    """The base plan's segments applied token-wise. ``plan`` defaults to
    ``compile_mode(cfg, "origami", partition)``; ``integrity`` becomes the
    per-step policy of every offloaded segment without its own. Raises
    ScanExclusion outside DECODE_FAMILIES."""
    if cfg.family not in DECODE_FAMILIES:
        reason = _DECODE_EXCLUSIONS.get(cfg.family, "no decode walk")
        raise ScanExclusion(f"{cfg.name} ({cfg.family}): private decode "
                            f"unavailable — {reason}")
    assert max_steps >= 1, max_steps
    if plan is None:
        plan = compile_mode(cfg, "origami", partition)
    scan = []
    for seg in plan.segments:
        policy = seg.policy
        if policy is None and seg.regime != "plain":
            policy = integrity
        scan.append(ScanSegment(
            seg.lo, seg.hi, seg.regime, (0, max_steps), policy, seg.shard,
            slot_binding="none" if seg.regime == "plain" else "token"))
    return DecodePlan(plan, tuple(scan), max_steps)
