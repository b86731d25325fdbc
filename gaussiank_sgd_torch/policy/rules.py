"""Rule-based policies — the decision half of the adaptive engine (port
of ``gaussiank_sgd_tpu/policy/rules.py``).

Each rule is a pure host-side object: ``propose(snapshot, ctx)`` reads a
:class:`~gaussiank_sgd_torch.policy.signals.SignalSnapshot` plus the
engine's :class:`RuleContext` (current knob values, quarantine set,
roofline floor) and returns a :class:`PolicyDecision` or None. Rules
never apply anything — the engine owns hysteresis/budget/probation, and
the Trainer owns the actual knob mutation at the log-interval boundary.

Shipped rules, one for each family of knobs the trainer can switch while
it runs:

* :class:`SelectorRule` — overhead-vs-roofline-floor selector switching:
  when the measured sparse overhead (steady-state step EMA minus the
  measured dense reference) exceeds ``floor_factor ×`` the per-config HBM
  floor (analysis/roofline.py artifact), the current selector is leaving
  measured headroom on the table — try the next untried candidate; once
  every candidate has a steady-state record, commit to the argmin and
  switch again only on sustained regret against the best record.
* :class:`DensityRule` — ef_norm-guided density schedule: a residual
  norm persistently RISING relative to the gradient norm means EF is
  accumulating faster than the exchange drains it → step density up one
  notch; a low, non-rising ratio means headroom → step down (fewer
  selected entries, fewer wire bytes).
* :class:`ExchangePromotionRule` — bucket-plan/wire-mode eligibility
  promotion: a run stuck on the legacy ``i32f32`` wire while
  ``wire='auto'`` is paying 2× exchange bytes only because its bucket
  plan failed the packed-wire gate (parallel/wire.py: uniform plan,
  chunk ≤ 65536); propose the eligible uniform plan.
* :class:`OverlapPromotionRule` — step-schedule promotion: a run moving
  material exchange bytes SEQUENTIALLY (``overlap='off'``) on a plan
  that already passes the pipeline gate (uniform, ≥2 buckets) is leaving
  the bucket-pipelined schedule's latency hiding on the table; propose
  ``overlap: off → auto``. Output-bit-identical by construction
  (trainstep.py parity contract), so the only cost is the rebuild —
  which the engine charges against the decision budget and treats as a
  program-layout change (arm records reset) like density/bucket moves.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Optional, Sequence, Tuple

from .signals import SignalSnapshot

# parallel/wire.py's legacy format name and the compressor registry's
# default, copied so that this package imports no torch
# (tests/test_torch_policy.py holds each equal to its source)
WIRE_LEGACY = "i32f32"
DEFAULT_SELECTOR = "gaussian_fused"

# knob names a PolicyDecision may carry (the Trainer's apply switch)
KNOB_COMPRESSOR = "compressor"
KNOB_DENSITY = "density"
KNOB_WIRE = "wire"
KNOB_BUCKET = "bucket_plan"          # value: "<policy>:<size>"
KNOB_OVERLAP = "overlap"             # value: "auto" | "off"
KNOBS = (KNOB_COMPRESSOR, KNOB_DENSITY, KNOB_WIRE, KNOB_BUCKET,
         KNOB_OVERLAP)


@dataclass(frozen=True)
class PolicyDecision:
    """One proposed (and possibly applied) knob retune. ``old``/``new``
    are strings on the wire (the telemetry schema keeps them uniform
    across knobs); the Trainer parses ``new`` per knob on apply."""

    step: int
    rule: str
    knob: str
    old: str
    new: str
    reason: str

    @property
    def key(self) -> Tuple[str, str]:
        """Hysteresis/quarantine identity: what would change, to what."""
        return (self.knob, self.new)

    def reversed(self, step: int, reason: str) -> "PolicyDecision":
        """The revert twin (apply ``old`` again)."""
        return PolicyDecision(step=step, rule=self.rule, knob=self.knob,
                              old=self.new, new=self.old, reason=reason)


@dataclass(frozen=True)
class RuleContext:
    """What the engine knows beyond the signals: the knob values currently
    live, the quarantine set (knob, value) pairs reverted decisions left
    behind, and the per-config roofline floor when an artifact priced on
    this platform exists."""

    knobs: Dict[str, str] = field(default_factory=dict)
    quarantine: FrozenSet[Tuple[str, str]] = frozenset()
    roofline_floor_ms: Optional[float] = None

    def banned(self, knob: str, value: str) -> bool:
        return (knob, value) in self.quarantine


class Rule:
    """Interface: stateless w.r.t. application (the engine owns that);
    rules may keep cheap internal trend state of their own."""

    name = "rule"

    def propose(self, snap: SignalSnapshot,
                ctx: RuleContext) -> Optional[PolicyDecision]:
        raise NotImplementedError


class SelectorRule(Rule):
    """Overhead-vs-roofline-floor selector switching (module docstring).

    Exploration is gated, not free-running: with no dense reference or no
    floor, the rule proposes nothing until at least two arms have
    steady-state records (so a well-priced default never pays exploration
    compiles); with both, it explores exactly while the measured overhead
    exceeds ``floor_factor × floor`` — the same 1.3× acceptance band the
    bench roofline gate uses (analysis/roofline.py).
    """

    name = "selector_overhead"

    def __init__(self, candidates: Sequence[str],
                 floor_factor: float = 1.3, regret: float = 0.08,
                 min_arm_intervals: int = 2):
        self.candidates = tuple(candidates)
        self.floor_factor = float(floor_factor)
        self.regret = float(regret)
        self.min_arm_intervals = int(min_arm_intervals)

    def _settled(self, snap: SignalSnapshot, arm: str) -> bool:
        return snap.arm_intervals.get(arm, 0) >= self.min_arm_intervals

    def propose(self, snap: SignalSnapshot,
                ctx: RuleContext) -> Optional[PolicyDecision]:
        cur = ctx.knobs.get(KNOB_COMPRESSOR)
        if cur is None or not self._settled(snap, cur):
            return None                      # current arm not measured yet
        cur_ms = 1e3 * snap.arm_step_s[cur]

        # regret path: a better settled record exists -> switch to it
        best, best_ms = cur, cur_ms
        for c in self.candidates:
            if c == cur or ctx.banned(KNOB_COMPRESSOR, c):
                continue
            if self._settled(snap, c):
                ms = 1e3 * snap.arm_step_s[c]
                if ms < best_ms:
                    best, best_ms = c, ms
        if best != cur and cur_ms > (1.0 + self.regret) * best_ms:
            return PolicyDecision(
                step=snap.step, rule=self.name, knob=KNOB_COMPRESSOR,
                old=cur, new=best,
                reason=f"measured regret: {cur} {cur_ms:.2f}ms vs "
                       f"{best} {best_ms:.2f}ms (> {self.regret:.0%})")

        # exploration path: overhead above the roofline acceptance band
        # and an untried candidate remains
        dense = snap.dense_step_s_ema
        floor = ctx.roofline_floor_ms
        if dense is None or floor is None or floor <= 0:
            return None
        overhead_ms = cur_ms - 1e3 * dense
        if overhead_ms <= self.floor_factor * floor:
            return None                      # within budget: stay put
        for c in self.candidates:
            if c == cur or ctx.banned(KNOB_COMPRESSOR, c):
                continue
            if not self._settled(snap, c):
                return PolicyDecision(
                    step=snap.step, rule=self.name, knob=KNOB_COMPRESSOR,
                    old=cur, new=c,
                    reason=f"overhead {overhead_ms:.2f}ms > "
                           f"{self.floor_factor}x floor {floor:.2f}ms; "
                           f"exploring {c}")
        return None


class DensityRule(Rule):
    """ef_norm-guided density schedule (module docstring). Steps density
    up/down one power-of-two notch within [min_density, max_density]."""

    name = "ef_density"

    def __init__(self, min_density: float = 1e-4, max_density: float = 0.02,
                 hi_ratio: float = 2.0, lo_ratio: float = 0.25,
                 min_intervals: int = 4):
        self.min_density = float(min_density)
        self.max_density = float(max_density)
        self.hi_ratio = float(hi_ratio)
        self.lo_ratio = float(lo_ratio)
        self.min_intervals = int(min_intervals)

    def propose(self, snap: SignalSnapshot,
                ctx: RuleContext) -> Optional[PolicyDecision]:
        cur_s = ctx.knobs.get(KNOB_DENSITY)
        r, trend = snap.ef_grad_ratio, snap.ef_ratio_trend
        # ef_ratio_intervals, not intervals: only sparse intervals feed
        # the ratio, and a long dense warm-up must not pre-satisfy the
        # floor so the first sparse samples can fire a retune
        if cur_s is None or r is None or trend is None \
                or snap.ef_ratio_intervals < self.min_intervals:
            return None
        cur = float(cur_s)
        if r > self.hi_ratio and trend > 0 and cur < self.max_density:
            new = min(cur * 2.0, self.max_density)
            reason = (f"ef/grad ratio {r:.2f} > {self.hi_ratio} and "
                      f"rising: EF accumulating faster than the "
                      f"exchange drains")
        elif r < self.lo_ratio and trend <= 0 and cur > self.min_density:
            new = max(cur / 2.0, self.min_density)
            reason = (f"ef/grad ratio {r:.2f} < {self.lo_ratio} and not "
                      f"rising: density headroom, halve the wire bytes")
        else:
            return None
        new_s = f"{new:g}"
        if new_s == cur_s or ctx.banned(KNOB_DENSITY, new_s):
            return None
        return PolicyDecision(step=snap.step, rule=self.name,
                              knob=KNOB_DENSITY, old=cur_s, new=new_s,
                              reason=reason)


class ExchangePromotionRule(Rule):
    """Bucket-plan/wire-mode eligibility promotion (module docstring).
    Fires only while the observed wire is the legacy format under
    ``wire='auto'`` — i.e. the plan, not the flag, is what blocks the
    packed exchange."""

    name = "wire_promotion"

    # the largest chunk the packed u16 bucket-relative index can address
    # (parallel/wire.py's eligibility gate)
    ELIGIBLE_PLAN = "uniform:65536"

    def __init__(self, min_bytes_per_step: float = 1 << 20):
        self.min_bytes_per_step = float(min_bytes_per_step)

    def propose(self, snap: SignalSnapshot,
                ctx: RuleContext) -> Optional[PolicyDecision]:
        if ctx.knobs.get(KNOB_WIRE) != "auto":
            return None
        if snap.wire_format != WIRE_LEGACY:
            return None                      # already packed (or unknown)
        if (snap.bytes_per_step or 0.0) < self.min_bytes_per_step:
            return None                      # bytes too small to matter
        cur = ctx.knobs.get(KNOB_BUCKET, "")
        if cur == self.ELIGIBLE_PLAN \
                or ctx.banned(KNOB_BUCKET, self.ELIGIBLE_PLAN):
            return None
        return PolicyDecision(
            step=snap.step, rule=self.name, knob=KNOB_BUCKET, old=cur,
            new=self.ELIGIBLE_PLAN,
            reason=f"wire=auto but exchange still {snap.wire_format} at "
                   f"{snap.bytes_per_step:.0f} B/step: plan fails the "
                   f"packed-wire gate; promote to an eligible uniform "
                   f"plan")


class OverlapPromotionRule(Rule):
    """Step-schedule promotion (module docstring): flip ``overlap`` from
    'off' to 'auto' when the run is moving material exchange bytes on a
    bucket plan that already passes the pipeline eligibility gate — so
    the flip actually changes the schedule instead of burning a recompile
    on a no-op rebuild."""

    name = "overlap_promotion"

    def __init__(self, min_bytes_per_step: float = 1 << 20):
        self.min_bytes_per_step = float(min_bytes_per_step)

    def propose(self, snap: SignalSnapshot,
                ctx: RuleContext) -> Optional[PolicyDecision]:
        if ctx.knobs.get(KNOB_OVERLAP) != "off":
            return None                      # already auto (or untracked)
        if snap.overlap != "off":
            return None                      # no sparse interval seen yet,
                                             # or somehow already pipelined
        if (snap.bytes_per_step or 0.0) < self.min_bytes_per_step:
            return None                      # bytes too small to matter
        # only a uniform multi-chunk plan passes the trainstep gate; on
        # any other plan the flip would rebuild into the SAME sequential
        # step (the wire_promotion rule is the one that fixes plans)
        if not ctx.knobs.get(KNOB_BUCKET, "").startswith("uniform:"):
            return None
        if ctx.banned(KNOB_OVERLAP, "auto"):
            return None
        return PolicyDecision(
            step=snap.step, rule=self.name, knob=KNOB_OVERLAP, old="off",
            new="auto",
            reason=f"sequential exchange moving "
                   f"{snap.bytes_per_step:.0f} B/step on a pipeline-"
                   f"eligible uniform plan: enable the bucket-pipelined "
                   f"schedule (output bit-identical; recompile only)")


# -- roofline floor lookup -------------------------------------------------

# trainer model name -> the roofline artifact's config key; models outside
# the five BASELINE configs have no floor
MODEL_CONFIG_KEYS = {
    "resnet20": "resnet20",
    "vgg16": "vgg16",
    "resnet50": "resnet50",
    "lstm": "lstm_ptb",
    "transformer": "transformer_wmt",
}


def load_roofline_floor(model: str, platform: str,
                        artifacts: Optional[str] = None) -> Optional[float]:
    """``floor_ms`` for ``model`` from ``analysis/artifacts/roofline.json``
    if that artifact was priced on ``platform`` (the port passes its
    device type, ``cuda`` or ``cpu``), else None: a floor priced on another
    platform, a TPU's or a CPU's, says nothing about a card's exchange."""
    if artifacts is None:
        artifacts = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "analysis", "artifacts")
    path = os.path.join(artifacts, "roofline.json")
    key = MODEL_CONFIG_KEYS.get(model.lower())
    if key is None or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            roof = json.load(f)
        if roof.get("platform") != platform:
            return None
        return float(roof["configs"][key]["floor_ms"])
    except (ValueError, KeyError, OSError):
        return None


def default_rules(cfg) -> list:
    """The shipped rule stack for a TrainConfig — the same selector
    candidate set the reference's bench sweeps (registry default first),
    the density ladder centered on the configured density, wire and
    overlap promotion. The engine holds the roofline floor."""
    candidates = [DEFAULT_SELECTOR, "gaussian_warm", "approxtopk16"]
    if cfg.compressor not in candidates and cfg.compressor not in (
            "none", "auto"):
        candidates.insert(0, cfg.compressor)
    return [
        SelectorRule(candidates),
        DensityRule(min_density=max(cfg.density / 8.0, 1e-5),
                    max_density=min(cfg.density * 8.0, 0.05)),
        ExchangePromotionRule(),
        OverlapPromotionRule(),
    ]
