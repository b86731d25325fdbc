"""Telemetry-driven adaptive policy engine (port of
``gaussiank_sgd_tpu/policy``).

Closes the loop from the event bus to the training knobs: rolling
signals (:mod:`.signals`) feed rule-based policies (:mod:`.rules`) whose
decisions the :class:`~.engine.PolicyEngine` releases — with hysteresis,
cooldown, a decision budget, and probation/quarantine — for the Trainer
to apply at log-interval boundaries, where it rebuilds its step.

Pure stdlib, as the reference's is: importing it imports no ``torch``.
"""

from .engine import PolicyEngine
from .rules import (
    KNOB_BUCKET,
    KNOB_COMPRESSOR,
    KNOB_DENSITY,
    KNOB_OVERLAP,
    KNOB_WIRE,
    KNOBS,
    DensityRule,
    ExchangePromotionRule,
    OverlapPromotionRule,
    PolicyDecision,
    Rule,
    RuleContext,
    SelectorRule,
    default_rules,
    load_roofline_floor,
)
from .signals import PolicySignals, SignalSnapshot

__all__ = [
    "PolicyEngine",
    "PolicyDecision",
    "PolicySignals",
    "SignalSnapshot",
    "Rule",
    "RuleContext",
    "SelectorRule",
    "DensityRule",
    "ExchangePromotionRule",
    "OverlapPromotionRule",
    "default_rules",
    "load_roofline_floor",
    "KNOBS",
    "KNOB_COMPRESSOR",
    "KNOB_DENSITY",
    "KNOB_WIRE",
    "KNOB_BUCKET",
    "KNOB_OVERLAP",
]
