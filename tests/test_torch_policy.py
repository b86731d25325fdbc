"""The port's adaptive policy engine (``gaussiank_sgd_torch/policy``) and
its wiring in the trainer, against the reference's.

* Signals, rules and engine, record for record: every scenario of the
  reference's ``tests/test_policy.py`` (hysteresis, the budget over a long
  run, rollback-pending and probation reverts, skip-burst and loss-spike
  reverts, settling, arm resets on a layout change, the selector's regret
  and exploration, the density rule both ways, wire promotion) plus the
  overlap rule's gates and seeded random record streams go through both
  packages: the snapshots, the proposals and the ``policy_decision`` /
  ``policy_revert`` payloads are equal, and the reference's own assertions
  hold on the port.
* The trainer: the port's and the reference's ``Trainer`` (a narrow VGG,
  one worker, the same initial weights and CIFAR-10 files) run the same
  scripted rule: the same knob history and decision records, losses within
  the trajectory tolerance of the port's resilience tests; a skip burst
  reverts the density decision, and with a rollback pending the revert
  lands before the rollback. The fused <-> unfused switch keeps the first n
  entries of the parameter, the momentum and the EF row bit for bit with a
  zero tail; no tick in dense warm-up; ``--compressor none`` refused; the
  chaos revert on mnistnet; ``--policy static`` bit for bit a run without
  the key.
* Two gloo ranks, rank 1's engine fed skewed step times: both apply rank
  0's decisions, and their parameters stay bit-identical.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

import gaussiank_sgd_tpu.policy as jpolicy
import gaussiank_sgd_tpu.policy.rules as jrules
import gaussiank_sgd_torch.policy as tpolicy
import gaussiank_sgd_torch.policy.rules as trules
from gaussiank_sgd_torch.training import chaos
from gaussiank_sgd_torch.training.config import TrainConfig
from gaussiank_sgd_torch.training.trainer import Trainer
from test_torch_distributed import _spawn
from test_torch_prefetch import make_cfg, read_events

NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]
PKGS = {"port": tpolicy, "ref": jpolicy}


# ------------------------------------------------------------- helpers

def _plain(x):
    """Dataclasses, sets and tuples as plain, comparable values (the two
    packages' classes differ; their fields must not)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"__type__": type(x).__name__,
                **{f.name: _plain(getattr(x, f.name))
                   for f in dataclasses.fields(x)}}
    if isinstance(x, (set, frozenset)):
        return sorted(_plain(v) for v in x)
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _both(scenario):
    """Run ``scenario(P, trace)`` on the port (P = its policy package) and
    on the reference; the two traces must be equal entry for entry."""
    traces = {}
    for name, pkg in PKGS.items():
        trace = []
        scenario(pkg, trace)
        traces[name] = _plain(trace)
    assert len(traces["port"]) == len(traces["ref"])
    for i, (a, b) in enumerate(zip(traces["port"], traces["ref"])):
        assert a == b, f"entry {i}: port {a} != reference {b}"
    return traces["port"]


def _flag_rule(P, knob=None, new="0.005", old="0.01"):
    """The reference test's FlagRule, on package P's ``Rule``."""

    class FlagRule(P.Rule):
        name = "flag"

        def __init__(self):
            self.on = False
            self.knob = knob or P.KNOB_DENSITY
            self.new, self.old = new, old

        def propose(self, snap, ctx):
            if not self.on:
                return None
            return P.PolicyDecision(step=snap.step, rule=self.name,
                                    knob=self.knob, old=self.old,
                                    new=self.new, reason="flag on")

    return FlagRule()


def _feed(engine, step, step_s=0.1, loss=1.0, **extra):
    engine.emit({"event": "train", "step": step, "loss": loss,
                 "step_s": step_s, "wire_format": "u16bf16", **extra})


def _log(eng):
    return [dict(e) for e in eng.decision_log]


# ------------------------------------------------------------- the package

def test_constants_and_floor_match_the_reference():
    from gaussiank_sgd_tpu.parallel.wire import WIRE_LEGACY as JWIRE
    from gaussiank_sgd_torch.compressors.registry import DEFAULT_SELECTOR
    from gaussiank_sgd_torch.parallel.wire import WIRE_LEGACY
    assert trules.WIRE_LEGACY == WIRE_LEGACY == JWIRE
    assert trules.DEFAULT_SELECTOR == DEFAULT_SELECTOR
    assert tpolicy.KNOBS == jpolicy.KNOBS
    assert trules.MODEL_CONFIG_KEYS == jrules.MODEL_CONFIG_KEYS
    assert sorted(tpolicy.__all__) == sorted(jpolicy.__all__)
    assert trules.ExchangePromotionRule.ELIGIBLE_PLAN == \
        jrules.ExchangePromotionRule.ELIGIBLE_PLAN
    for comp, density in (("gaussian", 0.001), ("gaussian_fused", 0.01),
                          ("topk", 0.05), ("none", 0.001)):
        cfg = TrainConfig(compressor=comp, density=density)
        assert _plain([vars(r) for r in trules.default_rules(cfg)]) == \
            _plain([vars(r) for r in jrules.default_rules(cfg)])
        assert [type(r).__name__ for r in trules.default_rules(cfg)] == [
            type(r).__name__ for r in jrules.default_rules(cfg)]


# ------------------------------------------------------------- engine

def test_hysteresis_blocks_oscillating_proposal():
    def scenario(P, trace):
        rule = _flag_rule(P)
        eng = P.PolicyEngine([rule], hysteresis=2, cooldown=0,
                             knobs={P.KNOB_DENSITY: "0.01"})
        step = 0
        for tick in range(12):
            step += 10
            _feed(eng, step)
            rule.on = (tick % 2 == 0)
            d = eng.decide()
            trace.append(d)
            assert d is None, f"flapped at tick {tick}"
        assert eng.recompiles == 0
        rule.on = True
        _feed(eng, step + 10)
        assert eng.decide() is None
        _feed(eng, step + 20)
        d = eng.decide()
        assert d is not None and d.key == (P.KNOB_DENSITY, "0.005")
        trace += [d, eng.signals.snapshot()]
    _both(scenario)


def test_recompile_count_bounded_by_budget_over_long_run():
    def scenario(P, trace):
        class Greedy(P.Rule):
            name = "greedy"
            n = 0

            def propose(self, snap, ctx):
                cur = ctx.knobs.get(P.KNOB_DENSITY, "0")
                return P.PolicyDecision(step=snap.step, rule=self.name,
                                        knob=P.KNOB_DENSITY, old=cur,
                                        new=f"{self.n}", reason="more")

        rule = Greedy()
        eng = P.PolicyEngine([rule], hysteresis=1, cooldown=0, probation=1,
                             budget=5, knobs={P.KNOB_DENSITY: "0.01"})
        applied = 0
        for tick in range(200):
            rule.n = tick
            _feed(eng, 10 * (tick + 1))
            assert eng.check_revert() is None
            d = eng.decide()
            trace.append(d)
            if d is not None:
                eng.note_applied(d)
                applied += 1
        assert eng.recompiles == applied <= 5
        assert eng.budget_left == 0
        assert eng.decide() is None
        trace.append(_log(eng))
    _both(scenario)


def test_decide_noops_while_rollback_pending_and_probation_reverts():
    def scenario(P, trace):
        rule = _flag_rule(P)
        eng = P.PolicyEngine([rule], hysteresis=1, cooldown=0,
                             knobs={P.KNOB_DENSITY: "0.01"})
        rule.on = True
        _feed(eng, 10)
        assert eng.decide(rollback_pending=True) is None
        assert eng.check_revert(rollback_pending=True) is None
        d = eng.decide()
        assert d is not None
        eng.note_applied(d)
        assert eng.on_probation and eng.decide() is None
        rev = eng.check_revert(rollback_pending=True)
        assert rev is not None and (rev.new, rev.old) == ("0.01", "0.005")
        eng.note_reverted(rev)
        assert (P.KNOB_DENSITY, "0.005") in eng.quarantine
        assert not eng.on_probation
        for step in (60, 70, 80):
            _feed(eng, step)
            assert eng.decide() is None
        assert [e["event"] for e in eng.decision_log] == [
            "policy_decision", "policy_revert"]
        trace += [d, rev, eng.quarantine, eng.knobs, _log(eng)]
    _both(scenario)


def test_probation_clears_after_clean_window_and_skip_burst_reverts():
    def scenario(P, trace):
        rule = _flag_rule(P)
        eng = P.PolicyEngine([rule], hysteresis=1, cooldown=0, probation=2,
                             skip_burst=3, knobs={P.KNOB_DENSITY: "0.01"})
        rule.on = True
        _feed(eng, 10)
        eng.note_applied(eng.decide())
        for step in (20, 30):
            _feed(eng, step)
            assert eng.check_revert() is None
        assert not eng.on_probation
        rule.new, rule.old = "0.0025", "0.005"
        eng._knobs[P.KNOB_DENSITY] = "0.005"
        _feed(eng, 40)
        eng.note_applied(eng.decide())
        for s in (41, 42, 43):
            eng.emit({"event": "skip", "step": s, "reason": "nonfinite"})
        _feed(eng, 50)
        rev = eng.check_revert()
        assert rev is not None and "skip burst" in rev.reason
        eng.note_reverted(rev)
        trace += [rev, eng.signals.snapshot(), _log(eng)]
    _both(scenario)


def test_loss_spike_during_probation_reverts():
    def scenario(P, trace):
        rule = _flag_rule(P)
        eng = P.PolicyEngine([rule], hysteresis=1, cooldown=0, probation=5,
                             loss_spike_factor=1.5,
                             knobs={P.KNOB_DENSITY: "0.01"})
        rule.on = True
        for step in (10, 20):
            _feed(eng, step, loss=1.0)
        eng.note_applied(eng.decide())
        _feed(eng, 30, loss=4.0)
        rev = eng.check_revert()
        assert rev is not None and "loss EMA" in rev.reason
        eng.note_reverted(rev, quarantined=False)
        trace += [rev, eng.quarantine, _log(eng)]
    _both(scenario)


def test_health_gates_exploration_and_geometry_reset():
    """A non-ok health verdict holds every decision (reverts are not
    gated); ``reset_for_geometry`` drops the timing signals and keeps the
    trajectory ones; bench_regression records are counted."""
    def scenario(P, trace):
        rule = _flag_rule(P)
        rule.on = True
        eng = P.PolicyEngine([rule], hysteresis=1, cooldown=0,
                             knobs={P.KNOB_DENSITY: "0.01",
                                    P.KNOB_COMPRESSOR: "a"},
                             signals=P.PolicySignals(settle=0))
        _feed(eng, 10, ef_norm=3.0, grad_norm=1.0, bytes_sent=4096,
              density_achieved=0.01, overlap="off")
        eng.emit({"event": "health_status", "step": 10, "state_code": 1,
                  "causes": ["data_wait", 7]})
        eng.emit({"event": "bench_regression", "status": "regressed",
                  "worst_config": "vgg16"})
        eng.emit({"event": "bench_regression", "status": "ok"})
        trace.append(eng.signals.snapshot())
        assert eng.decide() is None
        eng.emit({"event": "health_status", "step": 12, "state_code": 0,
                  "causes": []})
        eng.signals.reset_for_geometry(3)
        snap = eng.signals.snapshot()
        assert snap.arm_step_s == {} and snap.bytes_per_step is None
        assert snap.loss_ema == 1.0 and snap.bench_regressions == 1
        trace += [snap, eng.decide()]
    _both(scenario)


# ------------------------------------------------------------- signals

def test_signals_settle_excludes_compile_polluted_intervals():
    def scenario(P, trace):
        sig = P.PolicySignals(settle=1)
        sig.bind_arm("a")
        sig.update({"event": "train", "step": 10, "step_s": 99.0,
                    "wire_format": "u16bf16"})
        sig.update({"event": "train", "step": 20, "step_s": 0.1,
                    "wire_format": "u16bf16"})
        snap = sig.snapshot()
        assert snap.arm_step_s["a"] == pytest.approx(0.1)
        assert snap.arm_intervals["a"] == 1
        sig.update({"event": "train", "step": 30, "step_s": 0.05})
        snap2 = sig.snapshot()
        assert snap2.dense_step_s_ema == pytest.approx(0.05)
        trace += [snap, snap2]
    _both(scenario)


def test_signals_skips_after_and_rollback_step():
    def scenario(P, trace):
        sig = P.PolicySignals()
        for s in (5, 7, 12):
            sig.update({"event": "skip", "step": s, "reason": "nonfinite"})
        snap = sig.snapshot()
        assert snap.skips_after(6) == 2 and snap.skips_after(0) == 3
        sig.update({"event": "rollback", "to_step": 4,
                    "reason": "skip_budget"})
        snap2 = sig.snapshot()
        assert snap2.last_rollback_step == 4
        assert snap2.skips_after(0) == 0 and snap2.consecutive_skips == 0
        trace += [snap, snap2, snap.skips_after(6)]
    _both(scenario)


def test_signals_ef_ratio_ignores_dense_warmup_records():
    def scenario(P, trace):
        sig = P.PolicySignals()
        for step in (10, 20, 30):
            sig.update({"event": "train", "step": step, "step_s": 0.1,
                        "ef_norm": 0.0, "grad_norm": 2.0})
        snap = sig.snapshot()
        assert snap.ef_grad_ratio is None and snap.ef_ratio_intervals == 0
        sig.update({"event": "train", "step": 40, "step_s": 0.1,
                    "ef_norm": 1.0, "grad_norm": 2.0,
                    "wire_format": "u16bf16"})
        snap2 = sig.snapshot()
        assert snap2.ef_grad_ratio == pytest.approx(0.5)
        trace += [snap, snap2]
    _both(scenario)


def test_arm_records_reset_on_layout_change_keeps_dense_reference():
    def scenario(P, trace):
        rule = _flag_rule(P)
        eng = P.PolicyEngine([rule], hysteresis=1, cooldown=0,
                             knobs={P.KNOB_COMPRESSOR: "a",
                                    P.KNOB_DENSITY: "0.01"},
                             signals=P.PolicySignals(settle=0))
        eng.emit({"event": "train", "step": 10, "step_s": 0.05})
        _feed(eng, 20, step_s=0.1)
        assert eng.signals.snapshot().arm_step_s["a"] == pytest.approx(0.1)
        rule.on = True
        _feed(eng, 30, step_s=0.1)
        eng.note_applied(eng.decide())
        snap = eng.signals.snapshot()
        assert "a" not in snap.arm_step_s
        assert snap.dense_step_s_ema == pytest.approx(0.05)
        trace += [snap, _log(eng)]
    _both(scenario)


# ------------------------------------------------------------- rules

def test_selector_rule_regret_and_exploration_paths():
    def scenario(P, trace):
        r = P.SelectorRule(["a", "b", "c"], floor_factor=1.3, regret=0.08,
                           min_arm_intervals=2)
        ctx = P.RuleContext(knobs={P.KNOB_COMPRESSOR: "a"},
                            roofline_floor_ms=1.0)
        snaps = [
            dict(step=10, arm_step_s={"a": 0.100, "b": 0.090},
                 arm_intervals={"a": 3, "b": 3}),
            dict(step=10, arm_step_s={"a": 0.095, "b": 0.090},
                 arm_intervals={"a": 3, "b": 3}),
            dict(step=10, arm_step_s={"a": 0.100}, arm_intervals={"a": 3},
                 dense_step_s_ema=0.095),
            dict(step=10, arm_step_s={"a": 0.100}, arm_intervals={"a": 1},
                 dense_step_s_ema=0.095),
            dict(step=10, arm_step_s={"a": 0.100}, arm_intervals={"a": 3},
                 dense_step_s_ema=0.0995)]
        ctx_q = P.RuleContext(knobs={P.KNOB_COMPRESSOR: "a"},
                              roofline_floor_ms=1.0,
                              quarantine=frozenset({(P.KNOB_COMPRESSOR,
                                                     "b")}))
        for kw in snaps:
            snap = P.SignalSnapshot(**kw)
            for c in (ctx, ctx_q, P.RuleContext(
                    knobs={P.KNOB_COMPRESSOR: "a"})):
                trace.append(r.propose(snap, c))
        d0, d2 = trace[0], trace[6]
        assert d0.new == "b" and d0.knob == P.KNOB_COMPRESSOR
        assert trace[3] is None and d2.new == "b" and trace[7].new == "c"
        assert trace[8] is None                # no floor: no exploration
    _both(scenario)


def test_density_rule_ef_pressure_both_directions():
    def scenario(P, trace):
        r = P.DensityRule(min_density=1e-4, max_density=0.02)
        for cur in ("0.001", "0.02", "0.0001"):
            ctx = P.RuleContext(knobs={P.KNOB_DENSITY: cur})
            for kw in (dict(ef_grad_ratio=3.0, ef_ratio_trend=0.5),
                       dict(ef_grad_ratio=0.1, ef_ratio_trend=-0.1),
                       dict(ef_grad_ratio=3.0, ef_ratio_trend=-0.1),
                       dict(ef_grad_ratio=1.0, ef_ratio_trend=0.0)):
                for n in (2, 8):
                    trace.append(r.propose(P.SignalSnapshot(
                        step=10, intervals=100, ef_ratio_intervals=n, **kw),
                        ctx))
        up, down = trace[1], trace[3]
        assert float(up.new) == pytest.approx(0.002)
        assert float(down.new) == pytest.approx(0.0005)
        assert trace[0] is None and trace[5] is None
        assert trace[9] is None                # clamped at the top
        banned = P.RuleContext(knobs={P.KNOB_DENSITY: "0.001"},
                               quarantine=frozenset({(P.KNOB_DENSITY,
                                                      "0.002")}))
        trace.append(r.propose(P.SignalSnapshot(
            step=10, ef_ratio_intervals=8, ef_grad_ratio=3.0,
            ef_ratio_trend=0.5), banned))
        assert trace[-1] is None
    _both(scenario)


def test_wire_promotion_rule_gates():
    def scenario(P, trace):
        r = P.ExchangePromotionRule(min_bytes_per_step=1000)
        base = dict(step=10, wire_format="i32f32", bytes_per_step=5000.0)
        ctx = P.RuleContext(knobs={P.KNOB_WIRE: "auto",
                                   P.KNOB_BUCKET: "greedy:"})
        for kw, c in ((base, ctx),
                      (dict(base, wire_format="u16bf16"), ctx),
                      (base, P.RuleContext(knobs={
                          P.KNOB_WIRE: "off", P.KNOB_BUCKET: "greedy:"})),
                      (dict(base, bytes_per_step=10.0), ctx),
                      (base, P.RuleContext(knobs={
                          P.KNOB_WIRE: "auto",
                          P.KNOB_BUCKET: "uniform:65536"})),
                      (base, P.RuleContext(
                          knobs={P.KNOB_WIRE: "auto",
                                 P.KNOB_BUCKET: "greedy:"},
                          quarantine=frozenset({(P.KNOB_BUCKET,
                                                 "uniform:65536")})))):
            trace.append(r.propose(P.SignalSnapshot(**kw), c))
        d = trace[0]
        assert d.knob == P.KNOB_BUCKET and d.new == "uniform:65536"
        assert trace[1:] == [None] * 5
    _both(scenario)


def test_overlap_promotion_rule_gates():
    """Fires only on a sequential schedule that moves material bytes on a
    uniform plan, and not when the flip is quarantined."""
    def scenario(P, trace):
        r = P.OverlapPromotionRule(min_bytes_per_step=1000)
        base = dict(step=10, overlap="off", bytes_per_step=5000.0)
        knobs = {P.KNOB_OVERLAP: "off", P.KNOB_BUCKET: "uniform:65536"}
        for kw, k, q in ((base, knobs, ()),
                         (base, dict(knobs, **{P.KNOB_OVERLAP: "auto"}), ()),
                         (dict(base, overlap="pipelined"), knobs, ()),
                         (dict(base, overlap=None), knobs, ()),
                         (dict(base, bytes_per_step=10.0), knobs, ()),
                         (base, dict(knobs, **{P.KNOB_BUCKET: "greedy:"}),
                          ()),
                         (base, knobs, ((P.KNOB_OVERLAP, "auto"),))):
            trace.append(r.propose(P.SignalSnapshot(**kw), P.RuleContext(
                knobs=k, quarantine=frozenset(q))))
        d = trace[0]
        assert (d.knob, d.old, d.new) == (P.KNOB_OVERLAP, "off", "auto")
        assert trace[1:] == [None] * 6
    _both(scenario)


# ------------------------------------------------- seeded record streams

def _random_ops(seed, n=160):
    """A seeded stream of bus records and boundary ticks: train intervals
    (sparse and dense, with every signal key and some junk values), skips,
    rollbacks, health verdicts and bench regressions."""
    rng = np.random.default_rng(seed)
    ops, step = [], 0
    for _ in range(n):
        u = rng.random()
        step += int(rng.integers(1, 4))
        if u < 0.55:
            rec = {"event": "train", "step": step,
                   "loss": float(rng.lognormal(0.0, 0.4)),
                   "step_s": float(rng.choice([0.0, 0.05, 0.1, 0.2])
                                   * rng.uniform(0.8, 1.2)),
                   "ef_norm": float(rng.uniform(0, 4)),
                   "grad_norm": float(rng.uniform(0, 2)),
                   "density_achieved": float(rng.uniform(0, 0.02)),
                   "bytes_sent": int(rng.integers(0, 1 << 22)),
                   "skipped": float(rng.random() < 0.1)}
            if rng.random() < 0.8:
                rec["wire_format"] = str(rng.choice(["i32f32", "u16bf16"]))
                rec["overlap"] = str(rng.choice(["off", "pipelined"]))
            if rng.random() < 0.05:
                rec["loss"] = True                 # not a number: ignored
            ops.append(("emit", rec))
        elif u < 0.62:
            ops.append(("emit", {"event": "skip", "step": step}))
        elif u < 0.64:
            ops.append(("emit", {"event": "rollback",
                                 "to_step": max(0, step - 6)}))
        elif u < 0.68:
            ops.append(("emit", {"event": "health_status", "step": step,
                                 "state_code": int(rng.choice([0, 0, 1, 2])),
                                 "causes": ["data_wait"]}))
        elif u < 0.69:
            ops.append(("emit", {"event": "bench_regression",
                                 "status": "regressed", "new_rev": "r2"}))
        else:
            ops.append(("tick", bool(rng.random() < 0.1)))
    return ops


@pytest.mark.parametrize("seed", range(6))
def test_engine_matches_reference_on_seeded_streams(seed):
    """The shipped rules (with a floor, so the selector explores) over a
    seeded stream, ticked as the trainer ticks: the same snapshot after
    every record, the same decisions, and the same decision log."""
    ops = _random_ops(seed)

    def scenario(P, trace):
        cfg = TrainConfig(compressor="gaussian_fused", density=0.001,
                          wire="auto", bucket_size=None, overlap="off")
        size = ""
        knobs = {P.KNOB_COMPRESSOR: "gaussian_fused",
                 P.KNOB_DENSITY: "0.001", P.KNOB_WIRE: "auto",
                 P.KNOB_BUCKET: f"uniform:{size}" if seed % 2 else
                 "greedy:", P.KNOB_OVERLAP: "off"}
        eng = P.PolicyEngine(P.default_rules(cfg), knobs=knobs,
                             floor_ms=1.0 if seed % 3 else None,
                             hysteresis=1 + seed % 2, cooldown=seed % 3,
                             budget=6, probation=2, skip_burst=3)
        for kind, arg in ops:
            if kind == "emit":
                eng.emit(arg)
                trace.append(eng.signals.snapshot())
                continue
            rev = eng.check_revert(rollback_pending=arg)
            trace.append(rev)
            if rev is not None:
                eng.note_reverted(rev)
                continue
            d = eng.decide(rollback_pending=arg)
            trace.append(d)
            if d is not None:
                eng.note_applied(d)
        trace += [_log(eng), eng.knobs, eng.quarantine, eng.recompiles]
    out = _both(scenario)
    assert out[-1] >= 1                     # something was decided


# ------------------------------------------------------------- the trainer

def _script_rule(P, script):
    """A rule that proposes each (knob, value) of ``script`` in turn until
    the engine's knobs hold it (a quarantined one is filtered out by the
    engine)."""

    class ScriptRule(P.Rule):
        name = "script"

        def __init__(self):
            self.i = 0

        def propose(self, snap, ctx):
            while (self.i < len(script)
                   and ctx.knobs.get(script[self.i][0]) == script[self.i][1]):
                self.i += 1
            if self.i >= len(script):
                return None
            knob, new = script[self.i]
            return P.PolicyDecision(step=snap.step, rule=self.name,
                                    knob=knob, old=ctx.knobs[knob], new=new,
                                    reason=f"scripted {knob} -> {new}")

    return ScriptRule()


def _scripted(engine, P, script, skip_burst=2):
    engine.rules = [_script_rule(P, script)]
    engine._hysteresis = 1
    engine._cooldown = 0
    engine._skip_burst = skip_burst
    # the scripted scenarios test the skip and rollback nets; park the
    # loss-spike net (a narrow run's early loss is spiky)
    engine._loss_spike_factor = 1e9


def _jrecords(jt, kind):
    with open(os.path.join(jt.run_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["event"] == kind]


def _payload(rec):
    return {k: v for k, v in rec.items()
            if k not in ("ts", "seq", "schema_version", "trace_id")}


@pytest.mark.parametrize("case", ["skip_burst", "rollback_pending"])
def test_adaptive_trainer_matches_reference(tmp_path, case):
    """Both trainers, the same scripted rule: compressor gaussian ->
    gaussian_warm at the first sparse boundary, then density 0.01 -> 0.02
    once that decision's probation has passed; NaN batches on the two steps
    after the density decision. With
    ``skip_burst`` the engine reverts the density decision (skip burst),
    with ``rollback_pending`` two consecutive skips pend a rollback, the
    revert lands first and the rollback restores into the reverted
    layout. Same decision and revert records, same knob history, losses
    within the trajectory tolerance."""
    from gaussiank_sgd_tpu.training import chaos as jchaos
    from test_torch_resilience import _pair
    t, jt = _pair(tmp_path, policy="adaptive", max_steps=12, log_every=2,
                  max_consecutive_skips=(2 if case == "rollback_pending"
                                         else 10))
    script = [("compressor", "gaussian_warm"), ("density", "0.02")]
    _scripted(t.engine, tpolicy, script)
    _scripted(jt.engine, jpolicy, script)
    # the compressor decision's probation ends at step 8, where the density
    # decision is taken; then the NaN batches feed steps 9 and 10 (poisoned
    # after the decision: its rebuild drops the batches pulled ahead)
    t.train(8)
    jt.train(8)
    assert t.engine.recompiles == jt.engine.recompiles == 2
    chaos.inject_nan_batches(t, {8, 9})
    jchaos.inject_nan_batches(jt, {8, 9})
    t.train(t.total_steps - t.step)
    jt.train(jt.total_steps - jt.step)
    port = [_payload(r) for r in read_events(t)
            if r["event"] in ("policy_decision", "policy_revert",
                              "rollback")]
    ref = [_payload(r) for r in _jrecords(jt, "policy_decision")
           + _jrecords(jt, "policy_revert") + _jrecords(jt, "rollback")]
    key = (lambda r: (r["event"], r.get("step", r.get("to_step"))))
    port_cmp = sorted(({k: v for k, v in r.items() if k != "checkpoint"}
                       for r in port), key=key)
    ref_cmp = sorted(({k: v for k, v in r.items()
                       if k not in ("checkpoint", "process_index")}
                      for r in ref), key=key)
    assert port_cmp == ref_cmp
    events = [r["event"] for r in port]
    assert events.count("policy_decision") == 2
    assert events.count("policy_revert") == 1
    rev = next(r for r in port if r["event"] == "policy_revert")
    assert rev["quarantined"] and rev["knob"] == "density"
    if case == "skip_burst":
        assert "skip burst" in rev["reason"] and "rollback" not in events
    else:
        assert "rollback pending" in rev["reason"]
        assert events.index("policy_revert") < events.index("rollback")
    assert t.engine.knobs == jt.engine.knobs
    assert (t.cfg.compressor, t.cfg.density) == ("gaussian_warm", 0.01)
    assert t.engine.quarantine == jt.engine.quarantine == {
        ("density", "0.02")}
    losses = [r["loss"] for r in read_events(t, "train")]
    jlosses = [r["loss"] for r in _jrecords(jt, "train")]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-6)
    assert math.isfinite(losses[-1])
    # the keys the signals read, in the port's train records as in the
    # reference's
    keys = ("step_s", "loss", "ef_norm", "grad_norm", "density_achieved",
            "bytes_sent", "wire_format", "overlap")
    trains = read_events(t, "train")
    jtrains = _jrecords(jt, "train")
    for rec, jrec in zip(trains, jtrains):
        assert {k for k in keys if k in rec} == {k for k in keys
                                                 if k in jrec}
        assert rec.get("wire_format") == jrec.get("wire_format")
    from gaussiank_sgd_torch.telemetry.events import validate_file
    assert validate_file(t.metrics_path, strict=True).ok
    t.close()
    jt.close()


def _narrow(tmp_path, run_id="p", **kw):
    base = dict(dnn="vgg16", batch_size=16, compressor="gaussian_fused",
                density=0.01, compress_warmup_steps=2, max_steps=10,
                log_every=2, lr=0.05, compute_dtype="float32", device="cpu",
                model_kwargs={"cfg": NARROW}, output_dir=str(tmp_path),
                run_id=run_id, eval_every_epochs=0, save_every_epochs=0)
    base.update(kw)
    return TrainConfig(**base)


def test_fused_unfused_switch_keeps_the_first_n_entries(tmp_path):
    """gaussian_fused (the block-padded flat length) -> gaussian_pallas
    (unpadded) -> gaussian_fused: at each rebuild the parameter, the
    momentum and the EF row keep their first n entries bit for bit, the
    tail is zero, the parameter is the model's (re-allocated) one, and the
    thresholds start fresh."""
    t = Trainer(_narrow(tmp_path, policy="adaptive", save_every_steps=2,
                        trace="on", max_steps=10))
    _scripted(t.engine, tpolicy, [("compressor", "gaussian_pallas"),
                                  ("compressor", "gaussian_fused")])
    n = t.plan.total_numel
    padded = t.ts.ef_numel
    assert padded > n
    seen = []
    rebuild = t._rebuild_for_policy

    def checked():
        old = t.state
        before = [old.params.detach().clone(), old.opt_state["m"].clone(),
                  old.ef_residual.clone()]
        rebuild()
        new = t.state
        after = [new.params.detach(), new.opt_state["m"], new.ef_residual]
        for b, a in zip(before, after):
            assert torch.equal(a[:n], b[:n])
            assert a.numel() == t.ts.ef_numel and not a[n:].any()
        assert new.params is t.model.flat and new.step == old.step
        assert new.comp_state is None or torch.equal(
            new.comp_state, torch.full_like(new.comp_state,
                                            t.comp.init_state))
        seen.append((before[0].numel(), after[0].numel()))

    t._rebuild_for_policy = checked
    t.train(t.total_steps)
    assert seen == [(padded, n), (n, padded)]
    assert t.comp.name == "gaussian_fused" and t.engine.recompiles == 2
    kinds = [r["kind"] for r in t.records]
    assert kinds == ["dense"] * 2 + ["sparse"] * 8
    assert all(math.isfinite(r["loss"]) for r in t.records)
    spans = [r["name"] for r in read_events(t, "span")]
    assert spans.count("policy_rebuild") == 2
    t.close()


def test_policy_tick_gated_during_dense_warmup(tmp_path):
    t = Trainer(make_cfg(tmp_path, compress_warmup_steps=8, max_steps=10,
                         log_every=2, policy="adaptive"))
    flag = _flag_rule(tpolicy)
    flag.on = True
    t.engine.rules = [flag]
    t.engine._hysteresis = 1
    t.train(6)
    assert t.engine.recompiles == 0 and t.cfg.density == 0.01
    t.train(2)
    assert t.engine.recompiles == 1 and t.cfg.density == 0.005
    t.close()


def test_adaptive_rejects_dense_only_run(tmp_path):
    with pytest.raises(ValueError, match="adaptive"):
        Trainer(make_cfg(tmp_path, compressor="none", policy="adaptive"))


def test_chaos_bad_decision_auto_reverted_and_training_recovers(tmp_path):
    """The reference's chaos arm on the port (mnistnet, one worker): a
    decision applied at the first sparse boundary, a skip burst inside its
    probation, the revert and quarantine, and a finite loss at the end."""
    t = Trainer(make_cfg(tmp_path, max_steps=24, compress_warmup_steps=2,
                         log_every=2, policy="adaptive"))
    flag = _flag_rule(tpolicy)
    t.engine.rules = [flag]
    t.engine._hysteresis = 1
    t.engine._skip_burst = 2
    t.engine._loss_spike_factor = 1e9
    flag.on = True
    t.train(6)
    assert t.engine.recompiles == 1 and t.cfg.density == 0.005
    flag.on = False
    chaos.inject_nan_batches(t, {6, 7})
    t.train(t.total_steps - t.step)
    assert t.cfg.density == 0.01
    assert ("density", "0.005") in t.engine.quarantine
    assert t.engine.recompiles == 2
    from gaussiank_sgd_torch.telemetry.events import validate_file
    assert validate_file(t.metrics_path, strict=True).ok
    kinds = [r["event"] for r in read_events(t)]
    assert kinds.count("policy_decision") == kinds.count(
        "policy_revert") == 1
    rev = read_events(t, "policy_revert")[0]
    assert rev["new"] == "0.01" and rev["quarantined"]
    assert "skip burst" in rev["reason"]
    assert math.isfinite(read_events(t, "train")[-1]["loss"])
    assert t.step == t.total_steps
    t.close()


def test_policy_static_is_bit_for_bit_a_run_without_the_key(tmp_path):
    """A config file with ``"policy": "static"`` and one without the key:
    no engine, the same stream of events and the same parameters bit for
    bit; ``"policy": "adaptive"`` loads and trains."""
    import argparse
    from gaussiank_sgd_torch.training.config import add_args, from_args
    out = {}
    for name, extra in (("static", {"policy": "static"}), ("none", {}),
                        ("adaptive", {"policy": "adaptive"})):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps({
            "dnn": "vgg16", "compressor": "gaussian_fused", "density": 0.01,
            "batch_size": 16, "compress_warmup_steps": 2, "max_steps": 6,
            "log_every": 2, "compute_dtype": "float32", **extra}))
        argv = ["--config", str(path), "--device", "cpu", "--model-kwargs",
                json.dumps({"cfg": NARROW}), "--output-dir", str(tmp_path),
                "--run-id", name]
        p = argparse.ArgumentParser()
        add_args(p)
        t = Trainer(from_args(p.parse_args(argv), argv))
        assert (t.engine is None) == (name != "adaptive")
        t.train(6)
        out[name] = (t.state.params.detach().clone(),
                     [r["event"] for r in read_events(t)])
        t.close()
    assert torch.equal(out["static"][0], out["none"][0])
    assert out["static"][1] == out["none"][1]
    assert all(math.isfinite(v) for v in out["adaptive"][0][:10].tolist())


def _w_policy_ranks(rank, world, cfg_kw):
    import hashlib

    from gaussiank_sgd_torch.policy import PolicyDecision, Rule
    from gaussiank_sgd_torch.training.config import TrainConfig
    from gaussiank_sgd_torch.training.trainer import Trainer

    class FastArmRule(Rule):
        """Proposes the pallas selector while the arm's step EMA is under
        a second: rank 0's real narrow steps are; rank 1's skewed ones are
        not, so rank 1's engine alone would never decide."""
        name = "fast_arm"

        def propose(self, snap, ctx):
            if (ctx.knobs["compressor"] == "gaussian_fused"
                    and snap.step_s_ema is not None
                    and snap.step_s_ema < 1.0):
                return PolicyDecision(step=snap.step, rule=self.name,
                                      knob="compressor",
                                      old="gaussian_fused",
                                      new="gaussian_pallas", reason="fast")
            return None

    t = Trainer(TrainConfig(**cfg_kw))
    t.engine.rules = [FastArmRule()]
    t.engine._hysteresis = 1
    t.engine._loss_spike_factor = 1e9
    emas, tick = [], t._policy_tick

    def noting(rollback_pending):
        emas.append(t.engine.signals.snapshot().step_s_ema)
        tick(rollback_pending)

    t._policy_tick = noting
    if rank == 1:
        emit = t.engine.emit

        def skewed(record):
            if record.get("event") == "train" and "step_s" in record:
                record = {**record, "step_s": 1000.0 * record["step_s"]}
            emit(record)

        t.engine.emit = skewed
    t.train(t.total_steps)
    params = t.state.params.detach().numpy()
    out = {"log": [dict(e) for e in t.engine.decision_log],
           "sha": hashlib.sha256(params.tobytes()).hexdigest(),
           "comp": t.comp.name, "emas": emas}
    t.close()
    return out


def test_two_ranks_apply_rank0_decisions(tmp_path):
    kw = dataclasses.asdict(_narrow(tmp_path, nworkers=2, batch_size=8,
                                    max_steps=8, policy="adaptive"))
    outs = _spawn(tmp_path, 2, _w_policy_ranks, cfg_kw=kw)
    assert outs[0]["log"] == outs[1]["log"]
    assert [e["new"] for e in outs[0]["log"]] == ["gaussian_pallas"]
    assert outs[0]["comp"] == outs[1]["comp"] == "gaussian_pallas"
    assert outs[0]["sha"] == outs[1]["sha"]
    # at the boundary of the decision rank 0's arm EMA was under a second
    # and rank 1's over: rank 1's own engine would have decided nothing
    first = next(i for i, v in enumerate(outs[0]["emas"]) if v is not None)
    assert outs[0]["emas"][first] < 1.0 < outs[1]["emas"][first]
