"""Adaptive-policy A/B harness — the adaptive engine against every fixed
policy over the BASELINE matrix (port of ``analysis/policy_ab.py``).

Three modes, one acceptance contract:

* **replay** (default) — deterministic closed-loop replay of the port's
  :class:`~gaussiank_sgd_torch.policy.engine.PolicyEngine` (its rules,
  hysteresis, cooldown, budget, probation) over MEASURED per-arm step
  times from a bench matrix (default: the reference's committed
  ``analysis/artifacts/bench_matrix_r5.json``, which the port only reads).
  Each simulated log interval feeds the engine a schema-shaped ``train``
  record whose ``step_s`` is the measured time of the arm currently
  bound; decisions switch the arm and charge an explicit rebuild penalty.
  No wall-clock enters the loop, so the replay is bit-reproducible: over
  the reference's matrix it gives the reference's
  ``analysis/artifacts/policy_ab_r5.json`` key for key. Pure stdlib: the
  replay imports no torch.
* **--measure** — price the matrix on the card first with the port's
  ``bench_matrix --quick`` at most 10 steps a timed run, as the
  reference's ``--measure`` (``--configs`` narrows it), then replay over
  it with each config's floor from ``load_roofline_floor`` (the
  card-priced ``gaussiank_sgd_torch/artifacts/roofline.json``, on a card
  of its name), the reference's measured-arm proxy where none applies.
* **--smoke** — two LIVE mnistnet ``Trainer`` runs (``--policy static``
  vs ``--policy adaptive``, same seed) at one worker; holds the adaptive
  run's event stream to STRICT schema validation, its rebuilds to the
  engine's budget, and its median step time to the static run's within
  a tolerance. Exits non-zero on any violation.

Scoring (the acceptance metric), as the reference's: per config and per
policy, the **median interval step-throughput ratio** ``dense_ms /
interval_ms``; acceptance is minimax >= maximin (the adaptive policy's
worst config at least the best fixed policy's worst config) and at least
one strict win.

Artifact: ``policy_ab_<tag>.json`` in ``--out-dir`` (default
``gaussiank_sgd_torch/artifacts/``) — per-config per-policy medians and
means, the engine's decision log, rebuild counts and the acceptance
block.

Run: ``python -m gaussiank_sgd_torch.policy_ab [--matrix PATH] [--horizon
120] [--measure [--configs config2] | --smoke] [--device cpu]``.
"""

# gklint: disable-file=print-in-library -- this module is the CLI of `python -m gaussiank_sgd_torch.policy_ab`: its main() prints the summary, which is the command's output

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from typing import Dict, Optional

PKG = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(PKG)
ARTIFACTS = os.path.join(PKG, "artifacts")
DEFAULT_MATRIX = os.path.join(REPO, "analysis", "artifacts",
                              "bench_matrix_r5.json")

# simulated boundary cadence: one decision tick per log interval, the
# trainer's rebuild-safe boundary
STEPS_PER_INTERVAL = 10
# dense warm-up intervals fed before the sparse phase — gives the engine
# the measured dense reference the SelectorRule overhead gate needs
WARMUP_INTERVALS = 3
# one step rebuild priced in dense-step equivalents; explicit in the
# artifact so the charge is auditable (the reference's figure)
RECOMPILE_PENALTY_STEPS = 50
# --measure's steps a timed run, at most (the reference's horizon_steps)
MEASURE_STEPS = 10


def _load_matrix(path: str, density: float = 0.001):
    """-> [{key, dense_ms, arms: {name: sparse_ms}, platform}] per config."""
    with open(path) as f:
        entries = json.load(f)
    configs = []
    for e in entries:
        cells = [c for c in e["cells"] if c.get("density") == density]
        if not cells:
            continue
        configs.append({
            "key": e["config"],
            "model": e.get("model"),
            "platform": e.get("platform"),
            "dense_ms": float(cells[0]["dense_ms"]),
            "arms": {c["compressor"]: float(c["sparse_ms"]) for c in cells},
        })
    if not configs:
        raise ValueError(f"no density={density} cells in {path}")
    return configs


def _floor_proxy_ms(cfg) -> float:
    """Per-config exploration budget when no roofline floor applies: the
    best MEASURED arm's overhead (clamped to a small positive floor — a
    negative overhead means sparse beat dense, where exploration has
    nothing to buy)."""
    best = min(t - cfg["dense_ms"] for t in cfg["arms"].values())
    return max(best, 0.02 * cfg["dense_ms"])


def _replay_adaptive(cfg, horizon: int, start_arm: str, floor_ms: float):
    """Run the engine over measured arm times for one config.
    Returns (interval_ms list, decision events, rebuilds, final arm)."""
    from .policy import PolicyEngine, SelectorRule
    from .policy.rules import KNOB_COMPRESSOR

    decisions = []
    engine = PolicyEngine(
        [SelectorRule(list(cfg["arms"]))],
        publish=lambda ev, payload: decisions.append(
            dict(payload, event=ev, config=cfg["key"])),
        knobs={KNOB_COMPRESSOR: start_arm},
        floor_ms=floor_ms)

    dense_s = cfg["dense_ms"] / 1e3
    step = 0
    for _ in range(WARMUP_INTERVALS):
        step += STEPS_PER_INTERVAL
        # dense warm-up record: no wire_format field -> DENSE_ARM
        engine.emit({"event": "train", "step": step, "loss": 1.0,
                     "step_s": dense_s})

    arm = start_arm
    interval_ms = []
    for _ in range(horizon):
        step += STEPS_PER_INTERVAL
        arm_s = cfg["arms"][arm] / 1e3
        engine.emit({"event": "train", "step": step, "loss": 1.0,
                     "step_s": arm_s, "wire_format": "u16bf16",
                     "bytes_sent": 0.0})
        ms = cfg["arms"][arm]
        # boundary tick, trainer ordering: revert check first, then decide
        revert = engine.check_revert(rollback_pending=False)
        if revert is not None:           # never fires here (loss constant)
            arm = revert.new
            ms += RECOMPILE_PENALTY_STEPS * cfg["dense_ms"] \
                / STEPS_PER_INTERVAL
            engine.note_reverted(revert)
        else:
            d = engine.decide(rollback_pending=False)
            if d is not None and d.knob == KNOB_COMPRESSOR:
                arm = d.new
                ms += RECOMPILE_PENALTY_STEPS * cfg["dense_ms"] \
                    / STEPS_PER_INTERVAL
                engine.note_applied(d)
        interval_ms.append(ms)
    return interval_ms, decisions, engine.recompiles, arm


def run_replay(matrix_path: str, horizon: int,
               floors: Optional[Dict[str, Optional[float]]] = None):
    """The replay over ``matrix_path``. ``floors`` (config key -> floor ms
    or None) replaces the measured-arm proxy where it gives a floor, and
    then each config row records its floor and where it came from."""
    from .policy.rules import DEFAULT_SELECTOR

    configs = _load_matrix(matrix_path)
    fixed_policies = sorted({a for c in configs for a in c["arms"]})
    per_config = {}
    all_decisions = []
    total_recompiles = 0
    for cfg in configs:
        start = DEFAULT_SELECTOR if DEFAULT_SELECTOR in cfg["arms"] \
            else sorted(cfg["arms"])[0]
        floor = (floors or {}).get(cfg["key"])
        ims, decisions, recompiles, final_arm = _replay_adaptive(
            cfg, horizon, start,
            floor if floor is not None else _floor_proxy_ms(cfg))
        all_decisions.extend(decisions)
        total_recompiles += recompiles
        dense = cfg["dense_ms"]
        row = {
            "dense_ms": dense,
            "adaptive": {
                "ratio_median": round(dense / statistics.median(ims), 4),
                "ratio_mean": round(dense * len(ims) / sum(ims), 4),
                "recompiles": recompiles,
                "start_arm": start,
                "final_arm": final_arm,
            },
            "fixed": {},
        }
        if floors is not None:
            row["floor_ms"] = (floor if floor is not None
                               else round(_floor_proxy_ms(cfg), 4))
            row["floor_source"] = ("roofline" if floor is not None
                                   else "measured-arm proxy")
        for arm in fixed_policies:
            if arm not in cfg["arms"]:
                continue
            r = round(dense / cfg["arms"][arm], 4)
            row["fixed"][arm] = {"ratio_median": r, "ratio_mean": r}
        per_config[cfg["key"]] = row
    return {
        "configs": per_config,
        "fixed_policies": fixed_policies,
        "decision_log": all_decisions,
        "recompiles_total": total_recompiles,
        "horizon_intervals": horizon,
        "steps_per_interval": STEPS_PER_INTERVAL,
        "recompile_penalty_steps": RECOMPILE_PENALTY_STEPS,
        "matrix_source": os.path.relpath(matrix_path, REPO),
        "matrix_platform": configs[0].get("platform"),
    }


def evaluate(result) -> dict:
    """The acceptance block: minimax >= maximin + a strict win."""
    cfgs = result["configs"]
    adaptive_worst_key, adaptive_worst = min(
        ((k, row["adaptive"]["ratio_median"]) for k, row in cfgs.items()),
        key=lambda kv: kv[1])
    fixed_worst = {}
    for p in result["fixed_policies"]:
        vals = [row["fixed"][p]["ratio_median"] for row in cfgs.values()
                if p in row["fixed"]]
        fixed_worst[p] = min(vals)
    best_fixed, best_fixed_worst = max(fixed_worst.items(),
                                       key=lambda kv: kv[1])
    strict_wins = [
        {"config": k, "fixed_policy": p,
         "adaptive": row["adaptive"]["ratio_median"],
         "fixed": row["fixed"][p]["ratio_median"]}
        for k, row in cfgs.items() for p in row["fixed"]
        if row["adaptive"]["ratio_median"]
        > row["fixed"][p]["ratio_median"] + 1e-9]
    return {
        "adaptive_worst_config": adaptive_worst_key,
        "adaptive_worst_ratio_median": adaptive_worst,
        "fixed_worst_ratio_median": fixed_worst,
        "best_fixed_policy": best_fixed,
        "best_fixed_worst_ratio_median": best_fixed_worst,
        "minimax_ok": adaptive_worst >= best_fixed_worst,
        "n_strict_wins": len(strict_wins),
        "strict_wins_sample": strict_wins[:5],
        "ok": (adaptive_worst >= best_fixed_worst
               and len(strict_wins) > 0),
    }


# -- live measurement (the card) -------------------------------------------

def measure_matrix(device: str, out_dir: str,
                   configs: Optional[str] = None) -> str:
    """Price the matrix with ``bench_matrix``'s quick run on ``device``,
    at most ``MEASURE_STEPS`` steps a timed run; the path of the matrix it
    wrote (``bench_matrix_policy_ab.json`` in ``out_dir``)."""
    from . import bench_matrix
    bench_matrix.measure(quick=True, configs=configs, tag="policy_ab",
                         device=device, out_dir=out_dir,
                         max_steps=MEASURE_STEPS)
    return os.path.join(out_dir, "bench_matrix_policy_ab.json")


def card_floors(matrix_path: str, device: str) -> Dict[str, Optional[float]]:
    """Each config's floor from ``load_roofline_floor`` for the running
    card (None where no priced floor applies)."""
    import torch
    from .policy.rules import load_roofline_floor
    dev = torch.device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else None)
    return {cfg["key"]: load_roofline_floor(cfg["model"] or "", dev.type,
                                            device_name=name)
            for cfg in _load_matrix(matrix_path)}


# -- smoke: live adaptive vs static mnistnet Trainer ----------------------

SMOKE_TOLERANCE = 0.70   # adaptive examples/s >= 0.70x static (noise)


def run_smoke(tmp_dir: str, device: str = "cuda") -> dict:
    """Two live runs, same seed: --policy static vs --policy adaptive.
    The adaptive engine makes no decision on mnistnet (no roofline floor,
    no regret record), so this arm prices the CLOSED-LOOP OVERHEAD and
    validates the event plumbing, not the retuning. One worker (the
    reference's runs 8 on its virtual mesh)."""
    from .telemetry.events import validate_file
    from .training.config import TrainConfig
    from .training.trainer import Trainer

    def cfg(policy):
        return TrainConfig(
            dnn="mnistnet", dataset="mnist", batch_size=8, nworkers=1,
            lr=0.05, momentum=0.9, weight_decay=0.0, epochs=1,
            max_steps=40, compressor="gaussian", density=0.01,
            compress_warmup_steps=4, warmup_epochs=0.0,
            compute_dtype="float32", log_every=5, eval_every_epochs=0,
            save_every_epochs=0, seed=0, policy=policy, device=device,
            output_dir=os.path.join(tmp_dir, policy), run_id=policy)

    def median_step_s(run_dir):
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        ss = [r["step_s"] for r in recs if r.get("event") == "train"
              and isinstance(r.get("step_s"), (int, float))]
        # drop the first interval of each program (warm-up of the step)
        return statistics.median(ss[2:]) if len(ss) > 4 \
            else statistics.median(ss)

    problems = []
    runs = {}
    for policy in ("static", "adaptive"):
        t = Trainer(cfg(policy))
        t.train(t.total_steps - t.step)
        t.close()
        rep = validate_file(os.path.join(t.run_dir, "metrics.jsonl"),
                            strict=True)
        if not rep.ok:
            problems.append(f"{policy}: event stream invalid: "
                            f"{rep.errors[:3]}")
        runs[policy] = {
            "median_step_s": median_step_s(t.run_dir),
            "events": rep.events,
            "recompiles": (t.engine.recompiles if t.engine else 0),
            "budget_left": (t.engine.budget_left if t.engine else None),
            "decision_log": (t.engine.decision_log if t.engine else []),
        }
    a, s = runs["adaptive"], runs["static"]
    if a["recompiles"] > 8:
        problems.append(f"adaptive recompiles {a['recompiles']} > budget")
    slowdown = a["median_step_s"] / s["median_step_s"]
    if slowdown > 1.0 / SMOKE_TOLERANCE:
        problems.append(
            f"adaptive lost to static beyond tolerance: "
            f"median step_s {a['median_step_s']:.4f} vs "
            f"{s['median_step_s']:.4f} ({slowdown:.2f}x, "
            f"tolerance {1 / SMOKE_TOLERANCE:.2f}x)")
    return {
        "mode": "smoke", "runs": runs,
        "adaptive_over_static_step_s": round(slowdown, 4),
        "tolerance": round(1.0 / SMOKE_TOLERANCE, 4),
        "problems": problems, "ok": not problems,
    }


def run(argv=None) -> dict:
    """The CLI's work: the result, written to its artifact (its path under
    ``"artifact"``), and the summary printed."""
    ap = argparse.ArgumentParser(prog="python -m gaussiank_sgd_torch."
                                 "policy_ab",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--matrix", default=DEFAULT_MATRIX,
                    help="bench matrix artifact with per-arm cells")
    ap.add_argument("--horizon", type=int, default=120,
                    help="simulated log intervals per config")
    ap.add_argument("--measure", action="store_true",
                    help="price the matrix on the card with bench_matrix "
                         "--quick, then replay over it")
    ap.add_argument("--configs", default=None,
                    help="with --measure: bench_matrix's config filter")
    ap.add_argument("--smoke", action="store_true",
                    help="live mnistnet static-vs-adaptive run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, only when asked "
                         "(--measure and --smoke)")
    ap.add_argument("--tag", default=None,
                    help="artifact suffix (default: matrix basename tag)")
    ap.add_argument("--out-dir", default=ARTIFACTS)
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    if args.smoke:
        from .device import resolve_device
        resolve_device(args.device)
        import tempfile
        with tempfile.TemporaryDirectory() as td:
            result = run_smoke(td, args.device)
        tag = "smoke"
    elif args.measure:
        from .device import resolve_device
        dev = resolve_device(args.device)
        matrix = measure_matrix(args.device, args.out_dir, args.configs)
        result = run_replay(matrix, args.horizon,
                            floors=card_floors(matrix, args.device))
        result["acceptance"] = evaluate(result)
        tag = f"measured_{dev.type}"
    else:
        result = run_replay(args.matrix, args.horizon)
        result["acceptance"] = evaluate(result)
        tag = (os.path.basename(args.matrix).replace("bench_matrix_", "")
               .replace(".json", ""))

    out = os.path.join(args.out_dir, f"policy_ab_{args.tag or tag}.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    ok = result.get("ok", result.get("acceptance", {}).get("ok", False))
    summary = {
        "artifact": os.path.relpath(out, REPO), "ok": ok,
        **({"acceptance": {k: v for k, v in result["acceptance"].items()
                           if k != "strict_wins_sample"}}
           if "acceptance" in result else
           {"adaptive_over_static_step_s":
            result.get("adaptive_over_static_step_s"),
            "problems": result.get("problems")}),
    }
    print(json.dumps(summary, indent=1))
    return dict(result, artifact=out, ok=ok)


def main(argv=None) -> int:
    """0 when the run's contract holds (acceptance, or the smoke's
    checks), else 1."""
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
