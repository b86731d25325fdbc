"""The port's elastic service (``gaussiank_sgd_torch/service``) against the
reference's.

* Building blocks on the same inputs in both packages: the control plane
  (consume once, torn writes retried then rejected), the resize planner
  (bounds, drain, relaunch pressure, the sustained-critical streak) and the
  device pool (admission, fair growth): the same results.
* ``ElasticSupervisor`` over fake child handles (the reference test's
  ``_LiveProc``) on every path of the reference's tests: refusals before
  teardown, the accepted directive, commit inside and abort over the step
  budget, the arm by heartbeats, the wall-budget abort and its revert, an
  arm failure, control commands, a drain, and the real ``run`` loop over a
  fake pod. The supervisor streams of the two packages are the same record
  for record (times and paths aside) and validate strictly. Besides, a
  width NCCL cannot form is refused with ``resize_abort`` before any
  teardown, and the relaunched workers' spec follows the new width.
* Every new record validates on a strict bus; health attributes resizes as
  the reference's does; the scheduler admits, runs and releases jobs with
  fair growth and per-job health routes.
* A real service run on the CPU: two gloo ranks of a narrow VGG, worker 1
  SIGKILLed in generation 0, then 2 -> 3 -> 2 by ``--resize-at``: exit 0,
  both commits inside the step budget, the streams strictly valid and
  mergeable, health critical or degraded.
"""

import json
import os
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request

import pytest

import gaussiank_sgd_tpu.service as jservice
import gaussiank_sgd_tpu.service.scheduler as jscheduler
import gaussiank_sgd_tpu.telemetry as jtelemetry
import gaussiank_sgd_tpu.telemetry.health as jhealth
import gaussiank_sgd_tpu.training.config as jconfig
import gaussiank_sgd_tpu.training.launch as jlaunch
import gaussiank_sgd_torch.service as tservice
import gaussiank_sgd_torch.service.scheduler as tscheduler
import gaussiank_sgd_torch.telemetry as ttelemetry
import gaussiank_sgd_torch.telemetry.health as thealth
import gaussiank_sgd_torch.training.config as tconfig
import gaussiank_sgd_torch.training.launch as tlaunch
from gaussiank_sgd_torch.telemetry.__main__ import main as telemetry_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]

PKGS = {
    "port": types.SimpleNamespace(
        service=tservice, scheduler=tscheduler, launch=tlaunch,
        health=thealth, telemetry=ttelemetry,
        cfg=lambda **kw: tconfig.TrainConfig(device="cpu", **kw)),
    "ref": types.SimpleNamespace(
        service=jservice, scheduler=jscheduler, launch=jlaunch,
        health=jhealth, telemetry=jtelemetry,
        cfg=lambda **kw: jconfig.TrainConfig(**kw)),
}


def _both(tmp_path, scenario):
    """``scenario(P, d, out)`` in each package (``d`` a directory of its
    own); the two ``out`` lists must be equal."""
    outs = {}
    for name, P in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        out = []
        scenario(P, d, out)
        outs[name] = out
    assert outs["port"] == outs["ref"]
    return outs["port"]


# ---------------------------------------------------------- control plane

def test_control_plane_consumes_commands_once(tmp_path):
    def scenario(P, d, out):
        path = str(d / "control.json")
        cp = P.service.ControlPlane(path)
        out.append(cp.poll())
        P.service.ControlPlane.write(path, {"cmd": "resize", "nprocs": 4},
                                     {"cmd": "stop"})
        out += [cp.poll(), os.path.exists(path), cp.poll()]
    out = _both(tmp_path, scenario)
    assert out == [[], [{"cmd": "resize", "nprocs": 4}, {"cmd": "stop"}],
                   False, []]


def test_control_plane_retries_torn_write_then_rejects(tmp_path):
    def scenario(P, d, out):
        path = str(d / "control.json")
        cp = P.service.ControlPlane(path, max_retries=2)
        with open(path, "w") as fh:
            fh.write('{"cmd": "resi')
        for _ in range(3):
            out += [cp.poll(), os.path.exists(path)]
        out.append(cp.rejected)
        with open(path, "w") as fh:
            fh.write('{"cmd": "st')
        out.append(cp.poll())
        P.service.ControlPlane.write(path, {"cmd": "stop"})
        out += [cp.poll(), cp.rejected]
        with open(path, "w") as fh:
            fh.write('[1, 2]\n\n{"no": "cmd"}\n')
        cp.max_retries = 0
        out += [cp.poll(), cp.rejected, os.path.exists(path)]
    out = _both(tmp_path, scenario)
    assert out[:7] == [[], True, [], True, [], False, 1]
    assert out[-3:] == [[], 2, False]


# ---------------------------------------------------------------- planner

def test_planner_decisions_match_the_reference(tmp_path):
    crit = {"state_code": 2, "causes": ["worker_lost"]}
    ok = {"state_code": 0, "causes": []}
    other = {"state_code": 2, "causes": ["loss_regression"]}
    stall = {"state_code": 2, "causes": ["coordinator_stall"]}

    def scenario(P, d, out):
        def plain(x):
            return None if x is None else (x.nprocs, x.reason)
        pl = P.service.ResizePlanner(P.service.ResizePolicy(
            min_nprocs=2, max_nprocs=8))
        out.append([pl.clamp(n) for n in (0, 1, 2, 5, 8, 9)])
        out.append([plain(pl.on_drain(live, cur)) for live, cur in
                    ((3, 4), (4, 4), (1, 4), (0, 3))])
        pl = P.service.ResizePlanner(P.service.ResizePolicy(
            min_nprocs=1, pressure_relaunches_left=1))
        out.append([plain(pl.on_loss(cur, left)) for cur, left in
                    ((4, 2), (4, 1), (4, 0), (1, 0), (2, -1))])
        pl = P.service.ResizePlanner(P.service.ResizePolicy(
            sustained_critical=2))
        out.append([plain(pl.on_verdict(rec, cur)) for rec, cur in
                    ((crit, 4), (crit, 4), (crit, 3), (ok, 3), (crit, 3),
                     (other, 3), (other, 3), (stall, 3), (stall, 3),
                     (crit, 1), (crit, 1))])
    out = _both(tmp_path, scenario)
    assert out[0] == [None, None, 2, 5, 8, None]
    assert out[1][0] == (3, "preemption") and out[1][2][0] == 2
    assert out[3][1] == (3, "health_critical")


# ------------------------------------------------------------ device pool

def test_device_pool_admission_fairness_and_release(tmp_path):
    def scenario(P, d, out):
        pool = P.scheduler.DevicePool(4)
        out += [pool.admit("a", 3), pool.free, pool.admit("b", 2),
                pool.admit("c", 1), pool.release("a"), pool.free,
                pool.allocation("b")]
        pool = P.scheduler.DevicePool(8)
        pool.admit("a", 4)
        pool.admit("b", 4)
        out += [pool.request("b", 2), pool.request("a", 8),
                pool.request("b", 4), pool.release("b"),
                pool.request("a", 8), pool.request("a", 0)]
        for bad in (lambda: pool.request("ghost", 1),
                    lambda: P.scheduler.DevicePool(0)):
            try:
                bad()
                out.append("no error")
            except (KeyError, ValueError) as e:
                out.append(type(e).__name__)
    out = _both(tmp_path, scenario)
    assert out[:7] == [3, 1, 1, 0, 3, 3, 1]
    assert out[7:13] == [2, 4, 4, 4, 8, 0]
    assert out[13:] == ["KeyError", "ValueError"]


# ------------------------------------------- resize engine (no real pod)

class _LiveProc:
    """Fake Popen handle: alive until terminated/killed."""

    def __init__(self, rc=None):
        self._rc = rc

    def poll(self):
        return self._rc

    def terminate(self):
        self._rc = 0 if self._rc is None else self._rc

    def kill(self):
        self._rc = -9 if self._rc is None else self._rc

    def wait(self, timeout=None):
        return self._rc


def _seal(P, ckpt_dir, step):
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, P.launch._MANIFEST), "w") as fh:
        fh.write("{}")


def _beat(path, step):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"step": step, "ts": time.time(), "process_index": 0}, fh)


def _elastic(P, d, *, policy=None, **kw):
    return P.service.ElasticSupervisor(
        P.cfg(output_dir=str(d), run_id="pod"), P.launch.LaunchConfig(**kw),
        str(d / "pod"), policy=policy, job="pod")


def _stream(d):
    """The supervisor stream, with what differs between two runs (times,
    the bus stamps, directories) taken out."""
    out = []
    with open(d / "pod" / "supervisor.jsonl") as fh:
        for rec in map(json.loads, fh):
            rec = {k: v for k, v in rec.items()
                   if k not in ("ts", "seq", "schema_version")}
            if "duration_s" in rec:
                rec["duration_s"] = "t"
            if rec.get("checkpoint"):
                rec["checkpoint"] = os.path.basename(rec["checkpoint"])
            out.append(rec)
    return out


def _strict(d):
    return telemetry_cli(["validate", str(d / "pod" / "supervisor.jsonl"),
                          "--strict"])


def _supervisor_case(name):
    """One path of the reference's supervisor tests, as a scenario: it
    drives the supervisor and appends what it returned and its state."""

    def refuse_bounds(P, d, out):
        sup = _elastic(P, d, nprocs=2, policy=P.service.ResizePolicy(
            min_nprocs=1, max_nprocs=4))
        spec = sup._worker_spec(resume=None)
        out += [sup._direct(9, "operator", spec), sup.target_nprocs,
                sup._resize_pending(), sup.resizes]
        return sup

    def same_width(P, d, out):
        sup = _elastic(P, d, nprocs=2)
        out += [sup._direct(2, "operator", sup._worker_spec(resume=None)),
                sup.resizes]
        return sup

    def budget(P, d, out):
        sup = _elastic(P, d, nprocs=2,
                       policy=P.service.ResizePolicy(max_resizes=0))
        out.append(sup._direct(3, "operator",
                               sup._worker_spec(resume=None)))
        return sup

    def accept(P, d, out):
        sup = _elastic(P, d, nprocs=2, policy=P.service.ResizePolicy(
            step_budget=50, wall_budget_s=60.0))
        spec = sup._worker_spec(resume=None)
        _beat(spec["heartbeats"][0], 7)
        out += [sup._direct(4, "operator", spec), sup._resize_pending(),
                sup.resizes, sup.target_nprocs]
        return sup

    def commit_in_budget(P, d, out):
        sup = _elastic(P, d, nprocs=2,
                       policy=P.service.ResizePolicy(step_budget=5))
        _seal(P, sup.ckpt_dir, 4)
        sup._direct(3, "operator", sup._worker_spec(resume=None))
        out += [sup._apply_resize(sup._take_resize(), progress_step=6),
                sup.target_nprocs, sup._inflight["committed"],
                sup._inflight["steps_lost"]]
        return sup

    def abort_over_budget(P, d, out):
        sup = _elastic(P, d, nprocs=2,
                       policy=P.service.ResizePolicy(step_budget=5))
        _seal(P, sup.ckpt_dir, 4)
        sup._direct(3, "operator", sup._worker_spec(resume=None))
        out += [sup._apply_resize(sup._take_resize(), progress_step=100),
                sup.target_nprocs, sup._inflight]
        return sup

    def arm_commit(P, d, out):
        sup = _elastic(P, d, nprocs=2)
        _seal(P, sup.ckpt_dir, 4)
        sup._direct(3, "operator", sup._worker_spec(resume=None))
        out.append(sup._apply_resize(sup._take_resize(), 4))
        new_spec = sup._worker_spec(resume=sup.ckpt_dir)
        out.append(len(new_spec["heartbeats"]))
        for path in new_spec["heartbeats"]:
            _beat(path, 4)
        sup._post_spawn([_LiveProc() for _ in range(3)], new_spec)
        out += [sup.resizes_committed, sup._inflight]
        return sup

    def wall_budget_revert(P, d, out):
        sup = _elastic(P, d, nprocs=2,
                       policy=P.service.ResizePolicy(wall_budget_s=0.0))
        sup.launch.poll_s = 0.01
        _seal(P, sup.ckpt_dir, 4)
        sup._direct(4, "operator", sup._worker_spec(resume=None))
        out.append(sup._apply_resize(sup._take_resize(), 4))
        new_spec = sup._worker_spec(resume=sup.ckpt_dir)
        sup._post_spawn([_LiveProc() for _ in range(4)], new_spec)
        out += [sup._inflight, sup._take_resize()]
        return sup

    def arm_failed(P, d, out):
        sup = _elastic(P, d, nprocs=2)
        _seal(P, sup.ckpt_dir, 4)
        sup._direct(4, "operator", sup._worker_spec(resume=None))
        out.append(sup._apply_resize(sup._take_resize(), 4))
        new_spec = sup._worker_spec(resume=sup.ckpt_dir)
        sup._post_spawn([_LiveProc(), _LiveProc(-9), _LiveProc(),
                         _LiveProc()], new_spec)
        out.append(sup._resize_pending())
        return sup

    def control(P, d, out):
        sup = _elastic(P, d, nprocs=2)
        spec = sup._worker_spec(resume=None)
        P.service.ControlPlane.write(sup.control.path,
                                     {"cmd": "resize", "nprocs": 3})
        sup._poll_tick([_LiveProc(), _LiveProc()], spec)
        out += [sup._resize_pending(), sup._take_resize()]
        P.service.ControlPlane.write(sup.control.path, {"cmd": "nope"},
                                     {"cmd": "stop"})
        sup._poll_tick([_LiveProc(), _LiveProc()], spec)
        out.append(sup._shutdown.is_set())
        return sup

    def drain(P, d, out):
        sup = _elastic(P, d, nprocs=2, policy=P.service.ResizePolicy(
            drain_grace_s=0.0))
        spec = sup._worker_spec(resume=None)
        procs = [_LiveProc(0), _LiveProc()]
        sup._poll_tick(procs, spec)
        out.append(sup._resize_pending())
        sup._poll_tick(procs, spec)
        out.append(sup._take_resize())
        return sup

    def loss_pressure(P, d, out):
        sup = _elastic(P, d, nprocs=3, max_relaunches=1)
        spec = sup._worker_spec(resume=None)
        sup._on_worker_lost([{"worker": 1, "reason": "exit",
                              "exit_code": -9}], spec)
        out += [sup._take_resize(), sup.resizes]
        return sup

    def adopted(P, d, out):
        """A directive enqueued through the base ``request_resize`` (the
        scheduler's grant) is adopted with its own bracket; out of bounds
        it is refused after teardown."""
        sup = _elastic(P, d, nprocs=2, policy=P.service.ResizePolicy(
            max_nprocs=3))
        _seal(P, sup.ckpt_dir, 2)
        sup.request_resize(3, "operator")
        out += [sup._apply_resize(sup._take_resize(), 3), sup.resizes,
                sup.target_nprocs]
        spec = sup._worker_spec(resume=sup.ckpt_dir)
        for path in spec["heartbeats"]:
            _beat(path, 3)
        sup._post_spawn([_LiveProc() for _ in range(3)], spec)
        sup.request_resize(5, "operator")
        out += [sup._apply_resize(sup._take_resize(), 3), sup.target_nprocs]
        return sup

    return {"refuse_bounds": refuse_bounds, "same_width": same_width,
            "budget": budget, "accept": accept,
            "commit_in_budget": commit_in_budget,
            "abort_over_budget": abort_over_budget, "arm_commit": arm_commit,
            "wall_budget_revert": wall_budget_revert,
            "arm_failed": arm_failed, "control": control, "drain": drain,
            "loss_pressure": loss_pressure, "adopted": adopted}[name]


CASES = ["refuse_bounds", "same_width", "budget", "accept",
         "commit_in_budget", "abort_over_budget", "arm_commit",
         "wall_budget_revert", "arm_failed", "control", "drain",
         "loss_pressure", "adopted"]

WANT = {
    "refuse_bounds": ([False, 2, False, 0], ["resize_abort"]),
    "same_width": ([False, 0], []),
    "budget": ([False], ["resize_abort"]),
    "accept": ([True, True, 1, 2], ["resize_begin"]),
    "commit_in_budget": ([True, 3, True, 2], ["resize_begin"]),
    "abort_over_budget": ([False, 2, None], ["resize_begin",
                                             "resize_abort"]),
    "arm_commit": ([True, 3, 1, None], ["resize_begin", "resize_commit"]),
    "wall_budget_revert": ([True, None, [2, "revert"]],
                           ["resize_begin", "resize_abort"]),
    "arm_failed": ([True, False], ["resize_begin", "resize_abort"]),
    "control": ([True, [3, "operator"], True], ["resize_begin"]),
    "drain": ([False, [1, "preemption"]], ["resize_begin"]),
    "loss_pressure": ([[2, "relaunch_pressure"], 1], ["resize_begin"]),
    "adopted": ([True, 1, 3, False, 3], ["resize_begin", "resize_commit",
                                         "resize_abort"]),
}


@pytest.mark.parametrize("case", CASES)
def test_supervisor_path_matches_the_reference(tmp_path, case):
    fn = _supervisor_case(case)

    def scenario(P, d, out):
        sup = fn(P, d, out)
        sup.bus.close()
        out[:] = [list(v) if isinstance(v, tuple) else v for v in out]
        out.append(_stream(d))
        out.append(_strict(d))
    out = _both(tmp_path, scenario)
    stream, strict = out[-2], out[-1]
    want_out, want_events = WANT[case]
    assert out[:-2] == want_out
    assert [r["event"] for r in stream
            if r["event"] != "health_status"] == want_events
    assert strict == 0
    assert all(r["process_index"] == -1 and r.get("job", "pod") == "pod"
               for r in stream)


def test_elastic_reconcile_full_loop_over_fake_pod(tmp_path):
    """The real ``run`` loop with fake processes: a scripted grow at step 0
    executes begin -> teardown -> re-spec at 3 -> arm -> commit, then the
    generation completes and ``run`` returns 0."""
    def scenario(P, d, out):
        sup = _elastic(P, d, nprocs=2, max_relaunches=2, poll_s=0.01)
        sup._schedule = [(0, 3)]
        _seal(P, sup.ckpt_dir, 4)
        spawned = []

        def fake_spawn(spec):
            n = int(spec["nprocs"])
            spawned.append(n)
            for path in spec["heartbeats"]:
                _beat(path, 4)
            return [_LiveProc(None if len(spawned) == 1 else 0)
                    for _ in range(n)]

        sup._spawn = fake_spawn
        out += [sup.run(), spawned, sup.resizes, sup.resizes_committed,
                sup.target_nprocs, _stream(d), _strict(d)]
    out = _both(tmp_path, scenario)
    assert out[:5] == [0, [2, 3], 1, 1, 3]
    events = [r["event"] for r in out[5]]
    assert events.index("resize_begin") < events.index(
        "worker_relaunch") < events.index("resize_commit")
    assert out[6] == 0


def test_nccl_over_wide_directive_is_refused_before_teardown(tmp_path,
                                                             monkeypatch):
    """With one card visible, a grow to 2 NCCL ranks is refused with
    ``resize_abort`` (``backend:<reason>``) in ``_direct`` and nothing is
    queued, so the pod is never torn down; an adopted directive to that
    width is refused after teardown and the pod relaunches at the old
    width; the same grow over gloo is accepted."""
    calls = []

    def cards():
        calls.append(1)
        return 1

    monkeypatch.setattr(tlaunch, "_visible_cards", cards)
    cfg = tconfig.TrainConfig(device="cuda", output_dir=str(tmp_path),
                              run_id="pod")
    sup = tservice.ElasticSupervisor(cfg, tlaunch.LaunchConfig(nprocs=1),
                                     str(tmp_path / "pod"), job="pod")
    spec = sup._worker_spec(resume=None)
    assert sup._direct(2, "operator", spec) is False
    assert not sup._resize_pending() and sup.resizes == 0
    sup.request_resize(2, "scheduler")
    assert sup._apply_resize(sup._take_resize(), 0) is False
    assert sup.target_nprocs == 1
    sup.bus.close()
    aborts = [r for r in _stream(tmp_path) if r["event"] == "resize_abort"]
    assert [r["reason"] for r in aborts] == ["backend:operator",
                                             "backend:scheduler"]
    assert (aborts[0]["from_nprocs"], aborts[0]["to_nprocs"]) == (1, 2)
    assert len(calls) == 1                         # counted once
    assert _strict(tmp_path) == 0
    gloo = tservice.ElasticSupervisor(
        cfg, tlaunch.LaunchConfig(nprocs=1, dist_backend="gloo"),
        str(tmp_path / "gloo"), job="gloo")
    assert gloo._direct(2, "operator", gloo._worker_spec(resume=None))
    gloo.bus.close()


def test_relaunched_spec_follows_the_new_width(tmp_path):
    """After a committed resize the next generation's spec, and each
    worker's config from it, are at the new width: ``nworkers`` (and so
    the global batch and the learning rate's worker scaling) follow."""
    sup = _elastic(PKGS["port"], tmp_path, nprocs=2)
    _seal(PKGS["port"], sup.ckpt_dir, 4)
    sup._direct(3, "operator", sup._worker_spec(resume=None))
    assert sup._apply_resize(sup._take_resize(), 4)
    spec = json.loads(json.dumps(sup._worker_spec(resume=sup.ckpt_dir)))
    sup.bus.close()
    assert spec["nprocs"] == 3 and len(spec["heartbeats"]) == 3
    assert spec["dist_backend"] is None and spec["resume"] == sup.ckpt_dir
    cfgs = [tlaunch._spec_to_config(spec, i) for i in range(3)]
    assert {c.nworkers for c in cfgs} == {3}
    assert cfgs[0].global_batch_size == 3 * cfgs[0].batch_size
    assert [c.run_id for c in cfgs] == ["proc000", "proc001", "proc002"]


# -------------------------------------------------- events + health wiring

def test_resize_and_job_events_validate_on_a_strict_bus():
    recs = [{"event": "resize_begin", "job": "a", "reason": "operator",
             "from_nprocs": 2, "to_nprocs": 4, "generation": 1,
             "step": 10, "step_budget": 50, "wall_budget_s": 600.0},
            {"event": "resize_commit", "job": "a", "from_nprocs": 2,
             "to_nprocs": 4, "generation": 1,
             "checkpoint": "ckpt/step_00000008", "duration_s": 3.5,
             "steps_lost": 2, "reason": "operator"},
            {"event": "resize_abort", "job": "a", "reason": "wall_budget",
             "from_nprocs": 2, "to_nprocs": 4, "generation": 2,
             "duration_s": 600.1},
            {"event": "job_admit", "job": "a", "nprocs": 2,
             "devices_free": 6},
            {"event": "job_done", "job": "a", "outcome": "ok",
             "exit_code": 0, "generations": 3, "resizes": 2},
            {"event": "policy_decision", "step": 4, "rule": "r",
             "knob": "density", "old": "0.001", "new": "0.002",
             "reason": "x", "recompiles": 1, "budget_left": 7},
            {"event": "policy_revert", "step": 6, "rule": "r",
             "knob": "density", "old": "0.002", "new": "0.001",
             "reason": "x", "recompiles": 2, "budget_left": 6,
             "quarantined": True}]
    mem = ttelemetry.MemoryExporter()
    bus = ttelemetry.EventBus([mem], validate=True)
    for rec in recs:
        bus.publish(rec)
    bus.close()
    assert [r["event"] for r in mem.records] == [r["event"] for r in recs]
    bus = ttelemetry.EventBus([], validate=True)
    with pytest.raises(ValueError):
        bus.publish({"event": "resize_commit", "job": "a"})


def test_health_attributes_resize_incidents():
    """Begin degrades, an abort is critical, replay ticks on resize
    records: the port's verdicts are the reference's."""
    def verdicts(H, telemetry):
        mon = H.HealthMonitor()
        mon.emit({"event": "resize_begin", "job": "a", "reason": "operator",
                  "from_nprocs": 2, "to_nprocs": 4, "generation": 1})
        v1 = mon.tick(2)
        mon.emit({"event": "resize_abort", "job": "a",
                  "reason": "wall_budget", "from_nprocs": 2,
                  "to_nprocs": 4, "generation": 1})
        v2 = mon.tick(4)
        replayed, rmon = telemetry.replay_health(
            [{"event": "resize_begin", "job": "a", "reason": "preemption",
              "from_nprocs": 4, "to_nprocs": 3, "generation": 2}])
        return [v1, v2, replayed, rmon.summary()]
    port = verdicts(thealth, ttelemetry)
    assert port == verdicts(jhealth, jtelemetry)
    v1, v2 = port[0], port[1]
    assert v1["state"] == "degraded" and thealth.CAUSE_RESIZE in v1["causes"]
    assert v2["state"] == "critical"
    assert v2["evidence"][thealth.CAUSE_RESIZE]["resize_aborts"] == 1
    assert port[3]["worst_state"] == "degraded"


# --------------------------------------------------------------- scheduler

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def _sched_stream(root):
    with open(os.path.join(root, "scheduler.jsonl")) as fh:
        return [{k: v for k, v in r.items()
                 if k not in ("ts", "seq", "schema_version")}
                for r in map(json.loads, fh)]


def test_scheduler_admits_runs_and_releases(tmp_path, monkeypatch):
    def scenario(P, d, out):
        monkeypatch.setattr(P.scheduler.ElasticSupervisor, "run",
                            lambda self: 0)
        sched = P.scheduler.JobScheduler(4, str(d / "pool"), health_port=0)
        jobs = [sched.submit(name, P.cfg(output_dir=str(d), run_id=name),
                             P.launch.LaunchConfig(nprocs=2))
                for name in ("a", "b")]
        out.append(sched.wait(timeout=30))
        out += [(j.exit_code, j.outcome) for j in jobs]
        out.append(sched.pool.free)
        out.append(_get(f"http://127.0.0.1:{sched.server.port}"
                        f"/healthz/a")[0])
        try:
            sched.submit("big", P.cfg(output_dir=str(d), run_id="big"),
                         P.launch.LaunchConfig(nprocs=8),
                         policy=P.service.ResizePolicy(min_nprocs=5))
        except RuntimeError as e:
            out.append("not admitted" in str(e))
        try:
            sched.submit("a", P.cfg(output_dir=str(d), run_id="a"),
                         P.launch.LaunchConfig(nprocs=1))
        except ValueError:
            out.append("duplicate")
        sched.close()
        out.append(sorted(_sched_stream(str(d / "pool")),
                          key=lambda r: (r["event"], r["job"])))
    out = _both(tmp_path, scenario)
    assert out[:6] == [True, (0, "ok"), (0, "ok"), 4, 200, True]
    assert out[6] == "duplicate"
    admits = [r for r in out[7] if r["event"] == "job_admit"]
    assert [(r["job"], r["nprocs"]) for r in admits] == [("a", 2),
                                                         ("b", 2)]
    assert telemetry_cli(["validate", str(tmp_path / "port" / "pool" /
                                          "scheduler.jsonl"),
                          "--strict"]) == 0


def test_scheduler_resize_routes_through_pool_fairness(tmp_path,
                                                       monkeypatch):
    def scenario(P, d, out):
        monkeypatch.setattr(
            P.scheduler.ElasticSupervisor, "run",
            lambda self: 143 if self._shutdown.wait(30) else 1)
        sched = P.scheduler.JobScheduler(8, str(d / "pool"))
        for name in ("a", "b"):
            sched.submit(name, P.cfg(output_dir=str(d), run_id=name),
                         P.launch.LaunchConfig(nprocs=4))
        try:
            out += [sched.resize("b", 2), sched.resize("a", 8),
                    sched.job("a").supervisor._resize_pending(),
                    sched.job("b").supervisor._take_resize(),
                    sched.jobs()]
            try:
                sched.resize("ghost", 2)
            except KeyError:
                out.append("KeyError")
        finally:
            sched.close()
        out += [sched.job("a").exit_code, sched.job("a").outcome]
    out = _both(tmp_path, scenario)
    assert out == [2, 4, False, (2, "operator"), ["a", "b"], "KeyError",
                   143, "shutdown"]


# ------------------------------------------------- a real service run

def test_service_grows_and_shrinks_a_real_pod(tmp_path):
    """``python -m gaussiank_sgd_torch.service``: two gloo ranks of a
    narrow VGG on the CPU, worker 1 SIGKILLed in generation 0 (a
    same-width relaunch), then 2 -> 3 at step 4 and 3 -> 2 at step 8:
    exit 0, both commits inside the step budget of 10, the supervisor
    stream strict and every stream mergeable, health non-ok."""
    cmd = [sys.executable, "-m", "gaussiank_sgd_torch.service",
           "--nprocs", "2", "--grace", "5", "--max-relaunches", "3",
           "--max-nprocs", "8", "--resize-step-budget", "10",
           "--resize-at", "4:3", "--resize-at", "8:2",
           "--kill-step", "3", "--kill-proc", "1",
           "--device", "cpu", "--compressor", "gaussian_fused",
           "--density", "0.01", "--max-steps", "12",
           "--compress-warmup-steps", "2", "--save-every-steps", "2",
           "--save-every-epochs", "0", "--eval-every-epochs", "0",
           "--batch-size", "8", "--compute-dtype", "float32",
           "--log-every", "2", "--model-kwargs", json.dumps({"cfg": NARROW}),
           "--output-dir", str(tmp_path), "--run-id", "pod"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    pod = tmp_path / "pod"
    with open(pod / "supervisor.jsonl") as fh:
        recs = [json.loads(line) for line in fh]
    lost = [r for r in recs if r["event"] == "worker_lost"]
    assert [(r["worker"], r["exit_code"]) for r in lost] == [(1, -9)]
    rel = [r["nprocs"] for r in recs if r["event"] == "worker_relaunch"]
    assert rel == [2, 3, 2]
    commits = [r for r in recs if r["event"] == "resize_commit"]
    assert [(r["from_nprocs"], r["to_nprocs"]) for r in commits] == [
        (2, 3), (3, 2)]
    assert all(r["steps_lost"] <= 10 for r in commits)
    assert telemetry_cli(["validate", str(pod / "supervisor.jsonl"),
                          "--strict"]) == 0
    streams = [str(pod / f"proc{i:03d}" / "metrics.jsonl") for i in range(3)]
    assert telemetry_cli(["merge", *streams, str(pod / "supervisor.jsonl"),
                          "-o", str(pod / "merged.jsonl"), "--strict"]) == 0
    assert telemetry_cli(["health", str(pod / "supervisor.jsonl")]) in (1, 2)
    # the last generation sealed the run's end
    with open(pod / "ckpt" / "step_00000012" / "commit_manifest.json") as fh:
        assert json.load(fh)["world"] == 2
