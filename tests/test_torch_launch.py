"""The port's pod rig (``gaussiank_sgd_torch/training/launch.py`` and
``chaos.py``'s process-death and coordinator injectors) against the
reference's ``gaussiank_sgd_tpu/training/launch.py``.

* Bootstrap: the jitter, the backoff schedule, the attempt count and the
  ``bootstrap_retry`` records equal the reference's on the same
  ``FlakyCoordinator`` refusals; exhaustion names the coordinator and every
  attempt, in order; the record validates strictly under both packages'
  rules; the default ``initialize`` forms a real gloo group of one.
* The launcher's parts: heartbeats beat on progress records,
  ``read_heartbeat`` tolerates garbage, ``has_sealed_checkpoint`` finds the
  newest sealed checkpoint the port's own ``save_checkpoint`` wrote (the
  manifest name is the port's ``checkpoint.MANIFEST``), ``_lost_workers``
  (exit code and staleness), ``_worker_spec`` and ``_spec_to_config`` as
  the reference's tests pin them, the supervisor's incident records
  validate strictly, and NCCL with more ranks than cards is refused with
  a message naming ``--dist-backend gloo``.
* The supervisor's loop in this process against stub workers: a SIGKILLed
  worker is lost with exit code -9, the pod relaunches from the sealed
  checkpoint and exits 0; a pod that keeps dying spends its budget and
  raises; ``stop`` tears every child down and returns 143.
* A real pod on the CPU: ``python -m gaussiank_sgd_torch.training.launch``
  with 2 gloo processes of a narrow VGG and a SIGKILL at one step: the
  supervisor relaunches from the sealed checkpoint, the pod exits 0, the
  merged stream validates strictly, ``telemetry health`` exits 2, and the
  final state equals the unkilled pod's bit for bit.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from gaussiank_sgd_tpu.telemetry import events as jevents
from gaussiank_sgd_tpu.training import chaos as jchaos
from gaussiank_sgd_tpu.training import launch as jlaunch
from gaussiank_sgd_torch.telemetry import EventBus, MemoryExporter
from gaussiank_sgd_torch.telemetry.__main__ import main as telemetry_cli
from gaussiank_sgd_torch.telemetry.events import validate_stream
from gaussiank_sgd_torch.training import chaos, checkpoint, launch
from gaussiank_sgd_torch.training.config import TrainConfig
from gaussiank_sgd_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]


# ------------------------------------------------------------- bootstrap

def _bootstrap(mod, chaos_mod, refusals, **kw):
    fc = chaos_mod.FlakyCoordinator(refusals)
    sleeps, events = [], []
    try:
        attempts = mod.bootstrap_distributed(
            "10.0.0.1:1234", 4, 3, timeout_s=1.0, initialize=fc,
            on_retry=events.append, sleep=sleeps.append, **kw)
    except RuntimeError as e:
        attempts = str(e)
    for e in events:
        e.pop("ts")
    return attempts, sleeps, events, fc.calls


@pytest.mark.parametrize("refusals,kw", [
    (0, {}),
    (2, dict(max_retries=3)),
    (6, dict(max_retries=6, backoff_s=0.5, backoff_cap_s=2.0, jitter=0.0)),
    (5, dict(max_retries=6, backoff_s=0.25, backoff_cap_s=3.0, jitter=0.5)),
    (-1, dict(max_retries=2)),
    (-1, dict(max_retries=3))])
def test_bootstrap_is_the_references(refusals, kw):
    """The attempts, the slept backoffs (deterministic jitter and cap), the
    ``bootstrap_retry`` records and the exhaustion message equal the
    reference's, but for the process group's name."""
    got = _bootstrap(launch, chaos, refusals, **kw)
    want = _bootstrap(jlaunch, jchaos, refusals, **kw)
    if isinstance(want[0], str):
        assert got[0] == want[0].replace("jax.distributed",
                                         "torch.distributed")
    assert got[1:] == want[1:]
    assert isinstance(got[0], str) or got[0] == want[0] == refusals + 1


def test_bootstrap_exhaustion_names_the_coordinator_and_every_attempt():
    attempts, sleeps, events, calls = _bootstrap(launch, chaos, -1,
                                                 max_retries=3)
    assert "10.0.0.1:1234" in attempts and "process 3/4" in attempts
    lines = [ln.strip() for ln in attempts.splitlines()
             if ln.strip().startswith("attempt ")]
    assert [int(ln.split()[1].rstrip(":")) for ln in lines] == [1, 2, 3, 4]
    assert all("ConnectionRefusedError" in ln for ln in lines)
    assert calls == 4 and len(sleeps) == len(events) == 3


def test_bootstrap_retry_record_validates_under_both_packages():
    _, sleeps, events, _ = _bootstrap(launch, chaos, 2, max_retries=3)
    mem = MemoryExporter()
    bus = EventBus([mem], validate=True)
    for rec in events:
        bus.publish(rec)
    bus.close()
    assert [r["attempt"] for r in mem.records] == [1, 2]
    assert [r["backoff_s"] for r in mem.records] == [round(s, 6)
                                                     for s in sleeps]
    for rec in mem.records:
        assert jevents.validate_record(rec, strict=True) == []


def test_deterministic_jitter_is_the_references():
    vals = [launch._deterministic_jitter(p, a)
            for p in range(8) for a in range(1, 5)]
    assert vals == [jlaunch._deterministic_jitter(p, a)
                    for p in range(8) for a in range(1, 5)]
    assert len(set(vals)) == 32 and all(0.0 <= v < 1.0 for v in vals)


def test_default_initialize_forms_a_gloo_group(tmp_path):
    """The real ``init_process_group`` over ``tcp://``, a world of one, in
    a child process (a group is per process)."""
    code = (
        "import sys, torch.distributed as dist\n"
        "from gaussiank_sgd_torch.training import launch\n"
        "n = launch.bootstrap_distributed("
        "f'127.0.0.1:{launch.free_port()}', 1, 0, timeout_s=30)\n"
        "assert n == 1 and dist.get_world_size() == 1\n"
        "assert dist.get_backend() == 'gloo'\n"
        "dist.destroy_process_group()\n"
        "print('OK')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-2000:]


# ------------------------------------------------------------ heartbeats

def test_heartbeat_beats_on_progress_records(tmp_path):
    path = str(tmp_path / "hb" / "proc001.json")
    clock = iter(range(100, 200))
    hb = launch.HeartbeatExporter(path, 1, clock=lambda: float(next(clock)))
    bus = EventBus([hb])
    assert launch.read_heartbeat(path) is None
    hb.beat(0)
    assert launch.read_heartbeat(path) == {"step": 0, "ts": 100.0,
                                           "process_index": 1}
    bus.emit("train", step=4)
    bus.emit("skip", step=5, nonfinite=1.0)        # not a progress record
    assert launch.read_heartbeat(path)["step"] == 4
    bus.emit("checkpoint", step=6, path="c")
    bus.emit("eval", step=6, epoch=0)
    bus.close()
    beat = launch.read_heartbeat(path)
    assert beat == {"step": 6, "ts": 103.0, "process_index": 1}
    assert not os.path.exists(path + ".tmp")


def test_read_heartbeat_tolerates_garbage(tmp_path):
    assert launch.read_heartbeat(str(tmp_path / "nope.json")) is None
    bad = tmp_path / "bad.json"
    for text in ('{"step": 3, "ts"', "[1, 2]", ""):
        bad.write_text(text)
        assert launch.read_heartbeat(str(bad)) is None


# ------------------------------------------------- sealed-checkpoint scan

def _narrow_cfg(tmp_path, **kw):
    base = dict(dnn="vgg16", dataset="cifar10", batch_size=8, nworkers=1,
                lr=0.01, max_steps=8, compressor="gaussian_fused",
                density=0.01, compress_warmup_steps=2, warmup_epochs=0.0,
                compute_dtype="float32", log_every=2, eval_every_epochs=0,
                save_every_epochs=0, seed=0, device="cpu",
                model_kwargs={"cfg": NARROW, "dropout": 0.0},
                output_dir=str(tmp_path))
    base.update(kw)
    return TrainConfig(**base)


def test_has_sealed_checkpoint_on_the_ports_checkpoints(tmp_path):
    assert launch._MANIFEST == checkpoint.MANIFEST == jlaunch._MANIFEST
    t = Trainer(_narrow_cfg(tmp_path))
    try:
        assert launch.has_sealed_checkpoint(t.ckpt_dir) is None
        paths = []
        for _ in range(3):
            t.train(2)
            paths.append(t.save_checkpoint())
    finally:
        t.close()
    assert launch.has_sealed_checkpoint(t.ckpt_dir) == paths[-1]
    chaos.corrupt_checkpoint(paths[-1], "unseal")   # a save that died
    assert launch.has_sealed_checkpoint(t.ckpt_dir) == paths[1]
    assert jlaunch.has_sealed_checkpoint(t.ckpt_dir) == paths[1]
    assert os.path.basename(paths[1]) == "step_00000004"


# --------------------------------------------------- supervisor (no pod)

class _FakeProc:
    def __init__(self, rc):
        self._rc = rc

    def poll(self):
        return self._rc


def _supervisor(tmp_path, mod=launch, device="cpu", **kw):
    cfg_cls = TrainConfig if mod is launch else __import__(
        "gaussiank_sgd_tpu.training.config",
        fromlist=["TrainConfig"]).TrainConfig
    cfg = cfg_cls(output_dir=str(tmp_path), run_id="pod",
                  **({"device": device} if mod is launch else {}))
    return mod.Supervisor(cfg, mod.LaunchConfig(**kw),
                          str(tmp_path / "pod"))


@pytest.mark.parametrize("mod", [launch, jlaunch],
                         ids=["port", "reference"])
def test_lost_workers_exit_code_and_heartbeat_staleness(tmp_path, mod):
    sup = _supervisor(tmp_path, mod, nprocs=3, heartbeat_timeout_s=10.0)
    try:
        hb_dir = tmp_path / "pod" / "heartbeats"
        hb_dir.mkdir(parents=True)
        spec = {"heartbeats": [str(hb_dir / f"proc{i:03d}.json")
                               for i in range(3)]}
        (hb_dir / "proc002.json").write_text(
            json.dumps({"step": 5, "ts": 50.0, "process_index": 2}))
        procs = [_FakeProc(0), _FakeProc(-9), _FakeProc(None)]
        lost = sup._lost_workers(procs, spec, now=100.0)
        assert lost == [{"worker": 1, "reason": "exit", "exit_code": -9},
                        {"worker": 2, "reason": "heartbeat_timeout",
                         "heartbeat_age_s": 50.0, "heartbeat_step": 5}]
        # a live worker with no heartbeat yet (still bootstrapping) is not
        # lost: the staleness clock arms on its first beat
        os.remove(hb_dir / "proc002.json")
        assert sup._lost_workers(procs, spec, now=1e9) \
            == [{"worker": 1, "reason": "exit", "exit_code": -9}]
    finally:
        sup.bus.close()


def test_worker_spec_fresh_coordinator_and_resume(tmp_path):
    sup = _supervisor(tmp_path, nprocs=2, dist_backend="gloo")
    jsup = _supervisor(tmp_path / "ref", jlaunch, nprocs=2)
    try:
        s1 = sup._worker_spec(resume=None)
        s2 = sup._worker_spec(resume=str(tmp_path / "pod" / "ckpt"))
        j1 = jsup._worker_spec(resume=None)
    finally:
        sup.bus.close()
        jsup.bus.close()
    assert s1["coordinator"].startswith("127.0.0.1:")
    assert s1["coordinator"] != s2["coordinator"]   # a fresh port a gen
    assert s1["resume"] is None
    assert s2["resume"] == str(tmp_path / "pod" / "ckpt")
    assert len(s1["heartbeats"]) == 2 and s1["config"]["run_id"] == "pod"
    assert (s1["generation"], s1["dist_backend"]) == (0, "gloo")
    # the reference's keys, plus the generation and the backend
    assert set(s1) == set(j1) | {"generation", "dist_backend"}
    # the spec survives the JSON round trip through the environment
    rt = json.loads(json.dumps(s2))
    assert rt["config"]["lr_milestones"] == list(
        s2["config"]["lr_milestones"])
    rt["config"] = s2["config"] = None
    assert rt == s2


def test_spec_to_config_per_process_layout(tmp_path):
    sup = _supervisor(tmp_path, nprocs=4)
    try:
        spec = json.loads(json.dumps(sup._worker_spec(
            resume=str(sup.ckpt_dir))))
    finally:
        sup.bus.close()
    cfg1 = launch._spec_to_config(spec, 1)
    assert cfg1.output_dir == str(tmp_path / "pod")
    assert cfg1.run_id == "proc001" and cfg1.nworkers == 4
    assert cfg1.resume == str(tmp_path / "pod" / "ckpt")
    assert cfg1.keep_checkpoints == 0          # retention on process 0 only
    cfg0 = launch._spec_to_config(spec, 0)
    assert cfg0.keep_checkpoints == TrainConfig().keep_checkpoints
    assert isinstance(cfg0.lr_milestones, tuple)
    assert cfg0.device == "cpu"
    assert launch.worker_device(cfg0.device, 3) == "cpu"


def test_supervisor_incident_records_validate_strictly(tmp_path):
    sup = _supervisor(tmp_path, nprocs=2)
    sup.bus.publish({"event": "worker_lost", "generation": 0, "worker": 1,
                     "reason": "exit", "exit_code": -9})
    sup.bus.publish({"event": "worker_relaunch", "generation": 1,
                     "nprocs": 2, "checkpoint": ""})
    sup.bus.close()
    path = tmp_path / "pod" / "supervisor.jsonl"
    lines = path.read_text().splitlines()
    recs = [json.loads(line) for line in lines]
    assert [r["event"] for r in recs] == ["worker_lost", "worker_relaunch"]
    assert all(r["process_index"] == -1 for r in recs)
    for validate in (validate_stream, jevents.validate_stream):
        assert validate(lines, strict=True).ok
    assert telemetry_cli(["validate", str(path), "--strict"]) == 0


def test_nccl_with_more_ranks_than_cards_is_refused(tmp_path, monkeypatch):
    """Refused with a message naming ``--dist-backend gloo``; never
    switched to gloo. Gloo shares the cards; NCCL on the CPU is refused."""
    monkeypatch.setattr(launch, "_visible_cards", lambda: 1)
    for kw, refused in ((dict(nprocs=2), True),
                        (dict(nprocs=2, dist_backend="nccl"), True),
                        (dict(nprocs=1), False),
                        (dict(nprocs=4, dist_backend="gloo"), False)):
        sup = _supervisor(tmp_path, device="cuda", **kw)
        try:
            if refused:
                with pytest.raises(ValueError,
                                   match="--dist-backend gloo") as e:
                    sup.run()
                assert "1 is visible" in str(e.value)
            else:
                sup._check_backend()
        finally:
            sup.bus.close()
    sup = _supervisor(tmp_path, nprocs=1, dist_backend="nccl")
    try:
        with pytest.raises(ValueError, match="0 are visible"):
            sup._check_backend()
    finally:
        sup.bus.close()
    assert not (tmp_path / "pod" / "gen00_proc000.log").exists()


def test_worker_device_needs_a_card_unless_asked_for_the_cpu():
    assert not torch.cuda.is_available()
    assert launch.worker_device("cpu", 5) == "cpu"
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch.worker_device("cuda", 0)


# ------------------------------------- the supervisor's loop, stub workers

_STUB = r"""
import json, os, signal, sys, time
spec = json.loads(os.environ["GKSGD_LAUNCH_SPEC"])
i, mode = int(sys.argv[1]), sys.argv[2]
ckpt = os.path.join(spec["ckpt_dir"], "step_00000004")
beat = spec["heartbeats"][i]
os.makedirs(os.path.dirname(beat), exist_ok=True)
with open(beat, "w") as f:
    json.dump({"step": 4, "ts": time.time(), "process_index": i}, f)
if spec["generation"] == 0 and i == 0:
    os.makedirs(ckpt, exist_ok=True)
    open(os.path.join(ckpt, "commit_manifest.json"), "w").write("{}")
if os.environ.get("GKSGD_CHAOS_KILL_PROC") == str(i) or mode == "die":
    while not os.path.exists(os.path.join(ckpt, "commit_manifest.json")):
        time.sleep(0.01)
    os.kill(os.getpid(), signal.SIGKILL)
if mode == "hang":
    time.sleep(120)
print("stub", i, "generation", spec["generation"], "ok")
"""


class _StubSupervisor(launch.Supervisor):
    mode = "ok"

    def _worker_command(self, i):
        return [sys.executable, "-c", _STUB, str(i), self.mode]


def _stub_pod(tmp_path, mode, **kw):
    cfg = TrainConfig(output_dir=str(tmp_path), run_id="pod", device="cpu")
    sup = _StubSupervisor(cfg, launch.LaunchConfig(
        nprocs=2, poll_s=0.02, grace_s=1.0, **kw), str(tmp_path / "pod"))
    sup.mode = mode
    return sup


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_supervisor_relaunches_a_killed_worker(tmp_path):
    sup = _stub_pod(tmp_path, "ok", kill_step=7, kill_proc=1)
    assert sup.run() == 0
    assert (sup.generation, sup.relaunches) == (1, 1)
    recs = _records(tmp_path / "pod" / "supervisor.jsonl")
    lost = [r for r in recs if r["event"] == "worker_lost"]
    assert {"worker": 1, "reason": "exit", "exit_code": -9,
            "generation": 0} in [{k: r[k] for k in
                                  ("worker", "reason", "exit_code",
                                   "generation")} for r in lost]
    rel = [r for r in recs if r["event"] == "worker_relaunch"]
    assert [(r["generation"], r["nprocs"], r["checkpoint"]) for r in rel] \
        == [(1, 2, str(tmp_path / "pod" / "ckpt" / "step_00000004"))]
    assert validate_stream([json.dumps(r) for r in recs], strict=True).ok
    # generation 1 ran without the kill (chaos is generation 0's only)
    for i in range(2):
        log = (tmp_path / "pod" / f"gen01_proc{i:03d}.log").read_text()
        assert f"stub {i} generation 1 ok" in log


def test_supervisor_spends_its_relaunch_budget_then_raises(tmp_path):
    sup = _stub_pod(tmp_path, "die", max_relaunches=1)
    with pytest.raises(RuntimeError, match="relaunch budget exhausted"):
        sup.run()
    recs = _records(tmp_path / "pod" / "supervisor.jsonl")
    assert [r["event"] for r in recs].count("worker_relaunch") == 1
    assert {r["generation"] for r in recs
            if r["event"] == "worker_lost"} == {0, 1}


def test_supervisor_stop_tears_every_worker_down(tmp_path):
    sup = _stub_pod(tmp_path, "hang")
    spawned = []
    real_spawn = sup._spawn

    def spawn(spec):
        procs = real_spawn(spec)
        spawned.extend(procs)
        threading.Timer(1.0, sup.stop).start()
        return procs

    sup._spawn = spawn
    t0 = time.perf_counter()
    assert sup.run() == 143
    assert time.perf_counter() - t0 < 60
    assert len(spawned) == 2 and all(p.poll() is not None for p in spawned)


# ------------------------------------------------------ a real CPU pod

def _pod(out_dir, run_id, *extra):
    cmd = [sys.executable, "-m", "gaussiank_sgd_torch.training.launch",
           "--nprocs", "2", "--grace", "5", "--device", "cpu",
           "--dnn", "vgg16", "--dataset", "cifar10", "--batch-size", "8",
           "--compressor", "gaussian_fused", "--density", "0.01",
           "--compress-warmup-steps", "2", "--max-steps", "10",
           "--save-every-steps", "4", "--save-every-epochs", "0",
           "--eval-every-epochs", "0", "--log-every", "2",
           "--compute-dtype", "float32", "--warmup-epochs", "0",
           "--lr", "0.01", "--seed", "0",
           "--model-kwargs", json.dumps({"cfg": NARROW, "dropout": 0.0}),
           "--output-dir", str(out_dir), "--run-id", run_id, *extra]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    return proc, out_dir / run_id


def _final_state(pod_dir):
    step = pod_dir / "ckpt" / "step_00000010"
    state = torch.load(step / checkpoint.SHARED)
    rows = [torch.load(step / f"rank_{r:05d}.pt") for r in range(2)]
    return state, rows


def test_cpu_pod_kill_and_restore_repeats_the_clean_pod(tmp_path):
    """SIGKILL of worker 1 when it pulls the batch of step 7 (the prefetch
    thread runs up to 3 ahead, so step 4's checkpoint is sealed by then):
    lost with -9, relaunched from step_00000004, exit 0; the merged stream
    validates strictly and health exits 2; the final parameters, momentum
    and each rank's EF row equal the unkilled pod's."""
    killed, pod = _pod(tmp_path, "killed", "--kill-step", "7",
                       "--kill-proc", "1")
    assert killed.returncode == 0, killed.stderr[-4000:]
    recs = _records(pod / "supervisor.jsonl")
    lost = [r for r in recs if r["event"] == "worker_lost"]
    assert any(r["worker"] == 1 and r["exit_code"] == -9 for r in lost)
    rel = [r for r in recs if r["event"] == "worker_relaunch"]
    assert [r["checkpoint"] for r in rel] == [
        str(pod / "ckpt" / "step_00000004")]
    merged = str(pod / "merged.jsonl")
    streams = [str(pod / f"proc{i:03d}" / "metrics.jsonl")
               for i in range(2)] + [str(pod / "supervisor.jsonl")]
    assert telemetry_cli(["merge", *streams, "-o", merged,
                          "--strict"]) == 0
    assert telemetry_cli(["health", merged]) == 2
    with open(merged) as f:
        out = [json.loads(line) for line in f]
    assert {r["process_index"] for r in out} == {-1, 0, 1}
    restores = [r for r in out if r["event"] == "restore"]
    assert sorted((r["process_index"], r["step"]) for r in restores) == [
        (0, 4), (1, 4)]

    clean, clean_pod = _pod(tmp_path, "clean")
    assert clean.returncode == 0, clean.stderr[-4000:]
    assert not _records(clean_pod / "supervisor.jsonl")
    (state, rows), (cstate, crows) = _final_state(pod), _final_state(
        clean_pod)
    assert state["step"] == cstate["step"] == 10
    assert torch.equal(state["params"], cstate["params"])
    for k in cstate["opt_state"]:
        assert torch.equal(state["opt_state"][k], cstate["opt_state"][k])
    for r, cr in zip(rows, crows):
        assert torch.equal(r["ef_residual"], cr["ef_residual"])
    # every process wrote its own whole stream, config first
    for i in range(2):
        with open(clean_pod / f"proc{i:03d}" / "metrics.jsonl") as f:
            lines = f.read().splitlines()
        assert json.loads(lines[0])["event"] == "config"
        assert validate_stream(lines, strict=True).ok
        assert [json.loads(x)["step"] for x in lines
                if '"event": "train"' in x] == [2, 4, 6, 8, 10]
