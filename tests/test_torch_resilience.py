"""The port's resilience runtime (``training/resilience.py``, its wiring in
``training/trainer.py``, ``training/chaos.py``) against the reference's.

* The two ``ResilienceMonitor``s fed the same (step, loss, skipped)
  sequences, with NaN, inf, loss spikes and a spent budget, take the same
  decisions: pending reason, ``pending_since``, ``lr_scale``, counters and
  the raise.
* A narrow VGG run in both packages, on CIFAR-10 files through the native
  pipeline (a batch depends on its place only, so a replay after a
  rollback repeats it), with the same initial weights and NaN batches at
  two sparse steps: the same skips and rollback step, each package's
  restored state bit for bit its own state of that step, the same
  ``lr_scale``, and the trajectory within rtol 1e-5 / atol 1e-6 of the
  reference's before and after (the stated FMA difference).
* The reference's rollback tests re-run on the port: the spike rollback
  skips the checkpoint sealed after the spike, a rollback with no
  checkpoint fails loud, a corrupted newest checkpoint is skipped, and a
  spent budget raises.
* Preemption: a real SIGTERM to a child CPU run seals a checkpoint at a
  step boundary and the child exits 0; the resume ends bit for bit where
  an uninterrupted run ends. At P = 2 over gloo the signal goes to one
  rank only, the ranks agree on the step, and both resume bit for bit.
* ``train(n)`` and ``fit()`` return the reference's keys, with the loss,
  the step and ``preempted_at`` equal (the loss within the FMA
  difference); ``--nworkers 0`` means the world size.
* ``--profile-steps`` traces its window (also entered late, after a
  resume) and ``close`` stops a live trace; ``--no-nonfinite-guard``
  commits a non-finite step, as the reference does.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussiank_sgd_tpu.training import chaos as jchaos
from gaussiank_sgd_tpu.training.config import TrainConfig as JTrainConfig
from gaussiank_sgd_tpu.training.lr_schedule import (
    warmup_milestone_schedule as jschedule)
from gaussiank_sgd_tpu.training.resilience import (
    ResilienceMonitor as JMonitor, ResiliencePolicy as JPolicy)
from gaussiank_sgd_tpu.training.trainer import Trainer as JTrainer
from gaussiank_sgd_torch import convert
from gaussiank_sgd_torch.training import chaos
from gaussiank_sgd_torch.training import checkpoint as ck
from gaussiank_sgd_torch.training.config import (TrainConfig, add_args,
                                                 from_args)
from gaussiank_sgd_torch.training.resilience import (GracefulShutdown,
                                                     ResilienceMonitor,
                                                     ResiliencePolicy,
                                                     TrainingPreempted)
from gaussiank_sgd_torch.training.trainer import Trainer, _ScaledSchedule
from test_torch_distributed import REPO, _spawn
from test_torch_native_io import both_native_libraries, write_cifar10
from test_torch_prefetch import make_cfg, read_events

NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]


# ------------------------------------------------------------- monitor

def _drive(monitor, ops):
    """Feed ``ops`` (``(step, loss, skipped)`` or ``"rollback"``) to a
    monitor; the decisions after each."""
    out = []
    for op in ops:
        if op == "rollback":
            try:
                out.append(("rollback", monitor.note_rollback()))
            except RuntimeError as e:
                out.append(("raised", str(e).split(";")[0]))
        else:
            monitor.observe(*op)
        out.append((monitor.should_rollback(), monitor.pending_since,
                    monitor.lr_scale, monitor.consecutive_skips,
                    monitor.total_skips, monitor.rollbacks))
    return out


def _random_ops(seed, n=60):
    """Losses around 2 with spikes, runs of skipped steps, inf and NaN
    losses, and a rollback at every 4th step while one is pending."""
    rng = np.random.default_rng(seed)
    ops, pending = [], False
    for s in range(1, n + 1):
        u = rng.random()
        loss = float(rng.lognormal(0.7, 0.1))
        skipped = 0.0
        if u < 0.2:
            loss, skipped = float("nan"), 1.0
        elif u < 0.25:
            loss *= 5.0
        elif u < 0.28:
            loss = float("inf")
        ops.append((s, loss, skipped))
        pending = pending or skipped or u < 0.28
        if s % 4 == 0 and pending:
            ops.append("rollback")
            pending = False
    return ops


MONITOR_CASES = {
    "skip budget": (dict(max_consecutive_skips=3),
                    [(1, float("nan"), 1.0), (2, float("nan"), 1.0),
                     (3, float("nan"), 1.0), "rollback", (4, 1.0, 1.0),
                     (5, 1.0, 0.0), (6, 1.0, 1.0)]),
    "spike and inf": (dict(max_consecutive_skips=0, loss_spike_factor=2.0,
                           loss_ema_beta=0.5, loss_ema_warmup=2),
                      [(0, 1.0, 0.0), (1, 1.0, 0.0), (2, 1.1, 0.0),
                       (3, 10.0, 0.0), "rollback", (4, float("inf"), 0.0)]),
    "spent budget": (dict(max_rollbacks=1, max_consecutive_skips=1),
                     [(1, float("nan"), 1.0), "rollback",
                      (2, float("nan"), 1.0), "rollback"]),
    "guard off": (dict(max_consecutive_skips=0),
                  [(1, float("nan"), 0.0), (2, float("inf"), 0.0)]),
    **{f"random {seed}": (dict(max_consecutive_skips=3,
                               loss_spike_factor=1.8, loss_ema_warmup=3,
                               lr_backoff=0.3, max_rollbacks=6),
                          _random_ops(seed)) for seed in range(4)},
}


@pytest.mark.parametrize("case", sorted(MONITOR_CASES))
def test_monitor_decides_as_the_reference(case):
    kw, ops = MONITOR_CASES[case]
    got = _drive(ResilienceMonitor(ResiliencePolicy(**kw)), ops)
    want = _drive(JMonitor(JPolicy(**kw)), ops)
    assert got == want
    assert (ResiliencePolicy(**kw).active == JPolicy(**kw).active)


def test_monitor_hooks_and_pre_arm():
    seen = []
    m = ResilienceMonitor(ResiliencePolicy(), on_anomaly=lambda r, s:
                          seen.append(("a", r, s)))
    m.add_anomaly_hook(lambda r, s: seen.append(("b", r, s)))
    m.pre_arm("health:ef", 7)
    m.pre_arm("other", 9)             # the first reason wins
    assert m.should_rollback() == "health:ef" and m.pending_since == 7
    assert seen == [("a", "health:ef", 7), ("b", "health:ef", 7)]


def test_backed_off_schedule_is_the_references():
    """``base(step) * scale`` in f32, as the reference's traced schedule
    multiplies it, at scales that are and are not powers of two."""
    args = (0.1, 4, 10, 100, 2.0, (0.5, 0.75), 0.1)
    from gaussiank_sgd_torch.training.lr_schedule import (
        warmup_milestone_schedule)
    sched = _ScaledSchedule(warmup_milestone_schedule(*args))
    jsched = jschedule(*args)
    for scale in (1.0, 0.5, 0.3, 0.09):
        sched.scale = scale
        for step in (0, 7, 20, 50, 80, 99):
            want = jsched(step) if scale == 1.0 else jsched(step) * scale
            assert sched(step) == float(np.float32(want)), (scale, step)


# ------------------------------------------ rollback against the reference

def _pair(tmp_path, **kw):
    """The port's and the reference's trainer on one narrow VGG config (f32,
    dropout off, CIFAR-10 files through the native pipeline), the
    reference started from the port's initial weights. Both native
    libraries must have loaded, or the two read other batches."""
    both_native_libraries()
    data = write_cifar10(str(tmp_path / "data"), 64, 32)
    cfg = dict(dnn="vgg16", dataset="cifar10", data_dir=data, batch_size=8,
               nworkers=1, lr=0.01, momentum=0.9, weight_decay=5e-4,
               max_steps=8, compressor="gaussian", density=0.01,
               compress_warmup_steps=2, warmup_epochs=0.0,
               compute_dtype="float32", log_every=1, eval_every_epochs=0,
               save_every_epochs=0, save_every_steps=2,
               max_consecutive_skips=2, seed=0,
               model_kwargs={"cfg": NARROW, "dropout": 0.0})
    cfg.update(kw)
    t = Trainer(TrainConfig(**cfg, device="cpu",
                            output_dir=str(tmp_path / "port")))
    jt = JTrainer(JTrainConfig(**cfg, output_dir=str(tmp_path / "ref")))
    params, stats = convert.export_flax_variables(t.model)
    jt.state = jt.ts.init_state(
        jax.tree.map(jnp.asarray, params), jax.random.PRNGKey(0),
        model_state={"batch_stats": jax.tree.map(jnp.asarray, stats)})
    return t, jt


def _port_state(t):
    st = t.state
    return [st.params.detach()[:t.plan.total_numel].numpy().copy(),
            st.opt_state["m"][:t.plan.total_numel].numpy().copy(),
            st.ef_residual[:t.plan.total_numel].numpy().copy(),
            t.model.stats.numpy().copy()]


def _ref_state(jt):
    from jax.flatten_util import ravel_pytree
    st = jax.device_get(jt.state)
    return [np.asarray(ravel_pytree(st.params)[0]),
            np.asarray(ravel_pytree(st.opt_state)[0]),
            np.asarray(st.ef_residual),
            np.asarray(ravel_pytree(st.model_state)[0])]


def _run_recording(trainer, snapshot, at_step):
    """Train to ``total_steps`` (a rollback moves the step back); the state
    snapshots after step ``at_step`` and right after the rollback."""
    before, after = None, None
    rollback = trainer._rollback

    def recording(reason):
        nonlocal after
        rollback(reason)
        after = snapshot(trainer)

    trainer._rollback = recording
    while trainer.step < trainer.total_steps:
        trainer.train(1)
        if trainer.step == at_step and before is None:
            before = snapshot(trainer)
    return before, after


def test_rollback_matches_the_reference(tmp_path):
    t, jt = _pair(tmp_path)
    chaos.inject_nan_batches(t, {4, 5})
    jchaos.inject_nan_batches(jt, {4, 5})
    before, after = _run_recording(t, _port_state, 4)
    jbefore, jafter = _run_recording(jt, _ref_state, 4)
    rb = read_events(t, "rollback")
    jrb = [json.loads(line) for line in open(os.path.join(
        jt.run_dir, "metrics.jsonl")) if '"rollback"' in line]
    assert len(rb) == len(jrb) == 1
    for key in ("reason", "rollback", "to_step", "lr_scale"):
        assert rb[0][key] == jrb[0][key], key
    assert (rb[0]["reason"], rb[0]["to_step"], rb[0]["lr_scale"]) == (
        "skip_budget", 4, 0.5)
    assert rb[0]["checkpoint"].endswith("step_00000004")
    assert [s["step"] for s in read_events(t, "skip")] == [5, 6]
    # each package restores its own state of step 4 bit for bit
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jbefore, jafter):
        np.testing.assert_array_equal(a, b)
    # the two trajectories agree before and after the rollback
    jlosses = [json.loads(line)["loss"] for line in open(os.path.join(
        jt.run_dir, "metrics.jsonl")) if '"event": "train"' in line]
    losses = [r["loss"] for r in t.records]
    assert len(losses) == len(jlosses) == 10
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-6)
    # the params, momentum and statistics at the losses' tolerance; the EF
    # row sums the unsent gradient of every step, so its absolute
    # tolerance scales with the row
    names = ["params", "momentum", "EF row", "statistics"] * 2
    for name, a, b in zip(names, before + _port_state(t),
                          jbefore + _ref_state(jt)):
        atol = 1e-5 * np.abs(b).max() if name == "EF row" else 1e-6
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol, err_msg=name)
    assert t.schedule.scale == 0.5 and t.step == 8
    t.close()
    jt.close()


def test_spike_rollback_skips_the_post_spike_checkpoint(tmp_path):
    """A cadence save in the interval where the loss spike is seen is
    suppressed, and the restore skips checkpoints at or after the spike: the
    run rewinds to the last checkpoint before it (reference test of the
    same name)."""
    t = Trainer(make_cfg(tmp_path, max_steps=12, log_every=2, lr=0.01,
                         save_every_steps=2, loss_spike_factor=1.5))
    chaos.inject_nan_batches(t, {6}, fill=100.0)     # poisons step 7
    while t.step < t.total_steps:
        t.train(t.total_steps - t.step)
    assert t.step == 12
    rb = read_events(t, "rollback")
    assert len(rb) == 1
    assert (rb[0]["reason"], rb[0]["to_step"], rb[0]["lr_scale"]) == (
        "loss_spike", 6, 0.5)
    assert rb[0]["checkpoint"].endswith("step_00000006")
    assert np.isfinite(t.records[-1]["loss"])
    t.close()


def test_rollback_without_checkpoint_fails_loud(tmp_path):
    t = Trainer(make_cfg(tmp_path, max_steps=8, log_every=1,
                         max_consecutive_skips=1, save_every_steps=0))
    chaos.inject_nan_batches(t, {1})
    with pytest.raises(RuntimeError, match="no restorable checkpoint.*"
                       "save_every_steps"):
        t.train(4)
    t.close()


def test_rollback_falls_back_past_a_corrupt_checkpoint(tmp_path):
    """The newest checkpoint garbage-filled: the rollback skips it (a
    ``restore_fallback`` event), restores the one before, and the run ends
    near the clean run's loss (reference test of the chaos run)."""
    base = Trainer(make_cfg(tmp_path / "base", max_steps=16, log_every=2))
    base.fit()
    base.close()
    t = Trainer(make_cfg(tmp_path / "chaos", max_steps=16, log_every=2,
                         save_every_steps=4, max_consecutive_skips=1))
    t.train(8)
    p8 = ck.latest_checkpoint(t.ckpt_dir)
    assert p8.endswith("step_00000008")
    chaos.corrupt_checkpoint(p8, "garbage")
    fired = chaos.inject_nan_batches(t, {8})
    while t.step < t.total_steps:
        t.train(t.total_steps - t.step)
    assert fired == {8} and [r["step"] for r in read_events(t, "skip")] == [9]
    rb = read_events(t, "rollback")
    assert [(r["to_step"], r["lr_scale"]) for r in rb] == [(4, 0.5)]
    assert [r["checkpoint"] for r in read_events(t, "restore_fallback")] == [
        p8]
    final, clean = t.records[-1]["loss"], base.records[-1]["loss"]
    assert np.isfinite(final) and abs(final - clean) <= 0.5 * abs(clean)
    assert torch.isfinite(t.state.ef_residual).all()
    with pytest.raises(FileNotFoundError, match="older than step 4"):
        ck.restore_latest_good(t.ckpt_dir, t.state, t.ts.ef_numel,
                               before_step=4)
    t.close()


def test_persistent_fault_spends_the_rollback_budget(tmp_path):
    """A batch poisoned on every replay: each rollback finds it again, and
    the run raises once ``max_rollbacks`` are spent."""
    t = Trainer(make_cfg(tmp_path, max_steps=12, log_every=1,
                         save_every_steps=2, max_consecutive_skips=1,
                         max_rollbacks=2))
    chaos.inject_nan_batches(t, {5}, once=False)
    with pytest.raises(RuntimeError, match="rollback budget exhausted"):
        while t.step < t.total_steps:
            t.train(1)
    assert [r["lr_scale"] for r in read_events(t, "rollback")] == [0.5, 0.25]
    t.close()


def test_guard_off_commits_a_nonfinite_step(tmp_path):
    """``--no-nonfinite-guard``: the step commits (the parameters take the
    NaN), skipped and nonfinite read 0, no skip event, and the skip
    detector is off, as in the reference."""
    t = Trainer(make_cfg(tmp_path, max_steps=4, compress_warmup_steps=1,
                         nonfinite_guard=False, log_every=1))
    assert t.monitor is None and not t.ts.guard_nonfinite
    chaos.inject_nan_batches(t, {2})
    rec = t.train(3)
    assert rec["skipped"] == rec["nonfinite"] == 0.0
    assert not read_events(t, "skip")
    # the NaN entered the EF row, where error feedback would re-send it
    assert not torch.isfinite(t.state.ef_residual).all()
    t.close()


def test_fold_lr_rollback_scales_the_accumulate(tmp_path):
    """Under ``--fold-lr`` the backoff reaches the EF accumulate's scale
    (B1's ``scale`` on the card): ``lr(step) * lr_scale`` in f32."""
    t = Trainer(make_cfg(tmp_path, compressor="gaussian_fused",
                         fold_lr=True, lr=0.1))
    base = t.ts.scale(3)
    t.schedule.scale = 0.5
    assert t.ts.scale(3) == float(np.float32(base) * np.float32(0.5))
    assert t.ts.optimizer.lr_at(3) == 1.0
    t.close()


# ------------------------------------------------------------ preemption

def test_graceful_shutdown_real_signal():
    gs = GracefulShutdown().install()
    try:
        assert not gs.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert gs.requested
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)   # a second Ctrl-C
    finally:
        gs.uninstall()
    assert signal.getsignal(signal.SIGTERM) is not gs._handler


def test_graceful_shutdown_installs_on_the_main_thread_only():
    err = []

    def off_main():
        try:
            GracefulShutdown().install()
        except RuntimeError as e:
            err.append(str(e))

    th = threading.Thread(target=off_main)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive() and "main thread" in err[0]


def test_fit_preempts_seals_and_resumes(tmp_path):
    t = Trainer(make_cfg(tmp_path, max_steps=10, log_every=2))
    t.train(3)
    t.shutdown.request()
    result = t.fit()
    assert result == {"preempted_at": 4.0}
    pre = read_events(t, "preempt")
    assert len(pre) == 1 and pre[0]["step"] == 4
    assert ck.latest_checkpoint(t.ckpt_dir).endswith("step_00000004")
    t.close()
    r = Trainer(make_cfg(tmp_path, max_steps=10, log_every=2,
                         resume=t.ckpt_dir))
    assert r.step == 4
    r.fit()
    assert r.step == 10
    r.close()


def test_train_raises_training_preempted(tmp_path):
    t = Trainer(make_cfg(tmp_path, max_steps=8))
    t.shutdown.request()
    with pytest.raises(TrainingPreempted) as ei:
        t.train(4)
    assert ei.value.step == 1
    assert ck.is_committed(ei.value.ckpt_path)
    t.close()


def _cli(out, run_id, *extra, max_steps=120):
    return ["--device", "cpu", "--dnn", "vgg16", "--batch-size", "8",
            "--compressor", "gaussian_fused", "--density", "0.01",
            "--compress-warmup-steps", "2", "--max-steps", str(max_steps),
            "--compute-dtype", "float32", "--eval-every-epochs", "0",
            "--lr", "0.01", "--model-kwargs", json.dumps({"cfg": NARROW}),
            "--output-dir", str(out), "--run-id", run_id, *extra]


def _trainer(argv):
    p = __import__("argparse").ArgumentParser()
    add_args(p)
    return Trainer(from_args(p.parse_args(argv), argv))


def _child(tmp_path, run_id, *extra):
    """``python -m gaussiank_sgd_torch.train`` on the CPU, one thread (the
    runs a test compares must sum in the same order)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "gaussiank_sgd_torch.train",
         *_cli(tmp_path, run_id, *extra)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finished(child):
    try:
        out, _ = child.communicate(timeout=240)
    finally:
        child.kill()
    assert child.returncode == 0, out[-3000:]
    return out


def _checkpoint(path):
    """Every tensor of a sealed one-rank checkpoint, by name."""
    shared = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    row = torch.load(os.path.join(path, "rank_00000.pt"), weights_only=True)
    out = {"step": torch.tensor(shared["step"]), "params": shared["params"],
           "ef_residual": row["ef_residual"],
           "comp_state": row["comp_state"],
           "dropout_generator": row["dropout_generator"]}
    out.update({f"opt/{k}": v for k, v in shared["opt_state"].items()})
    out.update({f"model/{k}": v for k, v in shared["model_state"].items()})
    return out


def test_sigterm_to_a_child_run_seals_and_resumes_bit_for_bit(tmp_path):
    """``python -m gaussiank_sgd_torch.train`` on the CPU, sent SIGTERM
    once its metrics show a sparse step: it exits 0 with one ``preempt``
    event and a sealed checkpoint at that step; resumed from it to the end,
    its final checkpoint (params, momentum, EF row, thresholds, statistics,
    dropout generator, step) is the uninterrupted run's, bit for bit."""
    clean = _child(tmp_path, "clean")
    child = _child(tmp_path, "pre")
    metrics = tmp_path / "pre" / "metrics.jsonl"
    steps = tmp_path / "pre" / "steps.jsonl"
    deadline = time.monotonic() + 240
    while time.monotonic() < deadline and child.poll() is None:
        if steps.exists() and '"kind": "sparse"' in steps.read_text():
            child.send_signal(signal.SIGTERM)
            break
        time.sleep(0.01)
    out = _finished(child)
    events = [json.loads(line) for line in metrics.read_text().splitlines()]
    pre = [e for e in events if e.get("event") == "preempt"]
    assert len(pre) == 1 and 2 < pre[0]["step"] < 120, out[-3000:]
    stop = pre[0]["step"]
    assert max(json.loads(line)["step"] for line in
               steps.read_text().splitlines()) == stop
    path = pre[0]["checkpoint"]
    assert path.endswith(f"step_{stop:08d}") and ck.is_committed(path)
    _finished(_child(tmp_path, "pre", "--resume",
                     str(tmp_path / "pre" / "ckpt")))
    _finished(clean)
    resumed = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [e["step"] for e in resumed if e.get("event") == "restore"] == [
        stop]
    got = _checkpoint(str(tmp_path / "pre" / "ckpt" / "step_00000120"))
    want = _checkpoint(str(tmp_path / "clean" / "ckpt" / "step_00000120"))
    assert got.keys() == want.keys()
    for key, v in want.items():
        assert torch.equal(got[key], v), key


def _w_preempt(rank, world, cfg_kw, stop_at):
    """One rank: a run with SIGTERM sent to rank 1 alone when the batch of
    ``stop_at`` is pulled, resumed to the end; and the uninterrupted run."""
    from gaussiank_sgd_torch.training import chaos
    from gaussiank_sgd_torch.training.config import TrainConfig
    from gaussiank_sgd_torch.training.trainer import Trainer

    def final(t):
        st = t.state
        return [x.detach().numpy().copy() for x in (
            st.params, st.opt_state["m"], st.ef_residual, st.comp_state,
            t.model.stats)] + [st.step]

    t = Trainer(TrainConfig(**cfg_kw))
    if rank == 1:
        chaos.inject_preemption(t, stop_at)
    result = t.fit()
    t.close()
    r = Trainer(TrainConfig(**{**cfg_kw, "resume": t.ckpt_dir}))
    resumed_at = r.step
    r.fit()
    r.close()
    u = Trainer(TrainConfig(**{**cfg_kw, "run_id": "clean"}))
    u.fit()
    u.close()
    return {"nworkers": t.cfg.nworkers, "result": result,
            "resumed_at": resumed_at, "resumed": final(r),
            "clean": final(u)}


def test_two_ranks_agree_on_the_preemption_step(tmp_path):
    """P = 2 over gloo, ``nworkers`` 0 (the world size), SIGTERM to rank 1
    only: both ranks stop and seal at the same step, the resumed run of
    each ends bit for bit where the uninterrupted run does, and the two
    ranks' parameters agree."""
    cfg_kw = dict(dnn="vgg16", batch_size=4, nworkers=0, lr=0.01,
                  compressor="gaussian_fused", density=0.01,
                  compress_warmup_steps=1, max_steps=12,
                  compute_dtype="float32", eval_every_epochs=0,
                  save_every_epochs=0, device="cpu",
                  model_kwargs={"cfg": NARROW},
                  output_dir=str(tmp_path / "runs"), run_id="pre")
    out = _spawn(tmp_path, 2, _w_preempt, cfg_kw=cfg_kw, stop_at=5)
    for o in out:
        assert o["nworkers"] == 2
        stop = o["result"]["preempted_at"]
        assert o["resumed_at"] == stop and 2 <= stop < 12
        for a, b in zip(o["resumed"], o["clean"], strict=True):
            np.testing.assert_array_equal(a, b)
    assert out[0]["result"] == out[1]["result"]
    np.testing.assert_array_equal(out[0]["clean"][0], out[1]["clean"][0])


# -------------------------------------- results, nworkers 0, profiler

def test_nworkers_zero_is_the_world_size(tmp_path):
    t = _trainer(_cli(tmp_path, "zero", "--nworkers", "0", max_steps=2))
    assert t.cfg.nworkers == t.world == 1 and t.train_ds.batch_size == 8
    t.close()


def test_train_and_fit_return_the_references_keys(tmp_path):
    """``train(4)`` at ``log_every`` 2 returns the last interval's record
    with the reference's keys (``mfu`` is absent from both on the CPU) and
    its values (the loss within the FMA difference), and the records the
    two buses published carry the same keys, stamps included; ``fit`` then
    returns ``preempted_at`` equal to the reference's."""
    t, jt = _pair(tmp_path, log_every=2, max_steps=10)
    rec, jrec = t.train(4), jt.train(4)
    assert set(rec) == set(jrec)
    for key in ("event", "step", "epoch", "num_selected", "bytes_sent",
                "density", "density_achieved", "skipped", "nonfinite",
                "wire_format", "overlap", "consecutive_skips", "lr_scale"):
        assert rec[key] == jrec[key], key
    for key in ("loss", "lr", "grad_norm", "ef_norm", "acc"):
        np.testing.assert_allclose(rec[key], jrec[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    assert rec["io_s"] > 0 and rec["step_s"] > 0 and rec["ex_per_s"] > 0
    quiet, jquiet = t.train(1), jt.train(1)
    assert quiet["step"] == jquiet["step"] == 5
    assert set(quiet) == set(jquiet)
    published = [e for e in read_events(t) if e["event"] == "train"]
    jpublished = [json.loads(line) for line in open(os.path.join(
        jt.run_dir, "metrics.jsonl")) if '"event": "train"' in line]
    assert [e["step"] for e in published] == [
        e["step"] for e in jpublished] == [2, 4, 5]
    for e, je in zip(published, jpublished):
        assert set(e) == set(je) >= {"schema_version", "seq", "ts"}
    t.shutdown.request()
    jt.shutdown.request()
    assert t.fit() == jt.fit() == {"preempted_at": 6.0}
    assert t.train(0) == {}
    t.close()
    jt.close()


def test_profile_steps_trace_the_window(tmp_path):
    """``--profile-steps 2 4`` traces steps 2-3 into ``run_dir/profile``
    with start and stop events; a run resumed at step 3 enters the window
    late and still traces; ``close`` stops a trace still running."""
    t = _trainer(_cli(tmp_path, "prof", "--profile-steps", "2", "4",
                      "--save-every-steps", "3", max_steps=6))
    t.train(6)
    ev = [(e["action"], e["step"]) for e in read_events(t, "profile")]
    assert ev == [("start", 2), ("stop", 4)]
    assert os.path.exists(t.profiler.path)
    assert t.profiler.path.startswith(os.path.join(t.run_dir, "profile"))
    assert t.profiler.wall_s > 0 and t.profiler.last.key_averages()
    t.close()
    late = _trainer(_cli(tmp_path, "prof", "--profile-steps", "2", "4",
                         "--resume", os.path.join(t.ckpt_dir,
                                                  "step_00000003"),
                         max_steps=6))
    assert late.step == 3
    late.train(2)
    ev = [(e["action"], e["step"]) for e in read_events(late, "profile")]
    assert ev[-2:] == [("start", 3), ("stop", 4)]
    late.close()
    live = _trainer(_cli(tmp_path, "live", "--profile-steps", "1", "50",
                         max_steps=6))
    live.train(3)
    assert live.profiler.active
    live.close()
    assert not live.profiler.active
    ev = [(e["action"], e["step"]) for e in read_events(live, "profile")]
    assert ev == [("start", 1), ("stop", 3)]
