"""The port's throughput/MFU tracker (``telemetry/throughput.py``) and the
trainer's instruments against the reference's.

* ``ThroughputTracker``: the same signals as the reference's, exactly,
  after every operation of generated sequences of updates (skipped steps
  among them), resets and window sizes (hypothesis), and the reference's
  own cases (``tests/test_telemetry.py``).
* The trainer's log record carries the windowed ``ex_per_s``; ``mfu`` is
  absent on the CPU, as in the reference's (no peak is known there).
* ``--phase-timing`` on a narrow VGG beside the reference's trainer: each
  interval's record has the reference's keys (``phase_skipped`` on an
  interval that ran a step kind for the first time; ``fwd_bwd_s`` and
  ``comm_update_s`` in warm-up; with ``select_s`` and
  ``exposed_exchange_ms`` on a sparse interval), every one >= 0; and the
  run's losses and final state are bit for bit those of the same run
  without it (the probes write no state and keep the dropout
  generator).
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gaussiank_sgd_tpu.telemetry.throughput import \
    ThroughputTracker as JTracker
from gaussiank_sgd_torch.telemetry.throughput import ThroughputTracker
from gaussiank_sgd_torch.training.trainer import Trainer
from test_torch_resilience import _pair

_op = st.one_of(
    st.tuples(st.just("update"), st.integers(0, 512),
              st.floats(0.0, 2.0, allow_nan=False), st.booleans()),
    st.tuples(st.just("reset")))


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 6), st.floats(0.05, 0.95), st.lists(_op, max_size=25),
       st.sampled_from([(None, None), (2e12, None), (2e12, 4e12)]))
def test_tracker_gives_the_references_signals(window, beta, ops, mfu_in):
    tr, jtr = ThroughputTracker(window, beta), JTracker(window, beta)
    for op in ops:
        for t in (tr, jtr):
            if op[0] == "reset":
                t.reset()
            else:
                t.update(op[1], op[2], skipped=op[3])
        assert (dataclasses.asdict(tr.signals(*mfu_in))
                == dataclasses.asdict(jtr.signals(*mfu_in)))
        assert (len(tr), tr.examples_per_s, tr.steps_per_s, tr.step_s_ema,
                tr.skipped_in_window, tr.total_seconds) == (
            len(jtr), jtr.examples_per_s, jtr.steps_per_s, jtr.step_s_ema,
            jtr.skipped_in_window, jtr.total_seconds)
        assert tr.mfu(*mfu_in) == jtr.mfu(*mfu_in)


def test_tracker_cases_of_the_reference():
    """Skipped steps burn time and add no examples; a reset forgets the
    window and the EMA; the window rolls; bad arguments raise."""
    tr = ThroughputTracker(window=10)
    for _ in range(4):
        tr.update(32, 0.1)
    assert tr.examples_per_s == pytest.approx(320.0)
    for _ in range(4):
        tr.update(32, 0.1, skipped=True)
    assert tr.examples_per_s == pytest.approx(160.0)
    assert tr.skipped_in_window == 4
    assert tr.steps_per_s == pytest.approx(4 / 0.8)
    tr.reset()
    assert len(tr) == 0 and tr.examples_per_s is None
    assert tr.step_s_ema is None
    with pytest.raises(ValueError):
        ThroughputTracker(window=0)
    with pytest.raises(ValueError):
        ThroughputTracker(ema_beta=1.0)
    tr = ThroughputTracker(window=2)
    with pytest.raises(ValueError):
        tr.update(32, -1.0)
    for ex in (10, 10, 90):                  # rolls the first sample out
        tr.update(ex, 1.0)
    assert tr.examples_per_s == pytest.approx(50.0)
    assert tr.mfu(2e12, 4e12) == pytest.approx(0.5)
    assert tr.mfu(None, 4e12) is None and tr.mfu(2e12, None) is None


_PHASE_KEYS = {"fwd_bwd_s", "select_s", "comm_update_s",
               "exposed_exchange_ms", "phase_skipped"}


def _state(t):
    st_ = t.state
    return [st_.params.detach().numpy().copy(), st_.ef_residual.numpy().copy(),
            st_.opt_state["m"].numpy().copy(), t.model.stats.numpy().copy()]


def test_phase_timing_gives_the_references_keys(tmp_path):
    """Five intervals of 2 steps (warm-up 6, gaussian_fused): the first
    interval is skipped (the first dense step), the second is timed in
    warm-up, the third (dense, ending where warm-up does) and the fifth
    carry all four phases, the fourth is skipped (the first sparse step);
    the reference's trainer, on the same config, gives the same keys."""
    kw = dict(log_every=2, max_steps=10, compress_warmup_steps=6,
              compressor="gaussian_fused", phase_timing=True,
              save_every_steps=0, bucket_size=4096, bucket_policy="uniform")
    t, jt = _pair(tmp_path, **kw)
    assert t.ts.overlap == "pipelined"
    recs, jrecs = [t.train(2) for _ in range(5)], [jt.train(2)
                                                   for _ in range(5)]
    full = _PHASE_KEYS - {"phase_skipped"}
    want = [{"phase_skipped"}, {"fwd_bwd_s", "comm_update_s"}, full,
            {"phase_skipped"}, full]
    for rec, jrec, keys in zip(recs, jrecs, want):
        assert set(rec) & _PHASE_KEYS == set(jrec) & _PHASE_KEYS == keys
        for key in keys - {"phase_skipped"}:
            assert rec[key] >= 0.0, key
        assert rec.get("phase_skipped", "compile_in_interval") == \
            "compile_in_interval"
        assert rec["ex_per_s"] > 0 and "mfu" not in rec and "mfu" not in jrec
    assert recs[4]["overlap"] == jrecs[4]["overlap"] == "pipelined"
    assert recs[4]["overlapped_bytes_sent"] == jrecs[4][
        "overlapped_bytes_sent"]
    # the same run without the probes: the same records and state
    plain = Trainer(dataclasses.replace(t.cfg, phase_timing=False,
                                        output_dir=str(tmp_path / "plain")))
    prec = [plain.train(2) for _ in range(5)]
    assert [r["loss"] for r in plain.records] == [r["loss"]
                                                  for r in t.records]
    for a, b in zip(_state(plain), _state(t)):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    for rec, prec_ in zip(recs, prec):
        assert set(rec) - _PHASE_KEYS == set(prec_)
    t.close()
    plain.close()

