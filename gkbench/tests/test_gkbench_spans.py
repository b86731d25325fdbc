"""The readers of the program's own spans and counter (``enqueue_ms``,
``log_interval_ms``, ``host_syncs_per_step``) on a hand-built store: they
read the window's steps before the profiled stretch alone, give None
without a store (a program that keeps none, or tracing off) and on a run
that profiled no device, and ``log_interval_ms`` averages the steps that
end a log interval only."""

import pytest

from gaussiank_sgd_torch.telemetry import tracing
from gkbench import harness, manifest, trace

READERS = ("enqueue_ms", "log_interval_ms", "host_syncs_per_step")


def _entry(dispatch, sync, syncs, log=None):
    ms = {"step_dispatch": dispatch, "step_sync": sync}
    if log is not None:
        ms["log_interval"] = log
    return {"ms": ms, "calls": {name: 1 for name in ms},
            "counts": {"host_syncs": syncs}}


class _Store:
    def __init__(self, entries):
        self.entries = entries

    def steps(self):
        return dict(self.entries)


# two set-up steps, then a window of six: four before the profiled
# stretch, two in it; every number outside the four reads 1000
STORE = {
    19: _entry(1000.0, 0.0, 1000, log=1000.0),
    20: _entry(1000.0, 0.0, 1000),
    21: _entry(40.0, 10.0, 9),
    22: _entry(42.0, 8.0, 17, log=6.0),
    23: _entry(39.0, 11.0, 9),
    24: _entry(43.0, 9.0, 17, log=8.0),
    25: _entry(1000.0, 0.0, 1000, log=1000.0),
    26: _entry(1000.0, 0.0, 1000),
}


def _ctx(**kw):
    base = dict(setup_s=10.0, window_s=1.0, steps=6, skipped=0,
                global_batch=64, walls_s=[0.05] * 6, step_ms=[40.0] * 6,
                outside=[0, 1, 2, 3], stretch_steps=2,
                summary=trace.Summary(window_s=0.1, busy_s=0.06))
    base.update(kw)
    return harness.Context(**base)


def _read(name, ctx):
    return manifest.reader(name).read(ctx)


@pytest.fixture
def store(monkeypatch):
    monkeypatch.setattr(tracing, "active", lambda: _Store(STORE))


def test_they_read_the_steps_before_the_stretch(store):
    ctx = _ctx()
    assert _read("enqueue_ms", ctx) == pytest.approx((30 + 34 + 28 + 34) / 4)
    assert _read("host_syncs_per_step", ctx) == pytest.approx(52 / 4)


def test_log_interval_averages_the_steps_that_end_an_interval(store):
    assert _read("log_interval_ms", _ctx()) == pytest.approx(7.0)
    # no log step before the stretch: nothing to read
    assert _read("log_interval_ms", _ctx(outside=[0])) is None


def test_they_give_none_without_a_store(monkeypatch):
    monkeypatch.setattr(tracing, "active", lambda: None)
    assert all(_read(name, _ctx()) is None for name in READERS)
    monkeypatch.delattr(tracing, "active")         # a program without one
    assert all(_read(name, _ctx()) is None for name in READERS)


def test_they_give_none_on_a_run_without_a_device_or_a_whole_window(store):
    idle = trace.Summary(window_s=0.1, busy_s=0.0)
    for ctx in (_ctx(summary=idle), _ctx(summary=None), _ctx(steps=9),
                _ctx(outside=[])):
        assert all(_read(name, ctx) is None for name in READERS)


def test_the_manifest_reports_them_in_every_cell():
    bench = manifest.load_manifest()
    for cell in ("vgg16-gk-1c", "resnet50-gk-1c"):
        names = {m["name"] for m in manifest.metrics_for(bench, cell,
                                                         "per_layer")}
        assert set(READERS) <= names
