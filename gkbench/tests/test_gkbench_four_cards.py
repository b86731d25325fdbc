"""The four-card cell ``vgg16-gk-4c``, whose files are in place and which
``BENCHMARK.json`` does not list yet (PERF.md, Open questions: the port
diverges on some of its seeds): its files load at the published 128 a
worker with the deployment's epoch, adding it keeps the manifest to one
cell on four chips, the ``stop_flag_ms`` reader, the whole run on four
gloo ranks at a tiny size (sound, and with each fault planted under the
timed path), and the control and the missing exchange at the cell's own
size on a card."""

import json

import pytest
import torch

from gaussiank_sgd_torch.telemetry import tracing
from gkbench import check, harness, manifest, run
from gkbench.tests.faults import planted
from gkbench.tests.test_gkbench_spans import _ctx, _entry, _Store
from gkbench.tests.tiny import tiny_cell

CELL = "vgg16-gk-4c"
# the entries that list the cell, as BENCHMARK.json will hold them
ENTRIES = {
    "configs": [{
        "name": "vgg16-cifar10-gk-4w",
        "source": "https://arxiv.org/abs/1911.08772",
        "file": "gkbench/configs/vgg16-cifar10-gk-4w.json",
        "reduced": ["nworkers", "compressor", "compress_warmup_steps",
                    "max_steps", "dataset_kwargs"],
        "why": "VGG-16 BN on CIFAR-10, GaussianK 0.001 with EF (BASELINE "
               "config 2) at the published 128 a worker: 4 of the 8 "
               "workers, one a card, over NCCL"}],
    "workloads": [{
        "name": CELL, "config": "vgg16-cifar10-gk-4w",
        "traffic": "cifar10-b512-epoch", "chips": 4,
        "why": "closed loop, 128 a worker at 32x32 on 4 cards over one "
               "epoch of batches: the NCCL all-gather of the pairs, the "
               "stop flag's all-reduce, four host loops"}],
    "per_layer": [
        {"name": "exchange_ms", "unit": "ms", "better": "lower",
         "source": "device_trace", "layer": "exchange",
         "moves": "samples_per_s", "workloads": [CELL]},
        {"name": "stop_flag_ms", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "trainer loop",
         "moves": "samples_per_s", "workloads": [CELL]}],
}


def _with_cell():
    bench = json.loads(json.dumps(manifest.load_manifest()))
    for kind, entries in ENTRIES.items():
        names = {e["name"] for e in bench[kind]}
        bench[kind] += [e for e in entries if e["name"] not in names]
    return bench


def _cell():
    return manifest.load_cell(CELL, _with_cell())


def test_the_four_card_cell_runs_the_published_batch_and_epoch():
    cell = _cell()
    assert cell.chips == 4
    assert cell.config["train"]["batch_size"] == 128
    assert cell.global_batch == 512 == cell.traffic["global_batch"]
    # CIFAR-10's 50,000 training images: 97 steps of 512 an epoch, so the
    # five warm-up epochs span 485 steps, as in the deployment
    hyper = harness.hyper(cell)
    assert hyper.steps_per_epoch == 97 and hyper.workers == 4
    # the pool is one epoch of distinct batches
    pool_rows = cell.traffic["pool_batches"] * cell.traffic["global_batch"]
    assert pool_rows >= 50_000 > pool_rows - cell.traffic["global_batch"]
    entry = ENTRIES["configs"][0]
    assert (manifest.ROOT / entry["file"]).is_file()
    assert set(entry["reduced"]) == set(cell.config["reduced"])
    assert set(cell.setup["limits"]) <= set(check.NUMBERS)


@pytest.mark.parametrize("bench", [manifest.load_manifest(), _with_cell()])
def test_the_manifest_holds_at_most_one_four_chip_cell(bench):
    cells = bench["workloads"]
    four = [w["name"] for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)


def test_the_exchange_metrics_are_the_four_card_cells_alone():
    bench = _with_cell()
    for name in ("exchange_ms", "stop_flag_ms"):
        assert callable(manifest.reader(name).read)
    assert {m["name"] for m in manifest.metrics_for(
        bench, CELL, "per_layer")} >= {"exchange_ms", "stop_flag_ms"}
    for cell in ("vgg16-gk-1c", "resnet50-gk-1c"):
        names = {m["name"] for m in manifest.metrics_for(bench, cell,
                                                         "per_layer")}
        assert not names & {"exchange_ms", "stop_flag_ms"}


# the window's six steps: four before the profiled stretch, two in it;
# the steps outside the four read 1000
FLAGGED = {19: _entry(1000.0, 0.0, 1000), 20: _entry(1000.0, 0.0, 1000)}
for step, flag in zip(range(21, 27), (1.5, 2.5, None, 4.0, 1000.0,
                                      1000.0)):
    FLAGGED[step] = _entry(40.0, 10.0, 9)
    if flag is not None:
        FLAGGED[step]["ms"]["stop_flag"] = flag


def test_stop_flag_ms_averages_the_steps_that_carry_the_span(monkeypatch):
    read = manifest.reader("stop_flag_ms").read
    monkeypatch.setattr(tracing, "active", lambda: _Store(FLAGGED))
    assert read(_ctx()) == pytest.approx((1.5 + 2.5 + 4.0) / 3)
    # no step before the stretch carries it (a program without the
    # span): nothing to read
    assert read(_ctx(outside=[2])) is None
    for ctx in (_ctx(summary=None), _ctx(outside=[])):
        assert read(ctx) is None
    monkeypatch.setattr(tracing, "active", lambda: None)
    assert read(_ctx()) is None


def _tiny():
    cell = _cell()
    # tiny_cell reads the cell from BENCHMARK.json; this one's files
    # stand in until it is listed there
    with pytest.MonkeyPatch.context() as m:
        m.setattr(manifest, "load_cell", lambda name: cell)
        return tiny_cell(CELL, chips=4)


def _run(cell):
    return run.run_cell(cell, 2**31 + 23, 0.5, False, "cpu",
                        bench=_with_cell())


def test_four_workers_over_gloo_agree():
    result = _run(_tiny())
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == 4 and result["failed"] == 0


@pytest.mark.parametrize("plant", ["unchanged", "half_batch", "no_exchange"])
def test_a_broken_step_on_four_workers_is_not_correct(plant, monkeypatch):
    with planted(monkeypatch, plant):
        result = _run(_tiny())
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("reading", ["fp8", "no_exchange"])
def test_the_control_and_no_exchange_fail_at_the_cells_own_size(reading):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size")
    cell = _cell()
    limits = cell.setup["limits"]
    precision = "fp8" if reading == "fp8" else "float32"
    fault = None if reading == "fp8" else reading
    numbers, _ = harness.reference_numbers(cell, 7, torch.device("cuda"),
                                           None, precision, fault)
    assert any(numbers[n][0] > limits[n] for n in limits)
