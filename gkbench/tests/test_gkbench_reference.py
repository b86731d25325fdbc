"""The reference against the port at a tiny size, the whole run driven
on the CPU, the control and the planted faults coming out not correct,
and the control at the cell's own size on a card."""

import pytest
import torch

from gkbench import harness, manifest, run
from gkbench.reference import models
from gkbench.tests.faults import planted
from gkbench.tests.tiny import TINY_LIMITS, tiny_cell


@pytest.mark.parametrize("dnn,build", [
    ("vgg16", lambda: models.vgg16_leaves()),
    ("resnet50", lambda: models.resnet50_leaves()),
])
def test_reference_lays_out_the_published_models_as_the_port(dnn, build):
    from gaussiank_sgd_torch.models import get_model
    dataset = "cifar10" if dnn == "vgg16" else "imagenet"
    port = get_model(dnn, dataset, device="meta").module
    ours = models.flat_layout(build())
    assert [(p, tuple(s)) for p, s in port.param_layout] == ours
    assert models.numel(ours) == {"vgg16": 14_986_698,
                                  "resnet50": 25_557_032}[dnn]


def _run(cell, traced=False):
    return run.run_cell(cell, 2**31 + 11, 0.5, traced, "cpu")


def test_vgg16_one_worker_agrees_and_reports_every_metric():
    result = _run(tiny_cell("vgg16-gk-1c"))
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {
        m["name"] for m in manifest.metrics_for(
            manifest.load_manifest(), "vgg16-gk-1c", "end_to_end")}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"


def test_vgg16_traced_run_on_the_cpu_has_no_device_numbers():
    result = _run(tiny_cell("vgg16-gk-1c"), traced=True)
    assert result["correct"], result["checks"]
    # the host's own numbers only: no device activity to read on the CPU
    assert set(result["metrics"]) == {"data_wait_ms", "loop_host_ms"}


def test_resnet50_first_step_agrees():
    cell = tiny_cell("resnet50-gk-1c")
    steps = harness.first_steps(cell, 5, torch.device("cpu"))
    numbers, ref = harness.reference_numbers(cell, 5, torch.device("cpu"),
                                             steps)
    # the selection can flip an entry at the k-th place on float32
    # rounding at this size (BatchNorms over 16 values, whose variance the
    # port takes as E[x^2] - E[x]^2), so step 1 is held to 1e-3 by leaf;
    # every fault reads 1e-2 or more
    assert steps.losses[0] == pytest.approx(ref.losses[0], rel=1e-5)
    assert numbers["grad_gap"][0] < 1e-3
    assert numbers["residual_gap"][0] < 1e-3


def test_two_workers_over_gloo_agree():
    result = _run(tiny_cell("vgg16-gk-1c", chips=2))
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == 2


@pytest.mark.parametrize("plant,chips", [("unchanged", 1),
                                         ("half_batch", 1),
                                         ("no_exchange", 2)])
def test_a_broken_step_is_not_correct(plant, chips, monkeypatch):
    with planted(monkeypatch, plant):
        result = _run(tiny_cell("vgg16-gk-1c", chips))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("reading", ["fp8", "half_batch", "no_exchange"])
def test_the_control_and_the_reference_faults_are_caught(reading):
    cell = tiny_cell("vgg16-gk-1c", chips=2)
    dev = torch.device("cpu")
    precision = "fp8" if reading == "fp8" else "float32"
    fault = None if reading == "fp8" else reading
    numbers, _ = harness.reference_numbers(cell, 3, dev, None, precision,
                                           fault)
    assert any(numbers[n][0] > TINY_LIMITS[n] for n in TINY_LIMITS)


def test_an_unchanged_state_reads_one(monkeypatch):
    cell = tiny_cell("vgg16-gk-1c")
    dev = torch.device("cpu")
    with planted(monkeypatch, "unchanged"):
        steps = harness.first_steps(cell, 9, dev)
    numbers, _ = harness.reference_numbers(cell, 9, dev, steps)
    assert numbers["update_gap"][0] == pytest.approx(1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["vgg16-gk-1c", "resnet50-gk-1c"])
def test_the_control_fails_at_the_cells_own_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size")
    c = manifest.load_cell(cell)
    limits = c.setup["limits"]
    numbers, _ = harness.reference_numbers(c, 7, torch.device("cuda"), None,
                                           "fp8")
    assert any(numbers[n][0] > limits[n] for n in limits)
