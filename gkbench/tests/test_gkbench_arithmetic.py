"""The readers' arithmetic: the p95, the rate, the MFU, the roofline's
12n + 8k bytes, and the reduction of a profiler trace."""

import statistics

import pytest
import torch

from gkbench import flops, harness, manifest, trace
from gkbench.layers import COMPRESS, FWD_BWD, WINDOW
from gkbench.stats import mean_of, p95


def _ctx(**kw):
    base = dict(setup_s=12.5, window_s=2.0, steps=100, skipped=0,
                global_batch=128, walls_s=[0.02] * 100, step_ms=[15.0] * 100)
    base.update(kw)
    return harness.Context(**base)


def read(name, ctx):
    return manifest.reader(name).read(ctx)


def test_p95_interpolates_between_order_statistics():
    xs = list(range(1, 101))
    assert p95(xs) == pytest.approx(95.05)
    assert p95([3.0]) is None
    assert p95([1.0, 2.0]) == pytest.approx(1.95)


def test_step_ms_p95_covers_every_step():
    walls = [0.01] * 90 + [0.05] * 10          # every tenth step logs
    ctx = _ctx(walls_s=walls)
    want = statistics.quantiles(walls, n=20, method="inclusive")[18] * 1e3
    assert read("step_ms_p95", ctx) == pytest.approx(want)
    assert read("step_ms_p95", ctx) == pytest.approx(50.0)


def test_samples_per_s_counts_skipped_time_but_not_samples():
    assert read("samples_per_s", _ctx()) == pytest.approx(100 * 128 / 2.0)
    assert read("samples_per_s", _ctx(skipped=10)) == pytest.approx(
        90 * 128 / 2.0)
    assert read("samples_per_s", _ctx(steps=0)) is None
    assert read("setup_s", _ctx()) == 12.5


def test_step_mfu_pct():
    ctx = _ctx(flops_per_step=240e9, peaks=(989.4e12, 3.35e12),
               outside=list(range(90)), outside_s=1.5)
    assert read("step_mfu_pct", ctx) == pytest.approx(
        100 * 240e9 * 90 / (1.5 * 989.4e12))
    assert read("step_mfu_pct", _ctx(flops_per_step=240e9)) is None


def test_compress_roofline_counts_12n_plus_8k():
    n, k = 14_986_698, 14_987
    assert flops.k_of(n, 0.001) == k
    assert flops.compress_bytes(n, k) == 12 * n + 8 * k
    summary = trace.Summary(window_s=0.5, busy_s=0.3,
                            range_s={COMPRESS: 0.004, FWD_BWD: 0.15})
    ctx = _ctx(summary=summary, stretch_steps=20, n=n, k=k,
               peaks=(989.4e12, 3.35e12))
    assert read("compress_ms", ctx) == pytest.approx(0.2)
    assert read("fwd_bwd_ms", ctx) == pytest.approx(7.5)
    assert read("compress_roofline_pct", ctx) == pytest.approx(
        100 * (12 * n + 8 * k) / 3.35e12 / 0.2e-3)
    assert read("exchange_ms", ctx) is None      # the range never ran
    assert read("device_idle_pct", ctx) == pytest.approx(40.0)


def test_host_loop_and_data_wait():
    ctx = _ctx(walls_s=[0.02] * 4, step_ms=[15.0] * 4,
               data_wait_ms=[1.0, 1.0, 9.0, 1.0], outside=[0, 1, 3])
    assert read("data_wait_ms", ctx) == pytest.approx(1.0)
    assert read("loop_host_ms", ctx) == pytest.approx(4.0)
    assert mean_of([1.0], [0, 1]) is None        # a step without a value


def test_peaks_by_card_name():
    assert flops.peaks("NVIDIA H100 80GB HBM3") == (989.4e12, 3.35e12)
    assert flops.peaks("NVIDIA H100 PCIe")[0] == 756.5e12
    assert flops.peaks("cpu") is None and flops.peaks(None) is None


def test_step_flops_counts_the_forward_and_backward():
    from gkbench import reference
    model = reference.build({"model": "vgg16", "num_classes": 10,
                             "image": [8, 8, 3], "dropout": 0.5,
                             "widths": [8, "M", 16, "M"]})
    got = flops.step_flops(model, (((4, 8, 8, 3), torch.float32),
                                   ((4,), torch.int64)))
    # conv 3->8 at 8x8 and 8->16 at 4x4, dense 64->512 and 512->10: the
    # forward's 2 FLOPs a MAC, the backward's twice that (none for the
    # input's gradient of the first layer)
    macs = [4 * 8 * 8 * 27 * 8, 4 * 4 * 4 * 72 * 16, 4 * 64 * 512,
            4 * 512 * 10]
    assert got == 2 * sum(macs) * 3 - 2 * macs[0]


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 0}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_reduction_attributes_kernels_to_ranges():
    events = [
        _ev("user_annotation", WINDOW, 0, 1000),
        _ev("user_annotation", FWD_BWD, 10, 300),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
        # the backward's launch, from autograd's own thread
        _ev("cuda_runtime", "cudaLaunchKernel", 40, 5, tid=2, corr=2),
        _ev("user_annotation", COMPRESS, 400, 100),
        _ev("cuda_runtime", "cudaLaunchKernel", 410, 5, corr=3),
        _ev("cpu_op", "aten::item", 600, 300),
        _ev("cpu_op", "autograd_op", 380, 40, tid=2),
        _ev("kernel", "conv", 100, 200, tid=7, corr=1),
        _ev("kernel", "bn", 250, 100, tid=7, corr=2),      # overlaps conv
        _ev("kernel", "B1", 450, 50, tid=7, corr=3),
        _ev("gpu_memcpy", "copy", 950, 100, tid=8, corr=9),  # past the end
    ]
    s = trace.summarize(events, WINDOW, (FWD_BWD, COMPRESS))
    assert s.window_s == pytest.approx(1e-3)
    # busy: [100, 350] + [450, 500] + [950, 1000]
    assert s.busy_s == pytest.approx(350e-6)
    assert s.range_s[FWD_BWD] == pytest.approx(300e-6)
    assert s.range_s[COMPRESS] == pytest.approx(50e-6)
    assert s.device_ops[0] == ("conv", pytest.approx(200e-6))
    gaps = dict(s.idle_gaps)
    # [0, 100] and [350, 450] and [500, 950]
    assert gaps["aten::item"] == pytest.approx(450e-6)
    assert gaps[f"{COMPRESS} > [other thread] autograd_op"] == pytest.approx(
        100e-6)
    assert sum(gaps.values()) == pytest.approx(650e-6)
    assert trace.summarize(events, "absent", (FWD_BWD,)) is None


def test_by_leaf_numbers_mask_the_entries_one_side_sent():
    from gkbench import check
    from gkbench.reference import sgd
    layout = [("A/kernel", (4,)), ("B/bias", (2,)), ("C/kernel", (4,))]
    hyper = sgd.Hyper(lr=0.1, momentum=0.9, weight_decay=0.0, density=0.3,
                      workers=1, warmup_epochs=0.0, steps_per_epoch=1,
                      total_steps=10, milestones=(), lr_decay=0.1)
    p0 = torch.ones(10)
    grad = torch.tensor([4.0, 3, 2, 1, 0.5, 0.25, 1, 1, 1, 1])

    def steps(sent):
        m = torch.zeros(10)
        m[sent] = grad[sent]
        res = grad.clone()
        res[sent] = 0.0
        return sgd.Steps([1.0], m, res, grad, p0 - 0.1 * m)
    # the program sends B's first entry where the reference sends A's third
    prog, ref = steps([0, 1, 4]), steps([0, 1, 2])
    got = check.numbers(prog, ref, p0, layout, hyper)
    assert got["flip_share"][0] == pytest.approx(2 / 3)
    raw = dict((leaf, g) for g, leaf in check.leaf_gaps(
        prog.momentum1, ref.momentum1, layout))
    assert raw["B/bias"] > 0.1
    # masked, both sides hold the same entries: every leaf agrees
    assert got["grad_leaf_gap"][0] == 0.0
    assert got["residual_leaf_gap"][0] == 0.0
    assert got["update_leaf_gap"][0] == 0.0
    # a value off by a tenth on an entry both sent shows through the mask
    prog.momentum1[0] *= 1.1
    got = check.numbers(prog, ref, p0, layout, hyper, ["grad_leaf_gap"])
    assert set(got) == {"grad_leaf_gap"}
    # A: ||(4.4, 3)|| against ||(4, 3)|| = 5, the largest leaf norm
    assert got["grad_leaf_gap"] == (
        pytest.approx((4.4 ** 2 + 9) ** 0.5 / 5 - 1), "A/kernel")
