"""The port's bench harness (``gaussiank_sgd_torch/benchlib.py``) against
the reference's ``gaussiank_sgd_tpu/benchlib.py``.

* ``paired_delta_ms`` and ``noise_floored_delta_ms`` equal the
  reference's on the same round dicts, over generated round lists
  (hypothesis; mismatched lengths and empty lists included) and the
  reference's own cases (``tests/test_bench_harness.py``).
* ``_time_programs`` visits the programs in the reference's rotated order
  and returns its min, round and window samples (a stub clock in both).
* ``ef_only`` is bitwise the reference's; ``sel_nores`` sends the same
  bf16 magnitudes and leaves the residual alone (its top-k is the exact
  one, whose order among ties is the port's own).
* ``make_batch`` gives each task's shapes, dtypes and ranges as the
  reference's does.
* ``mfu``'s None paths; ``device_peak_flops`` is None on the CPU and
  resolves card names longest prefix first.
* ``program_flops`` is ``2 M N K`` on a matmul, the analytic count on a
  convolution, and the reference's count on a matmul-only program.
* ``bench_model`` and ``bench_overlap`` run on the CPU (when asked) on a
  narrow VGG, 2 steps and 2 rounds, with the reference's keys; without
  ``device`` they want the card and refuse to fall back.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

from gaussiank_sgd_tpu import benchlib as jbench
from gaussiank_sgd_torch import benchlib

NARROW = [8, "M", 8, "M", 16, "M", 16, "M", 16, "M"]

_rounds = st.lists(st.floats(min_value=0.0, max_value=1.0,
                             allow_nan=False), max_size=9)


@settings(max_examples=300, deadline=None)
@given(_rounds, _rounds)
def test_paired_statistics_equal_the_references(a, b):
    rounds = {"a": a, "b": b}
    for fn in ("paired_delta_ms", "noise_floored_delta_ms"):
        for x, y in (("a", "b"), ("b", "a"), ("a", "missing")):
            assert (getattr(benchlib, fn)(rounds, x, y)
                    == getattr(jbench, fn)(rounds, x, y)), (fn, x, y)


@pytest.mark.parametrize("rounds,floored", [
    ({"a": [0.012, 0.0121, 0.0119], "b": [0.010, 0.0101, 0.0099]}, True),
    ({"a": [0.010, 0.0099, 0.0101], "b": [0.011, 0.0111, 0.0109]}, False),
    ({"a": [0.0101, 0.0095, 0.0107], "b": [0.0100, 0.0100, 0.0100]}, False),
    ({"a": [0.012, 0.012], "b": [0.010]}, False),
])
def test_noise_floor_cases_of_the_reference(rounds, floored):
    """The reference's cases: a clear delta is reported as the paired
    median; a negative one, one inside the rounds' jitter and a partial
    run are None."""
    got = benchlib.noise_floored_delta_ms(rounds, "a", "b")
    assert got == jbench.noise_floored_delta_ms(rounds, "a", "b")
    assert (got is not None) == floored
    if floored:
        assert got == benchlib.paired_delta_ms(rounds, "a", "b") > 0


@pytest.mark.parametrize("n_programs,rounds,windows", [(2, 3, 1), (4, 4, 2),
                                                       (3, 2, 3)])
def test_time_programs_rotates_as_the_reference(monkeypatch, n_programs,
                                                rounds, windows):
    """A stub clock (each call returns its sequence number) through both
    ``_time_programs``: the same visiting order, mins, round and window
    samples."""
    results = []
    for mod in (benchlib, jbench):
        seen = []

        def stub(fn, mk, batch, n_steps, seen=seen):
            seen.append(fn)
            return 1.0 + len(seen) * 0.25
        monkeypatch.setattr(mod, "_run_once", stub)
        programs = {f"p{i}": (f"p{i}", None) for i in range(n_programs)}
        out = mod._time_programs(programs, None, 10, rounds, windows)
        results.append((seen, out))
    (seen, out), (jseen, jout) = results
    assert seen == jseen and out == jout
    assert seen[:n_programs] == [f"p{i}" for i in range(n_programs)]
    assert seen[n_programs] == "p1"                    # rotated by one


def test_ablation_specs_match_the_references():
    rng = np.random.default_rng(0)
    acc = rng.normal(size=5000).astype(np.float32)
    acc[::7] = np.float32(0.5)                  # bf16 magnitude ties
    k = 60
    specs, jspecs = benchlib.ablation_specs(), jbench.ablation_specs()
    assert set(specs) == set(jspecs) == {"ef_only", "sel_nores"}
    r = specs["ef_only"].fn(torch.from_numpy(acc), k)
    jr = jspecs["ef_only"].fn(jnp.asarray(acc), k)
    for a, b in ((r.compressed.indices, jr.compressed.indices),
                 (r.compressed.values, jr.compressed.values),
                 (r.residual, jr.residual), (r.num_selected,
                                             jr.num_selected)):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      np.asarray(b).view(np.int32))
    r = specs["sel_nores"].fn(torch.from_numpy(acc), k)
    jr = jspecs["sel_nores"].fn(jnp.asarray(acc), k)

    def bf16_mags(v):
        return np.sort(np.abs(np.asarray(v)).astype(jnp.bfloat16)
                       .astype(np.float32))
    np.testing.assert_array_equal(bf16_mags(r.compressed.values),
                                  bf16_mags(jr.compressed.values))
    np.testing.assert_array_equal(acc[r.compressed.indices.numpy()],
                                  r.compressed.values.numpy())
    np.testing.assert_array_equal(r.residual.numpy(), np.asarray(jr.residual))
    assert int(r.num_selected) == int(jr.num_selected) == k
    for name in specs:
        assert (specs[name].requires_rng, specs[name].uses_error_feedback,
                specs[name].out_k(9)) == (jspecs[name].requires_rng,
                                          jspecs[name].uses_error_feedback,
                                          jspecs[name].out_k(9))


class _Spec(NamedTuple):
    task: str
    input_shape: tuple
    num_classes: int


@pytest.mark.parametrize("spec", [
    _Spec("classify", (32, 32, 3), 10), _Spec("lm", (35,), 50),
    _Spec("seq2seq", (12,), 40), _Spec("ctc", (41, 30), 29)])
def test_make_batch_shapes_dtypes_and_ranges(spec):
    x, y = benchlib.make_batch(spec, 64, torch.Generator().manual_seed(3))
    jx, jy = jbench.make_batch(spec, 64)
    assert tuple(x.shape) == jx.shape and tuple(y.shape) == jy.shape
    assert str(x.dtype).split(".")[-1] == str(jx.dtype)
    assert str(y.dtype).split(".")[-1] == str(jy.dtype)
    for t, jt, lo in ((x, jx, int(spec.task == "seq2seq")),
                      (y, jy, int(spec.task in ("seq2seq", "ctc")))):
        if t.dtype == torch.int32:
            jt = np.asarray(jt)
            assert int(t.min()) == int(jt.min()) == lo
            assert int(t.max()) == int(jt.max()) == spec.num_classes - 1
        else:
            assert abs(float(t.mean())) < 0.1 and 0.9 < float(t.std()) < 1.1
    again = benchlib.make_batch(spec, 64, torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip((x, y), again))


def test_mfu_and_peak_flops(monkeypatch):
    assert benchlib.mfu(None, 0.01, 1e12) is None
    assert benchlib.mfu(1e9, 0.01, None) is None
    assert benchlib.mfu(1e9, 0.0, 1e12) is None
    assert benchlib.mfu(1e12, 0.01, 989.4e12) == jbench.mfu(
        1e12, 0.01, 989.4e12)
    assert benchlib.device_peak_flops("cpu") is None
    if not torch.cuda.is_available():
        assert benchlib.device_peak_flops() is None
    names = {"NVIDIA H100 80GB HBM3": 989.4e12,
             "NVIDIA H100 PCIe": 756.5e12, "NVIDIA H100 NVL": 835.5e12,
             "NVIDIA A100-SXM4-80GB": None}
    for name, peak in names.items():
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d=None, name=name: name)
        assert benchlib.device_peak_flops("cuda") == peak, name


def test_program_flops_counts_matmuls_and_convolutions():
    m, k, n = 256, 128, 64
    a, b = torch.zeros(m, k), torch.zeros(k, n)
    assert benchlib.program_flops(torch.matmul, a, b) == 2 * m * k * n
    assert benchlib.program_flops(torch.matmul, a, b) == jbench.program_flops(
        jax.jit(jnp.matmul), jnp.zeros((m, k)), jnp.zeros((k, n)))
    c = torch.zeros(n, 16)

    def chain(a, b, c):
        return torch.tanh(a @ b) @ c
    assert benchlib.program_flops(chain, a, b, c) == jbench.program_flops(
        jax.jit(lambda a, b, c: jnp.tanh(a @ b) @ c), jnp.zeros((m, k)),
        jnp.zeros((k, n)), jnp.zeros((n, 16)))
    x, w = torch.zeros(2, 3, 16, 16), torch.zeros(8, 3, 3, 3)
    out = 2 * 8 * 16 * 16                        # batch, Cout, H, W
    assert benchlib.program_flops(lambda x, w: F.conv2d(x, w, padding=1),
                                  x, w) == 2 * out * 3 * 3 * 3
    assert benchlib.program_flops(torch.add, a, a) is None


_BENCH_KW = dict(model_kwargs={"cfg": NARROW, "dropout": 0.0},
                 dtype=torch.float32)


def test_bench_model_runs_on_the_cpu_with_the_references_keys():
    out = benchlib.bench_model("vgg16", "cifar10", 4, 0.01,
                               ["gaussian_fused", "ef_only"], 2, rounds=2,
                               device="cpu", **_BENCH_KW)
    timed = ["dense", "gaussian_fused", "ef_only"]
    assert set(out) == set(timed) | {"_rounds", "_windows", "_exchange",
                                     "_dense_step_flops", "_peak_flops"}
    for name in timed:
        assert out[name] > 0 and len(out["_rounds"][name]) == 2
        assert out[name] == min(out["_rounds"][name])
        assert out["_windows"][name] == [out["_rounds"][name]]
    ex = out["_exchange"]
    assert set(ex) == {"gaussian_fused", "ef_only"}
    for meta in ex.values():
        assert set(meta) == {"wire_format", "overlap", "total_k",
                             "bytes_sent"}
        per_entry = 4 if meta["wire_format"] == "u16bf16" else 8
        assert meta["bytes_sent"] == meta["total_k"] * per_entry
    assert out["_dense_step_flops"] > 0 and out["_peak_flops"] is None


def test_bench_overlap_runs_on_the_cpu_with_the_references_keys():
    out = benchlib.bench_overlap("vgg16", "cifar10", 4, 0.01,
                                 "gaussian_fused", 2, rounds=2,
                                 bucket_size=4096, device="cpu", **_BENCH_KW)
    programs = ["seq", "seq_noexch", "pipe", "pipe_noexch"]
    assert set(out) == set(programs) | {"_rounds", "_windows", "_meta",
                                        "exposed_exchange_ms"}
    meta = out["_meta"]
    assert (meta["seq_overlap"], meta["pipe_overlap"]) == ("off",
                                                           "pipelined")
    assert meta["wire_format"] == "u16bf16"
    assert meta["seq_bytes_sent"] == meta["pipe_bytes_sent"] == (
        meta["total_k"] * 4)
    k = meta["total_k"] // meta["n_buckets"]
    assert meta["overlapped_bytes_sent"] == (meta["n_buckets"] - 1) * k * 4
    assert set(out["exposed_exchange_ms"]) == {"seq", "pipe"}
    for name in programs:
        assert out[name] > 0 and len(out["_rounds"][name]) == 2


def test_bench_wants_the_card_by_default(monkeypatch):
    """Without ``device`` the bench runs on the card; with none it raises
    rather than time the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchlib.bench_overlap("vgg16", "cifar10", 4, 0.01,
                               "gaussian_fused", 2, **_BENCH_KW)
