"""The port's binding of the native host pipeline (``data/native.py``),
its ``CifarPipeline`` and ``make_cifar`` (``data/cifar.py``) against the
reference's, on the same numpy-seeded inputs.

Both packages build ``native/io_pipeline.cpp`` with the same g++ flags,
each into its own directory, so every entry point is held bit for bit:
``assemble_batch`` (gather, normalise, crop and flip) at several seeds and
thread counts, ``shuffle_indices`` and ``log_spectrogram``. CIFAR-10 binary
files the test writes then give the same batches through ``EpochStream``
in both packages, with and without ``label_noise``, on the native pipeline
and on the numpy path, from step 0 and from a step inside the second
epoch.
"""

import logging
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from gaussiank_sgd_tpu.data import make_dataset as jmake_dataset
from gaussiank_sgd_tpu.data import native as jnative
from gaussiank_sgd_tpu.data.cifar import CifarPipeline as JCifarPipeline
from gaussiank_sgd_tpu.data.loader import EpochStream as JEpochStream
from gaussiank_sgd_torch.data import EpochStream, make_dataset, native
from gaussiank_sgd_torch.data.cifar import CifarPipeline
from gaussiank_sgd_torch.data.loader import ArrayDataset

MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
STD = np.array([0.2470, 0.2435, 0.2616], np.float32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _images(n, seed, h=32, w=32):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8),
            rng.integers(0, 10, size=n).astype(np.int32))


def write_cifar10(root, n_train: int, n_test: int, seed: int = 0):
    """CIFAR-10's binary layout (a label byte, then 3 x 32 x 32 pixels,
    channel-major) in ``data_batch_1..5.bin`` of ``n_train`` records each
    and ``test_batch.bin`` of ``n_test``."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "cifar-10-batches-bin")
    os.makedirs(d, exist_ok=True)
    names = [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]
    for name in names:
        n = n_test if name.startswith("test") else n_train
        recs = np.empty((n, 3073), np.uint8)
        recs[:, 0] = rng.integers(0, 10, n)
        recs[:, 1:] = rng.integers(0, 256, (n, 3072))
        recs.tofile(os.path.join(d, name))
    return root


def both_native_libraries(wait_s: float = 60.0) -> None:
    """Fail, with the reason, unless the port's library and the
    reference's both loaded: a test that holds the port's native path to
    the reference's must not compare a native run with a numpy one.

    The reference's loader gives up for the whole process on one failed
    load, and the reference builds its library in place (g++ writes the
    library's own path), which its own stale-library test does while other
    workers of the suite may be loading it: a load that meets the
    half-written file fails. That load is tried again, for up to
    ``wait_s``, once the in-place build has had time to end."""
    if not native.available():
        pytest.fail(f"the port's native library did not load: "
                    f"{native.load_error()}")
    deadline = time.monotonic() + wait_s
    while not jnative.available():
        if time.monotonic() > deadline:
            pytest.fail(f"the reference's native library did not load "
                        f"from {jnative._LIB_PATH} within {wait_s} s")
        time.sleep(0.5)
        with jnative._lock:
            jnative._lib, jnative._tried = None, False


def test_the_library_builds_into_the_port_and_binds():
    """g++ builds the library into ``gaussiank_sgd_torch/build/`` (not the
    reference's ``native/build/``), and every entry point is declared."""
    assert native.available() and jnative.available()
    lib = native.load()
    assert native._LIB_PATH == os.path.join(
        REPO, "gaussiank_sgd_torch", "build", "libgksgd_io.so")
    assert os.path.exists(native._LIB_PATH)
    for fn in ("gk_assemble_batch", "gk_shuffle_indices",
               "gk_log_spectrogram"):
        assert getattr(lib, fn).restype is None


@pytest.mark.parametrize("augment,seed,nthreads", [
    (False, 1, 4), (True, 99, 4), (True, 2 ** 64 + 5, 1), (True, 7, 8)])
def test_assemble_batch_is_the_references(augment, seed, nthreads):
    x, y = _images(64, 0)
    sel = np.asarray([3, 1, 60, 7, 7, 0, 63, 12], np.int32)
    got = native.assemble_batch(x, y, sel, MEAN, STD, seed=seed,
                                augment=augment, nthreads=nthreads)
    want = jnative.assemble_batch(x, y, sel, MEAN, STD, seed=seed,
                                  augment=augment, nthreads=nthreads)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], y[sel])


def test_assemble_batch_rejects_bad_input():
    x, y = _images(4, 1)
    with pytest.raises(IndexError, match="outside the dataset"):
        native.assemble_batch(x, y, np.asarray([0, 4]), MEAN, STD, 0, False)
    with pytest.raises(ValueError, match="u8"):
        native.assemble_batch(x.astype(np.float32), y, np.asarray([0]),
                              MEAN, STD, 0, False)


@pytest.mark.parametrize("n,seed", [(1, 0), (1000, 7), (50_000, 42 * 1_000_003
                                                         + 3)])
def test_shuffle_indices_is_the_references(n, seed):
    idx = native.shuffle_indices(n, seed)
    np.testing.assert_array_equal(idx, jnative.shuffle_indices(n, seed))
    assert idx.dtype == np.int32 and sorted(idx.tolist()) == list(range(n))


@pytest.mark.parametrize("n,stride,nthreads", [(320, 160, 4),
                                               (16000, 160, 4),
                                               (48000, 160, 1)])
def test_log_spectrogram_is_the_references(n, stride, nthreads):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    got = native.log_spectrogram(x, 320, stride, nthreads)
    np.testing.assert_array_equal(
        got, jnative.log_spectrogram(x, 320, stride, nthreads))
    assert got.shape == (161, 1 + (n - 320) // stride)
    with pytest.raises(ValueError, match="n_fft"):
        native.log_spectrogram(x[:100], 320, stride)


def _same_stream(ds, jds, seed, start, n):
    a, b = EpochStream(ds, seed, start), JEpochStream(jds, seed, start)
    for _ in range(n):
        (x, y), (jx, jy) = next(a), next(b)
        assert x.dtype == jx.dtype and y.dtype == jy.dtype
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("label_noise", [0.0, 0.1])
@pytest.mark.parametrize("train", [True, False])
def test_make_cifar_on_files_is_the_references(tmp_path, use_native,
                                               label_noise, train):
    """CIFAR-10 files of 96 records a train file and 64 test records: the
    train split through the native pipeline (or ``ArrayDataset`` with the
    numpy augmentation) and the test split unaugmented, in both packages,
    give the same batches over 1.5 epochs from step 0 and from step 11
    (inside the second epoch), with ``label_noise`` 0 and 0.1."""
    write_cifar10(tmp_path, 96, 64)
    if use_native:
        both_native_libraries()
    kw = dict(train=train, batch_size=32, use_native=use_native,
              label_noise=label_noise)
    ds, card = make_dataset("cifar10", str(tmp_path), **kw)
    jds, jcard = jmake_dataset("cifar10", str(tmp_path), **kw)
    assert card == jcard == 10
    assert isinstance(ds, CifarPipeline if use_native else ArrayDataset)
    assert isinstance(jds, JCifarPipeline) == use_native
    assert ds.steps_per_epoch == jds.steps_per_epoch == (15 if train else 2)
    _same_stream(ds, jds, 42, 0, 3 * ds.steps_per_epoch // 2)
    if use_native or not train:
        # the native pipeline's draws depend on the batch's place only;
        # the numpy augmentation's one generator restarts with the dataset
        ds, _ = make_dataset("cifar10", str(tmp_path), **kw)
        jds, _ = jmake_dataset("cifar10", str(tmp_path), **kw)
        start = ds.steps_per_epoch + 2 if train else 1
        _same_stream(ds, jds, 42, start, 4)


def test_label_noise_flips_the_references_labels(tmp_path):
    """``label_noise`` flips the same labels in both packages, on both
    splits: about that fraction of them, none on the noise-free run; on the
    synthetic fallback too (where the port refused the key before)."""
    write_cifar10(tmp_path, 200, 200)
    for data_dir in (str(tmp_path), None):
        for train in (True, False):
            labels = {}
            for noise in (0.0, 0.1):
                kw = dict(train=train, batch_size=50, label_noise=noise,
                          augment=False)
                ds, _ = make_dataset("cifar10", data_dir, **kw)
                jds, _ = jmake_dataset("cifar10", data_dir, **kw)
                y = ds.y if hasattr(ds, "y") else None
                jy = jds.y if data_dir else jds.arrays[1]
                np.testing.assert_array_equal(y, jy)
                labels[noise] = y
            flipped = float(np.mean(labels[0.0] != labels[0.1]))
            assert 0.04 < flipped < 0.16, flipped


def test_concurrent_builds_each_install_a_whole_library(tmp_path,
                                                        monkeypatch):
    """Two builds at once (the test suite's workers may race) each write a
    private file and move it into place: the library loads afterwards and
    no temporary file is left."""
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "lib.so"))
    ok = []
    threads = [threading.Thread(target=lambda: ok.append(native._build()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert ok == [True, True] and not any(t.is_alive() for t in threads)
    assert os.listdir(tmp_path) == ["lib.so"]
    lib = native._bind(__import__("ctypes").CDLL(str(tmp_path / "lib.so")))
    idx = np.empty(10, np.int32)
    lib.gk_shuffle_indices(idx, 10, 3)
    np.testing.assert_array_equal(idx, jnative.shuffle_indices(10, 3))


def test_stale_library_rebuilds(tmp_path, monkeypatch):
    """A library older than the source is rebuilt by ``load``."""
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native._build()
    src = native._SRC
    os.utime(native._LIB_PATH, (os.path.getmtime(src) - 100,
                                os.path.getmtime(src) - 100))
    assert native._stale()
    assert native.load() is not None
    assert os.path.getmtime(native._LIB_PATH) >= os.path.getmtime(src)


def test_import_builds_nothing(tmp_path):
    """Importing the module starts no build: the library appears at the
    first ``load``."""
    code = ("import sys; sys.path.insert(0, %r); "
            "from gaussiank_sgd_torch.data import native; "
            "print(native._lib is None and not native._tried)" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=str(tmp_path))
    assert out.stdout.strip() == "True"


def _fake_gxx(tmp_path, body: str) -> str:
    """A directory whose ``g++`` runs ``body`` (a shell script), to put
    first on ``PATH``."""
    d = tmp_path / "bin"
    d.mkdir()
    gxx = d / "g++"
    gxx.write_text("#!/bin/sh\n" + body + "\n")
    gxx.chmod(0o755)
    return str(d)


def test_a_failed_build_reads_as_such(tmp_path, monkeypatch, caplog):
    """With a g++ that fails: ``load`` returns None, ``load_error`` names
    g++'s exit and message, ``make_cifar`` on files warns that it takes the
    numpy path and why, and ``both_native_libraries`` fails with that
    reason rather than letting a comparison run on two data paths."""
    monkeypatch.setenv("PATH", _fake_gxx(tmp_path, "echo no compiler >&2; "
                                         "exit 3") + os.pathsep
                       + os.environ["PATH"])
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_error", None)
    assert native.load() is None and not native.available()
    assert "g++ exited 3" in native.load_error()
    assert "no compiler" in native.load_error()
    write_cifar10(tmp_path / "data", 32, 32)
    with caplog.at_level(logging.WARNING):
        ds, _ = make_dataset("cifar10", str(tmp_path / "data"), train=True,
                             batch_size=8)
    assert isinstance(ds, ArrayDataset)
    assert "numpy path" in caplog.text and "g++ exited 3" in caplog.text
    with pytest.raises(pytest.fail.Exception, match="g\\+\\+ exited 3"):
        both_native_libraries()
    assert not os.path.exists(native._LIB_PATH)


def test_concurrent_loads_wait_for_one_build(tmp_path, monkeypatch):
    """Two threads that find no library build it once between them: the
    second waits on the build lock and finds the first one's library."""
    log = tmp_path / "gxx.log"
    real = subprocess.run(["sh", "-c", "command -v g++"], text=True,
                          capture_output=True, check=True).stdout.strip()
    monkeypatch.setenv("PATH", _fake_gxx(
        tmp_path, f'echo run >> "{log}"; exec "{real}" "$@"') + os.pathsep
        + os.environ["PATH"])
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "lib.so"))
    ok = []
    threads = [threading.Thread(target=lambda: ok.append(
        native._build_locked())) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert ok == [True, True]
    assert log.read_text().split() == ["run"]
    assert sorted(os.listdir(tmp_path)) == ["bin", "gxx.log", "lib.lock",
                                            "lib.so"]
