"""Parity of the port's AN4 data path (``data/audio.py``,
``data/__init__.py:make_an4``, ``data/loader.py:BucketedDataset``) with
the reference's, on wav fixtures written to ``tmp_path``.

Both packages take the threaded C++ featurizer of the native host
pipeline when it loads, and numpy otherwise (the two within f32 rounding of
each other, ``tests/test_native_io.py``). So features are held bit for bit
against the reference with both native paths turned off, and bit for bit
against the reference as it runs, with both on. Everything else is held
bit for bit: wav bytes, labels, buckets, batches, and the epoch stream over
two epochs and a resume.
"""

import os

import numpy as np
import pytest

from gaussiank_sgd_tpu.data import make_an4 as jmake_an4
from gaussiank_sgd_tpu.data import native as jnative
from gaussiank_sgd_tpu.data.audio import (decode_labels as jdecode,
                                          encode_transcript as jencode,
                                          featurize_manifest as
                                          jfeaturize_manifest,
                                          log_spectrogram as jlog_spectrogram,
                                          quantize_width as jquantize,
                                          read_wav as jread_wav,
                                          resample_to_16k as jresample,
                                          write_wav as jwrite_wav)
from gaussiank_sgd_tpu.data.loader import EpochStream as JEpochStream
from gaussiank_sgd_torch import data
from gaussiank_sgd_torch.data import audio, native
from gaussiank_sgd_torch.data.loader import EpochStream
from test_torch_native_io import both_native_libraries


@pytest.fixture
def numpy_reference(monkeypatch):
    """Both packages' featurizers on their numpy paths."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)


def _tone(seconds, freq=440.0, rate=audio.SAMPLE_RATE, seed=0):
    t = np.arange(int(seconds * rate)) / rate
    rng = np.random.default_rng(seed)
    return (0.5 * np.sin(2 * np.pi * freq * t)
            + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def _an4_dir(root, n, split="train", seed=1):
    """``n`` tone wavs (0.3 to 3 s: frame widths from 29 to 299, so the
    100/200/400 buckets) with transcripts, and the split's manifest."""
    rng = np.random.default_rng(seed)
    os.makedirs(root / "wav", exist_ok=True)
    os.makedirs(root / "txt", exist_ok=True)
    rows = []
    for i in range(n):
        wav, txt = f"wav/{split}{i}.wav", f"txt/{split}{i}.txt"
        audio.write_wav(str(root / wav), _tone(float(rng.uniform(0.3, 3.0)),
                                               200 + 50 * i, seed=i))
        (root / txt).write_text(f"Hello, World {i}! " + "abc'd" * (i % 3))
        rows.append(f"{wav},{txt}")
    (root / f"an4_{split}_manifest.csv").write_text("\n".join(rows))
    return root


def _same_batches(a, b):
    for (x, y), (jx, jy) in zip(a, b, strict=True):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        assert x.dtype == jx.dtype and y.dtype == jy.dtype


@pytest.mark.parametrize("seconds,rate", [(1.0, 16000), (0.5, 44100),
                                          (0.01, 16000)])
def test_log_spectrogram_is_the_references(numpy_reference, seconds, rate):
    """Bit for bit against the reference's numpy path: 16 kHz, a 44.1 kHz
    input resampled, and a clip shorter than one window (zero-padded)."""
    x = _tone(seconds, rate=rate)
    feat = audio.log_spectrogram(x, rate)
    np.testing.assert_array_equal(feat, jlog_spectrogram(x, rate))
    np.testing.assert_array_equal(audio.resample_to_16k(x, rate),
                                  jresample(x, rate))
    assert feat.dtype == np.float32 and feat.shape[0] == audio.N_FREQ
    raw = audio.log_spectrogram(x, rate, normalize=False)
    np.testing.assert_array_equal(raw, jlog_spectrogram(x, rate,
                                                        normalize=False))


def test_log_spectrogram_against_the_native_path():
    """Against the reference as it runs here: both take the C++ featurizer
    when it loads, so the raw and the normalised features are equal bit for
    bit."""
    both_native_libraries()
    x = _tone(1.0, 523, seed=3)
    np.testing.assert_array_equal(audio.log_spectrogram(x, normalize=False),
                                  jlog_spectrogram(x, normalize=False))
    np.testing.assert_array_equal(audio.log_spectrogram(x),
                                  jlog_spectrogram(x))


def test_wav_bytes_and_labels(tmp_path):
    """``write_wav`` writes the reference's bytes, ``read_wav`` reads what
    the reference reads; transcripts encode and decode alike (punctuation
    and the blank character dropped); ``quantize_width`` alike."""
    x = _tone(0.7, seed=5)
    write_wav_paths = (tmp_path / "a.wav", tmp_path / "b.wav")
    audio.write_wav(str(write_wav_paths[0]), x)
    jwrite_wav(str(write_wav_paths[1]), x)
    assert (write_wav_paths[0].read_bytes()
            == write_wav_paths[1].read_bytes())
    (got, rate), (want, jrate) = (audio.read_wav(str(write_wav_paths[0])),
                                  jread_wav(str(write_wav_paths[0])))
    np.testing.assert_array_equal(got, want)
    assert rate == jrate == audio.SAMPLE_RATE
    for text in ("Hello, World!", "it's _under_ 9 o'clock", ""):
        ids = audio.encode_transcript(text)
        np.testing.assert_array_equal(ids, jencode(text))
        assert ids.dtype == np.int32 and (ids > 0).all()
        assert audio.decode_labels(ids) == jdecode(ids)
    assert audio.decode_labels([0, 3, 28, 29, 1]) == jdecode([0, 3, 28, 29,
                                                              1]) == "b '"
    assert audio.NUM_LABELS == 29 and audio.LABELS[0] == "_"
    for t in (1, 100, 101, 399, 800, 5000):
        assert (audio.quantize_width(t, (100, 200, 400, 800))
                == jquantize(t, (100, 200, 400, 800)))


def test_featurize_manifest_is_the_references(tmp_path, numpy_reference):
    """Buckets (widths, features padded or cut, labels padded to
    ``tgt_len``) bit for bit, at the default ``tgt_len`` and a short one
    that cuts transcripts."""
    d = _an4_dir(tmp_path, 12)
    manifest = str(d / "an4_train_manifest.csv")
    for kw in (dict(), dict(widths=(100, 200), tgt_len=8)):
        got = audio.featurize_manifest(manifest, **kw)
        want = jfeaturize_manifest(manifest, **kw)
        assert [x.shape for x, _ in got] == [x.shape for x, _ in want]
        _same_batches(got, want)
    assert len(got) == 2 and got[1][0].shape[2] == 200


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("batch_size,pools", [
    (4, [(8, 100), (12, 200), (10, 400)]),
    (11, [(8 + 12 + 10, 400)])])
def test_make_an4_real_data_path(tmp_path, numpy_reference, train,
                                 batch_size, pools):
    """A ``BucketedDataset`` over the manifest's buckets (8, 12 and 10
    utterances at widths 100, 200 and 400), as the reference builds it: at
    batch 4 one pool a bucket; at batch 11 the 8 fold into the 200 bucket
    and the 10 left over into that pool, padded to 400. The pools' shapes,
    and an epoch's batches at two epoch seeds, bit for bit."""
    d = _an4_dir(tmp_path, 30, "train" if train else "val", seed=2)
    ds, card = data.make_an4(str(d), train=train, batch_size=batch_size)
    jds, jcard = jmake_an4(str(d), train=train, batch_size=batch_size)
    assert card == jcard == 29
    assert isinstance(ds, data.BucketedDataset)
    assert [p.x.shape for p in ds.pools] == [p.arrays[0].shape
                                            for p in jds.pools]
    assert [(p.num_examples, p.x.shape[2]) for p in ds.pools] == pools
    assert ds.steps_per_epoch == jds.steps_per_epoch
    assert ds.num_examples == jds.num_examples == 30
    for seed in (0, 7):
        _same_batches(ds.epoch(epoch_seed=seed), jds.epoch(epoch_seed=seed))


def test_an4_errors_like_the_reference(tmp_path, numpy_reference):
    """A directory with the train manifest but not the val one raises for
    the val split; a manifest with fewer usable examples than a batch
    raises."""
    d = _an4_dir(tmp_path, 3)
    for make in (data.make_an4, jmake_an4):
        with pytest.raises(FileNotFoundError, match="an4_val_manifest"):
            make(str(d), train=False, batch_size=2)
        with pytest.raises(ValueError, match="fewer than batch_size=4"):
            make(str(d), train=True, batch_size=4)


def test_make_an4_synthetic_fallback(tmp_path):
    """The synthetic spectrograms bit for bit, at the defaults (161 x 200,
    8 labels, 256 examples) and shrunk, for both splits; an empty
    directory and ``data_dir=None`` fall back alike."""
    for kw in (dict(), dict(freq=41, time=24, num_labels=9, tgt_len=4,
                            synthetic_examples=32)):
        for train in (True, False):
            ds, card = data.make_an4(str(tmp_path), train=train,
                                     batch_size=16, **kw)
            jds, jcard = jmake_an4(None, train=train, batch_size=16, **kw)
            assert card == jcard == kw.get("num_labels", 29)
            np.testing.assert_array_equal(ds.x, jds.arrays[0])
            np.testing.assert_array_equal(ds.y, jds.arrays[1])
            _same_batches(ds.epoch(epoch_seed=3), jds.epoch(epoch_seed=3))
    assert ds.x.shape == (32, 41, 24)
    full, _ = data.make_dataset("an4", batch_size=32)
    assert full.x.shape == (256, 161, 200) and full.y.shape == (256, 8)
    assert full.steps_per_epoch == 8


def test_bucketed_stream_and_resume(tmp_path, numpy_reference):
    """``EpochStream`` over the bucketed dataset, batch for batch against
    the reference's over two epochs, and a stream built at a step inside
    the second epoch (a resume) against the uninterrupted one."""
    d = _an4_dir(tmp_path, 26, seed=3)
    ds, _ = data.make_an4(str(d), batch_size=4)
    jds, _ = jmake_an4(str(d), batch_size=4)
    n = 2 * ds.steps_per_epoch
    stream, jstream = EpochStream(ds, 42), JEpochStream(jds, 42)
    run = [next(stream) for _ in range(n)]
    _same_batches(run, [next(jstream) for _ in range(n)])
    start = ds.steps_per_epoch + 2
    resumed = EpochStream(ds, 42, start_step=start)
    _same_batches([next(resumed) for _ in range(n - start)], run[start:])
