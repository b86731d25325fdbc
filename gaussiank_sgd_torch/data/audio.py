"""AN4 speech featurization: wav -> log-spectrogram + character labels
(port of ``gaussiank_sgd_tpu/data/audio.py``).

DeepSpeech manifest CSVs of ``wav_path,transcript_path`` rows; 16 kHz
waveforms framed into 20 ms Hamming windows at a 10 ms stride; log1p of
the |rFFT| magnitude (161 bins at n_fft = 320), normalised per utterance
to zero mean and unit variance; a character label set with the CTC blank
at index 0. Utterances are padded to a few fixed frame widths (length
buckets, ``featurize_manifest``), so each batch has one of a few shapes.

The features come from the threaded C++ featurizer of the native host
pipeline (``data/native.py``) when that library loads, else from numpy
(within f32 rounding of it), the reference's rule: either way the port's
features are the reference's bit for bit.
"""

from __future__ import annotations

import csv
import os
import wave
from typing import List, Sequence, Tuple

import numpy as np

# DeepSpeech's label set: CTC blank '_' at 0, then alphabet; 29 labels.
LABELS = "_'abcdefghijklmnopqrstuvwxyz "
_CHAR_TO_ID = {c: i for i, c in enumerate(LABELS)}
NUM_LABELS = len(LABELS)  # 29

SAMPLE_RATE = 16000
WINDOW_MS = 20.0
STRIDE_MS = 10.0
N_FFT = int(SAMPLE_RATE * WINDOW_MS / 1000)        # 320
N_FREQ = N_FFT // 2 + 1                            # 161 bins


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Load a mono PCM wav via stdlib ``wave`` -> (float32 in [-1,1], rate)."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        raw = w.readframes(n)
        channels = w.getnchannels()
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, rate


def resample_to_16k(samples: np.ndarray, rate: int) -> np.ndarray:
    """Linear-interpolation resample to the canonical 16 kHz."""
    if rate == SAMPLE_RATE:
        return samples
    n_out = int(round(len(samples) * SAMPLE_RATE / rate))
    return np.interp(
        np.arange(n_out) * (rate / SAMPLE_RATE),
        np.arange(len(samples)), samples).astype(np.float32)


def log_spectrogram(samples: np.ndarray, rate: int = SAMPLE_RATE,
                    normalize: bool = True) -> np.ndarray:
    """[num_samples] -> [N_FREQ, T] log-|STFT| features.

    Non-16k input resamples to 16 kHz first (linear interp), so the fixed
    320-sample Hamming window / 160-sample stride and 161 frequency bins
    hold for every file. Utterance-level mean/std normalization as in
    DeepSpeech.
    """
    samples = resample_to_16k(np.asarray(samples, np.float32), rate)
    if len(samples) < N_FFT:
        samples = np.pad(samples, (0, N_FFT - len(samples)))
    stride = int(SAMPLE_RATE * STRIDE_MS / 1000)
    from . import native
    if native.available():
        feat = native.log_spectrogram(samples, N_FFT, stride)
    else:
        n_frames = 1 + (len(samples) - N_FFT) // stride
        idx = (np.arange(N_FFT)[None, :]
               + stride * np.arange(n_frames)[:, None])  # [T, n_fft]
        frames = samples[idx] * np.hamming(N_FFT)[None, :]
        spec = np.abs(np.fft.rfft(frames, axis=1))       # [T, N_FREQ]
        feat = np.log1p(spec).T.astype(np.float32)       # [N_FREQ, T]
    if normalize:
        feat = (feat - feat.mean()) / (feat.std() + 1e-6)
    return feat


def encode_transcript(text: str) -> np.ndarray:
    """Characters -> int32 ids; unknown chars drop (reference behavior for
    out-of-label punctuation). Blank/pad id 0 never appears in targets."""
    ids = [_CHAR_TO_ID[c] for c in text.lower() if c in _CHAR_TO_ID
           and c != "_"]
    return np.asarray(ids, np.int32)


def decode_labels(ids: Sequence[int]) -> str:
    return "".join(LABELS[i] for i in ids if 0 < i < NUM_LABELS)


def read_manifest(path: str) -> List[Tuple[str, str]]:
    """DeepSpeech manifest: ``wav_path,transcript_path`` per row; relative
    paths resolve against the manifest's directory."""
    base = os.path.dirname(os.path.abspath(path))
    rows = []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            wav, txt = row[0].strip(), row[1].strip()
            rows.append((os.path.join(base, wav) if not os.path.isabs(wav)
                         else wav,
                         os.path.join(base, txt) if not os.path.isabs(txt)
                         else txt))
    return rows


def quantize_width(t: int, widths: Sequence[int]) -> int:
    """Smallest bucket width >= t (longest bucket if t exceeds them all)."""
    for w in sorted(widths):
        if t <= w:
            return w
    return max(widths)


def featurize_manifest(
    manifest_path: str,
    widths: Sequence[int] = (100, 200, 400, 800),
    tgt_len: int = 64,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Featurize every manifest row into per-width buckets.

    Returns a list of ``(x [N_b, N_FREQ, W], y [N_b, tgt_len])`` pairs, one
    per non-empty bucket width W (ascending). Features pad with zeros to the
    bucket width (truncate to the largest); labels pad with 0 (CTC blank =
    padding sentinel, matching training/losses.py's ctc masking).
    """
    per_w = {}
    for wav_path, txt_path in read_manifest(manifest_path):
        samples, rate = read_wav(wav_path)
        feat = log_spectrogram(samples, rate)
        with open(txt_path) as f:
            labels = encode_transcript(f.read().strip())
        w = quantize_width(feat.shape[1], widths)
        feat = feat[:, :w]
        if feat.shape[1] < w:
            feat = np.pad(feat, ((0, 0), (0, w - feat.shape[1])))
        y = labels[:tgt_len]
        if len(y) < tgt_len:
            y = np.pad(y, (0, tgt_len - len(y)))
        per_w.setdefault(w, []).append((feat, y))
    return [(np.stack([f for f, _ in items]).astype(np.float32),
             np.stack([y for _, y in items]).astype(np.int32))
            for w, items in sorted(per_w.items())]


def write_wav(path: str, samples: np.ndarray,
              rate: int = SAMPLE_RATE) -> None:
    """float32 [-1,1] -> 16-bit PCM wav (test fixtures / tooling)."""
    pcm = np.clip(samples, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
