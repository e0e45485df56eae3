"""WAV file IO (host side).

Replaces the reference's wave/pyaudio loader
(``StatisticalModel/AudioProcessing.py:147-181``) with a numpy-only
implementation (no audio-device dependency; playback/record from the
reference's ``AudioProcessing.play/record`` are out of scope on a TPU
host — the serving input is a file/stream of samples).

Reference load semantics reproduced here (both are flag-gated quirks,
SURVEY.md §7 "hard parts" (b)):

* stereo channels merged by per-sample max (``AudioProcessing.py:167-175``),
* **all zero samples deleted** from the signal (``AudioProcessing.py:176``)
  — a ragged, data-dependent operation, so it lives on the host.
"""

from __future__ import annotations

import wave

import numpy as np


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a 16-bit PCM WAV file.

    :returns: (samples ``int16[n]`` or ``int16[n, channels]``, sample_rate)
    """
    with wave.open(path, "rb") as w:
        nchannels = w.getnchannels()
        sampwidth = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if sampwidth != 2:
        raise ValueError(f"only 16-bit PCM supported, got sampwidth={sampwidth}")
    data = np.frombuffer(raw, dtype=np.int16)
    if nchannels > 1:
        data = data.reshape(-1, nchannels)
    return data, rate


def write_wav(path: str, samples: np.ndarray, rate: int) -> None:
    """Write mono 16-bit PCM (used by tests / synthetic corpora)."""
    samples = np.asarray(samples)
    if samples.dtype != np.int16:
        samples = np.clip(samples, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(samples.tobytes())


def preprocess_signal(
    data: np.ndarray, drop_zeros: bool = False
) -> np.ndarray:
    """Merge channels and optionally drop zero samples.

    * multi-channel: per-sample max across channels
      (``AudioProcessing.py:167-175``);
    * ``drop_zeros=True`` reproduces the reference's deletion of all
      exactly-zero samples (``AudioProcessing.py:176``) for parity;
      the default keeps them (textbook behavior).

    :returns: ``float32[n]`` mono signal
    """
    data = np.asarray(data)
    if data.ndim == 2:
        data = data.max(axis=1)
    if drop_zeros:
        data = data[data != 0]
    return data.astype(np.float32)
