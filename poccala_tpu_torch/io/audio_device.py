"""Microphone / speaker IO (optional).

Replaces ``AudioProcessing.play`` / ``AudioProcessing.record``
(``StatisticalModel/AudioProcessing.py:44-97``).  pyaudio is an optional
dependency (absent on TPU hosts); the functions degrade to a clear
error.  The stderr-suppression context manager mirrors the reference's
``ignore_stderr`` (``AudioProcessing.py:23-34``) since ALSA spews
warnings on open.
"""

from __future__ import annotations

import os
import sys
import wave
from contextlib import contextmanager


@contextmanager
def ignore_stderr():
    """Silence C-level stderr during device open (``AudioProcessing.py:23-34``)."""
    devnull = os.open(os.devnull, os.O_WRONLY)
    old = os.dup(2)
    sys.stderr.flush()
    os.dup2(devnull, 2)
    os.close(devnull)
    try:
        yield
    finally:
        os.dup2(old, 2)
        os.close(old)


def _pyaudio():
    try:
        import pyaudio  # type: ignore
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "audio-device IO requires pyaudio, which is not installed on "
            "this host; use file-based input (poccala_tpu_torch.io.wav) instead"
        ) from e
    return pyaudio


def play(path: str, chunk: int = 1024) -> None:
    """Play a WAV file (``AudioProcessing.play``, ``AudioProcessing.py:46-60``)."""
    pyaudio = _pyaudio()
    with ignore_stderr():
        pa = pyaudio.PyAudio()
    wav = wave.open(path, "rb")
    stream = pa.open(
        format=pa.get_format_from_width(wav.getsampwidth()),
        channels=wav.getnchannels(), rate=wav.getframerate(), output=True,
    )
    data = wav.readframes(chunk)
    while data:
        stream.write(data)
        data = wav.readframes(chunk)
    stream.stop_stream()
    stream.close()
    wav.close()
    pa.terminate()


def record(seconds: float, output_path: str, rate: int = 16000,
           channels: int = 1, chunk: int = 1024) -> str:
    """Record from the default microphone to a WAV file
    (``AudioProcessing.record``, ``AudioProcessing.py:62-97``)."""
    pyaudio = _pyaudio()
    with ignore_stderr():
        pa = pyaudio.PyAudio()
    stream = pa.open(format=pyaudio.paInt16, channels=channels, rate=rate,
                     input=True, frames_per_buffer=chunk)
    frames = []
    total = int(rate * seconds)
    got = 0
    while got < total:
        n = min(chunk, total - got)
        frames.append(stream.read(n))
        got += n
    stream.stop_stream()
    stream.close()
    wav = wave.open(output_path, "wb")
    wav.setnchannels(channels)
    wav.setsampwidth(pa.get_sample_size(pyaudio.paInt16))
    wav.setframerate(rate)
    wav.writeframes(b"".join(frames))
    wav.close()
    pa.terminate()
    return output_path
