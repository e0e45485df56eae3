"""MFCC feature frontend, batched over utterances (port of
``poccala_tpu/ops/frontend.py``).

Pre-emphasis -> framing -> windowing -> |DFT| -> (spectral subtraction)
-> frame energy -> mel filterbank -> log -> DCT -> energy-c0 -> (pitch)
-> (CMVN) -> Δ/ΔΔ -> padding mask, on ``[B, n]`` zero-padded signals with
true lengths ``n_samples`` (``AudioProcessing.py:183-448``).  Where the
JAX version ``vmap``s a per-utterance function, this one carries the
batch axis through every op.

Reference-numerics quirks stay flag-gated by
``FrontendConfig.reference_quirks`` (window over the frame axis,
ascending-sawtooth mel filters, the ``(2k-1)`` DCT index, magnitude
energy); see the JAX module's docstring.

Precision: every matmul here is exact float32.  On a GPU that needs
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default):
the DFT's high-frequency bins cancel and the log amplifies their
relative error (``poccala_tpu/config.py:49-56``).  ``dot_precision``
values other than ``'highest'`` selected the TPU's reduced-precision
passes and have no counterpart here, so they raise.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from poccala_tpu_torch.config import FrontendConfig
from poccala_tpu_torch.utils.device import resolve

_LOG_EPS = 1e-10  # floor before log; the reference takes log(0) -> -inf


def mel_of_hz(hz):
    """Mel(f) = 2595 * ln(1 + f/700) (``AudioProcessing.py:307-308``)."""
    return 2595.0 * np.log(1.0 + np.asarray(hz) / 700.0)


def hz_of_mel(mel):
    """Inverse mel scale (``AudioProcessing.py:310-311``)."""
    return 700.0 * (np.exp(np.asarray(mel) / 2595.0) - 1.0)


def mel_filterbank_matrix(cfg: FrontendConfig) -> np.ndarray:
    """Build the [nfft//2+1, num_filters] filterbank matrix.

    Reference construction: ``AudioProcessing.py:306-343`` — mel-spaced
    center bins via ``floor((nfft+1)/rate * hz)``, integer-truncated ramp
    starts, float bin-difference denominators.  ``reference_quirks``
    selects the ascending-sawtooth falling edge (``:325-326``); otherwise
    a proper descending edge is used.
    """
    high_hz = cfg.high_hz or cfg.sample_rate / 2
    mel = np.linspace(mel_of_hz(cfg.low_hz), mel_of_hz(high_hz), cfg.num_filters + 2)
    hz = hz_of_mel(mel)
    bins = np.floor((cfg.nfft + 1) / cfg.sample_rate * hz)  # float values
    n_bins = cfg.nfft // 2 + 1
    fbank = np.zeros((cfg.num_filters, n_bins))
    for i in range(cfg.num_filters):
        b0, b1, b2 = int(bins[i]), int(bins[i + 1]), int(bins[i + 2])
        for j in range(b0, b1):
            fbank[i, j] = (j - b0) / (bins[i + 1] - bins[i])
        for j in range(b1, min(b2, n_bins)):
            if cfg.reference_quirks:
                fbank[i, j] = (j - b1) / (bins[i + 2] - bins[i + 1])
            else:
                fbank[i, j] = (bins[i + 2] - j) / (bins[i + 2] - bins[i + 1])
    return fbank.T.astype(np.float32)  # [n_bins, num_filters]


def dct_matrix(cfg: FrontendConfig) -> np.ndarray:
    """[num_filters, dct_num] DCT basis.

    Reference: ``C[k, j] = (2/√M)·cos(π(2k-1)j/(2M))`` with k from 0
    (``AudioProcessing.py:361-368``); textbook DCT-II uses ``(2k+1)``.
    """
    m = cfg.num_filters
    k = np.arange(m)[:, None]
    j = np.arange(cfg.dct_num)[None, :]
    coeff = 2.0 / math.sqrt(m)
    if cfg.reference_quirks:
        basis = coeff * np.cos(np.pi * (2 * k - 1) * j / (2 * m))
    else:
        basis = coeff * np.cos(np.pi * (2 * k + 1) * j / (2 * m))
    return basis.astype(np.float32)


def num_frames(n_samples: int, frame_size: int, frame_step: int):
    """``1 + ceil((n - size)/step)`` (``AudioProcessing.py:216``)."""
    return 1 + -(-(n_samples - frame_size) // frame_step)


@functools.lru_cache(maxsize=8)
def delta_matrix(t_pad: int, n: int) -> np.ndarray:
    """Banded delta-regression matrix ``W[t, u] = k/denom`` for
    ``u = clip(t+k, 0, t_pad-1)``, k in [-n, n] (the JAX ``_delta_w``)."""
    denom = 2 * sum(i * i for i in range(1, n + 1))
    w = np.zeros((t_pad, t_pad), np.float32)
    rows = np.arange(t_pad)
    for k in range(-n, n + 1):
        np.add.at(w, (rows, np.clip(rows + k, 0, t_pad - 1)), k / denom)
    return w


class Frontend:
    """Batched MFCC+Δ+ΔΔ extractor on ``device``.

    Usage::

        fe = Frontend(cfg, device="cuda")
        feats, mask = fe.mfcc_batch(signals, n_samples)  # [B,T,D], [B,T]

    ``signals`` is zero-padded to a common length; ``n_samples`` carries
    true lengths.  Padded frames are masked out, and Δ edge replication
    respects each utterance's true frame count.
    """

    def __init__(self, cfg: FrontendConfig, device=None):
        if cfg.dot_precision != "highest":
            raise ValueError(
                f"dot_precision={cfg.dot_precision!r} has no PyTorch "
                "counterpart; the port runs the frontend in exact float32")
        self.cfg = cfg
        self.device = resolve(device)
        self.frame_size = cfg.frame_size
        self.frame_step = cfg.frame_step

        def dev(a):
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)

        self._fbank = dev(mel_filterbank_matrix(cfg))
        self._dct = dev(dct_matrix(cfg))
        self._window = None
        if not cfg.reference_quirks:
            n = np.arange(cfg.frame_size)
            w = (1 - cfg.hamming_alpha) - cfg.hamming_alpha * np.cos(
                2 * np.pi * n / (cfg.frame_size - 1))
            self._window = dev(w.astype(np.float32))
        self._delta_mats: dict[int, torch.Tensor] = {}  # t_pad -> W
        self._dft_cs = None
        if cfg.matmul_dft:
            # [frame_size, 2K] cos|sin DFT basis restricted to the first
            # frame_size input rows (the rFFT zero-pads frames to nfft)
            k = (np.arange(cfg.nfft)[:, None]
                 * np.arange(cfg.nfft // 2 + 1)[None, :]
                 * 2.0 * np.pi / cfg.nfft)[: cfg.frame_size]
            self._dft_cs = dev(np.concatenate(
                [np.cos(k).astype(np.float32), np.sin(k).astype(np.float32)],
                axis=1))

    # ------------------------------------------------------------------
    def _frames(self, signal: torch.Tensor) -> torch.Tensor:
        """``[B, n]`` -> ``[B, T_pad, frame_size]`` frame blocking
        (``AudioProcessing.py:200-225``), zero padding to whole frames."""
        n = signal.shape[-1]
        t = num_frames(n, self.frame_size, self.frame_step)
        pad = (t - 1) * self.frame_step + self.frame_size - n
        padded = torch.nn.functional.pad(signal, (0, max(pad, 0)))
        return padded.unfold(-1, self.frame_size, self.frame_step)[:, :t]

    def _pre(self, signal: torch.Tensor, n_samples: torch.Tensor):
        """Pre-emphasis + true-frame-count bookkeeping.  Returns
        ``(pe [B, n], t_true [B], mask [B, T_pad])``."""
        cfg = self.cfg
        b, n = signal.shape
        # y_t = x_{t+1} - αx_t, final element zero-filled
        # (AudioProcessing.py:183-198); the reference zero-fills the *last
        # true* sample, which with zero padding is n_samples-1
        pe = torch.cat([signal[:, 1:] - cfg.pre_emphasis * signal[:, :-1],
                        signal.new_zeros((b, 1))], dim=1)
        pos = torch.arange(n, device=signal.device)
        pe = torch.where(pos[None] == (n_samples - 1)[:, None],
                         torch.zeros_like(pe), pe)
        t_pad = num_frames(n, self.frame_size, self.frame_step)
        t_true = 1 + torch.ceil(
            (n_samples - self.frame_size).to(torch.float32) / self.frame_step
        ).to(torch.int32)
        t_true = torch.clamp(t_true, 1, t_pad)
        mask = torch.arange(t_pad, device=signal.device)[None] < t_true[:, None]
        return pe, t_true, mask

    def _core(self, pe: torch.Tensor, t_true: torch.Tensor) -> torch.Tensor:
        """Framing -> window -> |DFT| -> energy -> mel -> log -> DCT -> c0
        on ``[B, n]`` pre-emphasized signals: ``[B, T_pad, dct_num]``
        cepstra (the JAX ``_core_xla``)."""
        cfg = self.cfg
        frames = self._frames(pe)  # [B, T_pad, frame_size]
        t_pad = frames.shape[1]
        frame_idx = torch.arange(t_pad, device=pe.device)

        if cfg.reference_quirks:
            # one scalar per frame, over the frame axis, length = true
            # frame count (AudioProcessing.py:242-245)
            denom = torch.clamp(t_true - 1, min=1).to(torch.float32)
            w = (1 - cfg.hamming_alpha) - cfg.hamming_alpha * torch.cos(
                (2 * math.pi) * frame_idx.to(torch.float32)[None]
                / denom[:, None])
            win = frames * w[:, :, None]
        else:
            win = frames * self._window

        if cfg.matmul_dft:
            k = self._dft_cs.shape[1] // 2
            cs = win @ self._dft_cs
            re, im = cs[..., :k], cs[..., k:]
            spec = torch.sqrt(re * re + im * im)  # [B, T, nfft//2+1]
        else:
            spec = torch.abs(torch.fft.rfft(win, n=cfg.nfft, dim=-1))

        if cfg.spectral_subtraction:
            # noise magnitude from the first vad_sample_size VALID frames
            n_noise = torch.clamp(t_true, max=cfg.vad_sample_size)
            in_win = (frame_idx[None] < n_noise[:, None])[..., None]
            noise = (torch.sum(torch.where(in_win, spec, 0.0), dim=1)
                     / torch.clamp(n_noise, min=1)[:, None])
            spec = torch.maximum(spec - cfg.ss_alpha * noise[:, None, :],
                                 cfg.ss_floor * spec)

        # AudioProcessing.py:338: sum of magnitudes; textbook: power
        if cfg.reference_quirks:
            energy = torch.sum(spec, dim=-1)
        else:
            energy = torch.sum(spec * spec, dim=-1)

        fbank = spec @ self._fbank
        log_fbank = torch.log(torch.clamp(fbank, min=_LOG_EPS))
        ceps = log_fbank @ self._dct

        # c0 <- log frame energy (AudioProcessing.py:437-438)
        if cfg.energy_c0:
            ceps = torch.cat(
                [torch.log(torch.clamp(energy, min=_LOG_EPS))[..., None],
                 ceps[..., 1:]], dim=-1)

        if cfg.pitch:
            ceps = torch.cat([ceps, self._pitch(frames)[..., None]], dim=-1)
        return ceps

    def _pitch(self, frames: torch.Tensor) -> torch.Tensor:
        """Per-frame F0 feature: autocorrelation peak in the
        [pitch_low_hz, pitch_high_hz] lag band, normalized by the
        zero-lag energy; voiced frames emit
        ``pitch_scale · log2(f0 / 125 Hz)``, unvoiced frames 0."""
        cfg = self.cfg
        fs = self.frame_size
        nfft_ac = 1
        while nfft_ac < 2 * fs:
            nfft_ac *= 2
        spec2 = torch.abs(torch.fft.rfft(frames, n=nfft_ac, dim=-1)) ** 2
        ac = torch.fft.irfft(spec2, n=nfft_ac, dim=-1)[..., :fs]
        lag_min = max(2, int(cfg.sample_rate / cfg.pitch_high_hz))
        lag_max = min(fs - 1, int(cfg.sample_rate / cfg.pitch_low_hz))
        band = ac[..., lag_min: lag_max + 1]
        norm = torch.clamp(ac[..., 0:1], min=_LOG_EPS)
        ratio = band / norm
        peak, best = torch.max(ratio, dim=-1)  # first max, as jnp.argmax
        f0 = cfg.sample_rate / (best + lag_min).to(torch.float32)
        voiced = peak > cfg.pitch_voicing
        return torch.where(voiced, cfg.pitch_scale * torch.log2(f0 / 125.0),
                           0.0)

    def _post(self, ceps: torch.Tensor, t_true: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
        """CMVN -> Δ/ΔΔ -> padding mask on ``[B, T_pad, C]`` cepstra."""
        cfg = self.cfg
        if cfg.cmvn:
            # masked per-utterance statistics; the pitch column (0 =
            # unvoiced) is excluded
            nc = cfg.dct_num
            valid = mask[..., None]
            denom = torch.clamp(t_true, min=1).to(ceps.dtype)[:, None]
            cep = ceps[..., :nc]
            mean = torch.sum(torch.where(valid, cep, 0.0), dim=1) / denom
            cep = cep - mean[:, None]
            if cfg.cmvn_var:
                var = torch.sum(torch.where(valid, cep * cep, 0.0),
                                dim=1) / denom
                cep = cep * torch.rsqrt(var + 1e-8)[:, None]
            ceps = torch.cat([cep, ceps[..., nc:]], dim=-1)
        feats = ceps
        if cfg.delta_1:
            d1 = self._delta(ceps, t_true)
            feats = torch.cat([feats, d1], dim=-1)
            if cfg.delta_2:
                d2 = self._delta(d1, t_true)
                feats = torch.cat([feats, d2], dim=-1)
        return torch.where(mask[..., None], feats, 0.0)

    def _delta(self, feat: torch.Tensor, t_true: torch.Tensor) -> torch.Tensor:
        """±n-frame regression deltas with edge replication
        (``AudioProcessing.py:400-414``), clamped to the true frame count:
        the last true row is replicated into the padding, then one banded
        ``[T_pad, T_pad]`` matmul applies the regression weights with the
        static edge replication folded in."""
        b, t_pad, _ = feat.shape
        rows = torch.arange(b, device=feat.device)
        last = feat[rows, (t_true - 1).long()]             # [B, C]
        valid = torch.arange(t_pad, device=feat.device)[None] < t_true[:, None]
        f = torch.where(valid[..., None], feat, last[:, None, :])
        w = self._delta_mats.get(t_pad)
        if w is None:
            w = self._delta_mats[t_pad] = torch.as_tensor(
                delta_matrix(t_pad, self.cfg.delta_n), device=feat.device)
        return w @ f

    # ------------------------------------------------------------------
    def mfcc_batch(self, signals, n_samples):
        """Batch of padded utterances: ``[B, T, D]`` features + ``[B, T]``
        frame mask, on this frontend's device."""
        signals = torch.as_tensor(signals, dtype=torch.float32,
                                  device=self.device)
        n_samples = torch.as_tensor(n_samples, device=self.device)
        pe, t_true, mask = self._pre(signals, n_samples)
        ceps = self._core(pe, t_true)
        return self._post(ceps, t_true, mask), mask

    def mfcc(self, signal, n_samples=None):
        """Single-utterance features: ``[T, D]`` plus frame mask ``[T]``."""
        signal = torch.as_tensor(signal, dtype=torch.float32,
                                 device=self.device)
        if n_samples is None:
            n_samples = signal.shape[0]
        feats, mask = self.mfcc_batch(signal[None], [int(n_samples)])
        return feats[0], mask[0]
