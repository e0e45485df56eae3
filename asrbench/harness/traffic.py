"""The one traffic generator: utterances sampled from the configuration's
own HMMs, shaped by a traffic mix's parameters (``traffic/<mix>.json``).

For each utterance it draws a word sequence from the vocabulary, expands
it to bank units (a silence unit at each end where the mix asks), gives
every emitting state a duration, and draws each frame from one Gaussian
of that state's senone in the generating bank.  Utterance lengths are a
fixed grid of the mix's distribution (its quantiles), the same set in
every batch and for every seed; the seed draws their order, the words,
the durations and the frames.  So two seeds give the program the same
amount of work in another order and with other content.
"""

from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np
import torch

from asrbench.harness.model import Model


@dataclass
class Batch:
    """One batch of utterances, features on the device."""

    feats: torch.Tensor      # [B, T, D] float32
    n_frames: np.ndarray     # [B] int64
    labels: np.ndarray       # [B, L] int64 bank units (0 past the end)
    label_lens: np.ndarray   # [B] int64
    words: list              # per utterance, word ids
    frames_per_s: float

    @property
    def audio_s(self) -> float:
        """Seconds of audio in the batch (valid frames only)."""
        return float(self.n_frames.sum()) / self.frames_per_s

    def t_masks(self) -> torch.Tensor:
        t = torch.arange(self.feats.shape[1], device=self.feats.device)
        n = torch.as_tensor(self.n_frames, device=self.feats.device)
        return t[None] < n[:, None]


def lengths_s(dist: dict, n: int) -> np.ndarray:
    """``n`` utterance lengths in seconds: the mid-quantiles of a
    log-normal (``median``, ``sigma``) or a uniform law, clipped to
    ``[lo, hi]``."""
    q = (np.arange(n) + 0.5) / n
    if dist["dist"] == "lognormal":
        z = np.asarray([NormalDist().inv_cdf(p) for p in q])
        s = dist["median"] * np.exp(dist["sigma"] * z)
    elif dist["dist"] == "uniform":
        s = dist["lo"] + (dist["hi"] - dist["lo"]) * q
    else:
        raise ValueError(f"unknown length law {dist['dist']!r}")
    return np.clip(s, dist["lo"], dist["hi"])


def make_batches(model: Model, bank: dict, mix: dict, seed: int,
                 n_batches: int | None = None) -> list[Batch]:
    """``mix['batches']`` batches of ``mix['batch']`` utterances."""
    rng = np.random.default_rng([int(seed), 2])
    dev = bank["means"].device
    g = torch.Generator(device=dev).manual_seed(int(seed) ^ 0x7AFF1C)
    secs = lengths_s(mix["seconds"], mix["batch"])
    fps = mix["frames_per_s"]
    emit = model.emit
    out = []
    for _ in range(n_batches or mix["batches"]):
        utt_secs = rng.permutation(secs)
        words, labels, senones, n_frames = [], [], [], []
        for s in utt_secs:
            want = max(1, int(round(s * mix["syllables_per_s"])))
            ws, units = [], []
            while len(units) < 2 * want:
                v = int(rng.integers(len(model.word_units)))
                ws.append(v)
                units.extend(model.word_units[v])
            if mix.get("silence"):
                units = [model.sil_unit] + units + [model.sil_unit]
            units = np.asarray(units, np.int64)
            states = model.senone_map[units].reshape(-1)
            t = max(int(round(s * fps)), len(states))
            dur = 1 + rng.multinomial(
                t - len(states), rng.dirichlet(np.full(len(states), 2.0)))
            words.append(ws)
            labels.append(units)
            senones.append(np.repeat(states, dur))
            n_frames.append(t)
        n_frames = np.asarray(n_frames, np.int64)
        t_pad = int(n_frames.max())
        sen = np.zeros((len(n_frames), t_pad), np.int64)
        for b, row in enumerate(senones):
            sen[b, :len(row)] = row
        lab = np.zeros((len(labels), max(len(x) for x in labels)), np.int64)
        for b, row in enumerate(labels):
            lab[b, :len(row)] = row
        feats = sample_frames(bank, torch.as_tensor(sen, device=dev), g)
        valid = torch.as_tensor(
            np.arange(t_pad)[None] < n_frames[:, None], device=dev)
        out.append(Batch(feats=feats * valid[..., None], n_frames=n_frames,
                         labels=lab,
                         label_lens=np.asarray([len(x) for x in labels]),
                         words=words, frames_per_s=fps))
    return out


def sample_frames(bank: dict, senone: torch.Tensor,
                  g: torch.Generator) -> torch.Tensor:
    """One draw a frame from its senone's GMM: a mixture by its weight,
    then that Gaussian."""
    flat = senone.reshape(-1)
    w = torch.softmax(bank["log_w"][flat], dim=-1)
    mix = torch.multinomial(w, 1, generator=g)[:, 0]
    mu = bank["means"][flat, mix]
    sd = torch.exp(0.5 * bank["log_var"][flat, mix])
    x = mu + sd * torch.randn(mu.shape, generator=g, device=mu.device)
    return x.reshape(*senone.shape, -1).contiguous()
