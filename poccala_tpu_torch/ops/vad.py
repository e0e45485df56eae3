"""Voice-activity detection as a frame mask (port of
``poccala_tpu/ops/vad.py``).

The reference's mel-cepstral-distance VAD
(``AudioProcessing.py:450-543``) deletes non-speech frames; here it yields
a mask, batched over utterances, and :func:`apply_mask` packs on the host.

1. noise template = mean of the first ``sample_size`` frames, then an
   EMA sweep over those same frames with α (``:462-472``);
2. per-frame Euclidean distance to the template (``:473-478``);
3. order-statistics filter over a sliding ``2*sample_size`` window:
   ``(1-β)·sorted[h] + β·sorted[h+1]``, ``h = int(β·(2·sample_size+1))``
   (``:480-507``);
4. adaptive threshold ``d_mid·(max-min)/max`` with ``d_mid`` the smoothed
   distance at frame ``sample_size//2`` (``:509-527``);
5. speech = smoothed distance strictly above the threshold (``:527-536``).

Utterances shorter than one filter window keep all valid frames.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def vad_mask_batch(feats: torch.Tensor, frame_mask: torch.Tensor,
                   sample_size: int = 16, alpha: float = 0.5,
                   beta: float = 0.93) -> torch.Tensor:
    """``[B, T, D]`` features, ``[B, T]`` validity -> ``[B, T]`` bool
    speech mask."""
    b, t_pad, _ = feats.shape
    dev = feats.device
    t_true = frame_mask.to(torch.int32).sum(dim=1)          # [B]

    head = feats[:, :sample_size]
    noise = head.mean(dim=1)
    for i in range(head.shape[1]):
        noise = alpha * noise + (1 - alpha) * head[:, i]

    diff = noise[:, None, :] - feats
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))       # [B, T]

    h = int(beta * (2 * sample_size + 1))
    pos = torch.arange(t_pad, device=dev)
    idx = torch.clamp(pos[:, None] + torch.arange(-sample_size, sample_size,
                                                  device=dev)[None],
                      0, t_pad - 1)                          # [T, w]
    windows = torch.sort(dist[:, idx], dim=-1).values       # [B, T, w]
    smoothed_mid = (1 - beta) * windows[..., h] + beta * windows[..., h + 1]
    in_osf = (pos[None] >= sample_size) & (pos[None] < (t_true - sample_size)[:, None])
    smoothed = torch.where(in_osf, smoothed_mid, dist)

    valid = frame_mask.to(torch.bool)
    d_mid = smoothed[:, sample_size // 2]
    max_d = torch.where(valid, smoothed, -math.inf).max(dim=1).values
    min_d = torch.where(valid, smoothed, math.inf).min(dim=1).values
    thresh = d_mid * (max_d - min_d) / torch.clamp(max_d, min=1e-10)
    speech = (smoothed - thresh[:, None] > 0.0) & valid
    short = (t_true < 2 * sample_size + 1)[:, None]
    return torch.where(short, valid, speech)


def vad_mask(feats: torch.Tensor, frame_mask: torch.Tensor,
             sample_size: int = 16, alpha: float = 0.5,
             beta: float = 0.93) -> torch.Tensor:
    """One utterance: ``[T, D]``, ``[T]`` -> ``[T]`` bool."""
    return vad_mask_batch(feats[None], frame_mask[None], sample_size,
                          alpha, beta)[0]


def apply_mask(feats, mask, max_frames: int | None = None):
    """Host-side pack: keep masked frames, left-aligned, zero right-pad
    (the reference's ragged frame deletion, ``AudioProcessing.py:536``,
    as fixed-shape (packed, length) pairs).

    :param feats: ``[T, D]`` tensor (any device) or array
    :param mask: ``[T]`` bool
    :returns: (packed ``[max_frames, D]`` ndarray, n_kept)
    """
    if isinstance(feats, torch.Tensor):
        feats = feats.detach().cpu().numpy()
    if isinstance(mask, torch.Tensor):
        mask = mask.detach().cpu().numpy()
    feats = np.asarray(feats)
    mask = np.asarray(mask).astype(bool)
    kept = feats[mask]
    n = kept.shape[0]
    out_len = max_frames if max_frames is not None else feats.shape[0]
    out = np.zeros((out_len, feats.shape[1]), dtype=feats.dtype)
    out[: min(n, out_len)] = kept[:out_len]
    return out, min(n, out_len)
