"""Formant-synthesized Mandarin speech — the WER proxy corpus.

(A copy of ``poccala_tpu/io/synth_formant.py``, pinned to it by
``tests/test_torch_copies.py``.)  The reference's intended corpora are real
recordings (``data_24`` default, THCHS-30 commented out,
``config.ini:16-22``), and the repository ships no speech corpus, so
"WER parity on a held-out Mandarin set" cannot be shown on real audio.
This module is the documented substitute: a source–filter **formant synthesizer** producing
coarticulated Mandarin syllables — far closer to speech than the
two-harmonic unit signatures of :func:`poccala_tpu_torch.io.corpus.
generate_synthetic_corpus` — so the full pipeline (pinyin labels → MFCC
→ flat start → embedded Baum-Welch → tied states → beam decode → WER)
runs end to end on phonetically structured input.  Every WER artifact
derived from it is labeled a *proxy*, never real-speech evidence.

Synthesis model (all NumPy, no per-sample Python loops):

* **Voiced source**: additive harmonics of a per-sample F0 track
  (``sin(k·Φ)`` with ``Φ = 2π·cumsum(f0)/fs``), amplitudes sampled from
  a spectral envelope of Lorentzian formant resonances evaluated on a
  5 ms grid and linearly upsampled.  Lexical tones are F0 contours over
  each syllable's final (1 high-flat, 2 rising, 3 dipping, 4 falling,
  0 short-neutral).
* **Unvoiced source**: white noise, band-shaped per segment with a
  Gaussian bump in the rFFT domain (fricatives), short wide-band clicks
  (stop bursts), or formant-shaped aspiration.
* **Coarticulation**: formant targets of consecutive segments are
  anchor points of one continuous piecewise-linear track per formant
  across the whole utterance; consonants contribute place-dependent
  locus anchors (labial/alveolar/velar/retroflex/palatal), so vowel
  onsets carry the consonant's transition — the property that makes
  GMM-HMM states context-dependent like real speech.
* **Speakers**: per-speaker formant scale, F0 base/range, speaking
  rate, and breathiness, for train/test speaker variation.

The phone inventory is exactly the XIF(_tone) unit set of the acoustic
models (``AcousticModel/Unit/*``): initials (incl. the ``#_*``
zero-initials) + toned finals, so a ``label_format='pinyin'`` corpus
(THCHS-30-style ``.trn`` with a toned-pinyin line) maps 1:1 onto
synthesis segments.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from poccala_tpu_torch.io import wav as wav_io

# ----------------------------------------------------------------------
# Phone specs
# ----------------------------------------------------------------------

# Monophthong / target formants (F1, F2, F3) in Hz.
VOWEL_TARGETS: dict[str, tuple[float, float, float]] = {
    "a": (850.0, 1220.0, 2810.0),
    "o": (500.0, 850.0, 2700.0),
    "e": (550.0, 1200.0, 2600.0),   # ɤ
    "i": (300.0, 2250.0, 3100.0),
    "u": (350.0, 700.0, 2700.0),
    "v": (300.0, 2100.0, 2650.0),   # y (ü)
    "E": (600.0, 1950.0, 2700.0),   # ê in ie/üe, fronted a in ian
    "@": (500.0, 1450.0, 2500.0),   # schwa (en/eng nucleus)
    "U": (450.0, 950.0, 2600.0),    # near-close back (ong nucleus)
    "R": (500.0, 1350.0, 1650.0),   # er: rhotacized, F3 collapsed
    "N": (300.0, 1700.0, 2600.0),   # coda n murmur
    "G": (280.0, 900.0, 2500.0),    # coda ng murmur
    "Z": (380.0, 1800.0, 2200.0),   # apical vowel after z/c/s/zh/…
}

# Final (tone digit stripped) -> sequence of (target key, rel duration).
# Codas N/G are nasal murmurs with their own (shorter) span.
FINAL_PLANS: dict[str, list[tuple[str, float]]] = {
    "a": [("a", 1.0)],
    "o": [("o", 1.0)],
    "e": [("e", 1.0)],
    "i": [("i", 1.0)],
    "u": [("u", 1.0)],
    "v": [("v", 1.0)],
    "er": [("R", 1.0)],
    "ai": [("a", 0.6), ("i", 0.4)],
    "ei": [("E", 0.55), ("i", 0.45)],
    "ao": [("a", 0.6), ("u", 0.4)],
    "ou": [("o", 0.55), ("u", 0.45)],
    "an": [("a", 0.65), ("N", 0.35)],
    "en": [("@", 0.65), ("N", 0.35)],
    "in": [("i", 0.65), ("N", 0.35)],
    "un": [("u", 0.4), ("@", 0.25), ("N", 0.35)],
    "vn": [("v", 0.65), ("N", 0.35)],
    "ang": [("a", 0.6), ("G", 0.4)],
    "eng": [("@", 0.6), ("G", 0.4)],
    "ing": [("i", 0.6), ("G", 0.4)],
    "ong": [("U", 0.6), ("G", 0.4)],
    "ia": [("i", 0.3), ("a", 0.7)],
    "ie": [("i", 0.35), ("E", 0.65)],
    "iao": [("i", 0.25), ("a", 0.45), ("u", 0.3)],
    "iu": [("i", 0.35), ("o", 0.3), ("u", 0.35)],
    "ian": [("i", 0.3), ("E", 0.4), ("N", 0.3)],
    "iang": [("i", 0.25), ("a", 0.45), ("G", 0.3)],
    "iong": [("i", 0.3), ("U", 0.4), ("G", 0.3)],
    "ua": [("u", 0.3), ("a", 0.7)],
    "uo": [("u", 0.35), ("o", 0.65)],
    "uai": [("u", 0.25), ("a", 0.45), ("i", 0.3)],
    "ui": [("u", 0.35), ("E", 0.3), ("i", 0.35)],
    "uan": [("u", 0.25), ("a", 0.45), ("N", 0.3)],
    "uang": [("u", 0.25), ("a", 0.45), ("G", 0.3)],
    "ue": [("v", 0.35), ("E", 0.65)],
    "ve": [("v", 0.35), ("E", 0.65)],
}

# Initial consonant synthesis plans.  Segment kinds:
#   ("sil", dur)                      closure silence
#   ("burst", cf, bw, dur)            wide-band click
#   ("fric", cf, bw, dur)             shaped noise
#   ("asp", dur)                      aspiration (formant-shaped noise)
#   ("son", target_key, dur)          voiced sonorant (nasal/liquid/glide)
# plus a place-of-articulation F2 locus for the CV transition.
@dataclass
class InitialSpec:
    segments: list[tuple]
    locus: tuple[float, float, float] | None  # (F1, F2, F3) onset anchor
    apical: bool = False  # z/c/s/zh/ch/sh/r turn a bare "i" into [ɿ/ʅ]


_LAB = (350.0, 800.0, 2400.0)     # labial locus
_ALV = (350.0, 1800.0, 2700.0)    # alveolar
_VEL = (300.0, 1600.0, 2300.0)    # velar (F2/F3 pinch)
_PAL = (300.0, 2100.0, 2900.0)    # palatal
_RET = (350.0, 1800.0, 2000.0)    # retroflex (low F3)

INITIAL_SPECS: dict[str, InitialSpec] = {
    "b": InitialSpec([("sil", 0.045), ("burst", 900, 900, 0.012)], _LAB),
    "p": InitialSpec([("sil", 0.045), ("burst", 900, 900, 0.012),
                      ("asp", 0.055)], _LAB),
    "m": InitialSpec([("son", "M", 0.07)], _LAB),
    "f": InitialSpec([("fric", 1300, 2500, 0.09)], _LAB),
    "d": InitialSpec([("sil", 0.045), ("burst", 3200, 1200, 0.012)], _ALV),
    "t": InitialSpec([("sil", 0.045), ("burst", 3600, 1200, 0.012),
                      ("asp", 0.055)], _ALV),
    "n": InitialSpec([("son", "N", 0.07)], _ALV),
    "l": InitialSpec([("son", "L", 0.06)], _ALV),
    "g": InitialSpec([("sil", 0.045), ("burst", 1700, 900, 0.012)], _VEL),
    "k": InitialSpec([("sil", 0.045), ("burst", 1700, 900, 0.012),
                      ("asp", 0.055)], _VEL),
    "h": InitialSpec([("fric", 1500, 1500, 0.08)], _VEL),
    "j": InitialSpec([("sil", 0.03), ("burst", 4200, 1200, 0.01),
                      ("fric", 4400, 1500, 0.05)], _PAL),
    "q": InitialSpec([("sil", 0.03), ("burst", 4200, 1200, 0.01),
                      ("fric", 4400, 1500, 0.05), ("asp", 0.04)], _PAL),
    "x": InitialSpec([("fric", 4400, 1500, 0.09)], _PAL),
    "zh": InitialSpec([("sil", 0.03), ("burst", 2900, 1100, 0.01),
                       ("fric", 3100, 1300, 0.055)], _RET, apical=True),
    "ch": InitialSpec([("sil", 0.03), ("burst", 2900, 1100, 0.01),
                       ("fric", 3100, 1300, 0.055), ("asp", 0.04)], _RET,
                      apical=True),
    "sh": InitialSpec([("fric", 3100, 1300, 0.10)], _RET, apical=True),
    "r": InitialSpec([("son", "RR", 0.06)], _RET, apical=True),
    "z": InitialSpec([("sil", 0.03), ("burst", 5800, 1600, 0.01),
                      ("fric", 6200, 1800, 0.055)], _ALV, apical=True),
    "c": InitialSpec([("sil", 0.03), ("burst", 5800, 1600, 0.01),
                      ("fric", 6200, 1800, 0.055), ("asp", 0.04)], _ALV,
                     apical=True),
    "s": InitialSpec([("fric", 6200, 1800, 0.10)], _ALV, apical=True),
    # zero-initials: brief on-glide / glottal onset of the class vowel
    "#_I": InitialSpec([("son", "i", 0.05)], None),
    "#_u": InitialSpec([("son", "u", 0.05)], None),
    "#_a": InitialSpec([("sil", 0.02)], None),
    "#_o": InitialSpec([("sil", 0.02)], None),
    "#_e": InitialSpec([("sil", 0.02)], None),
    "#_v": InitialSpec([("son", "v", 0.05)], None),
}

# sonorant targets not in VOWEL_TARGETS
SONORANT_TARGETS = {
    "M": (250.0, 1100.0, 2200.0),   # m murmur
    "N": VOWEL_TARGETS["N"],
    "L": (380.0, 1050.0, 2600.0),   # l
    "RR": (350.0, 1600.0, 1900.0),  # ʐ approximant
    "i": VOWEL_TARGETS["i"],
    "u": VOWEL_TARGETS["u"],
    "v": VOWEL_TARGETS["v"],
}

# Tone contours as (relative time, F0 multiplier) anchor lists.
TONE_CONTOURS: dict[str, list[tuple[float, float]]] = {
    "1": [(0.0, 1.25), (1.0, 1.25)],
    "2": [(0.0, 0.85), (0.35, 0.85), (1.0, 1.30)],
    "3": [(0.0, 0.90), (0.5, 0.62), (1.0, 0.95)],
    "4": [(0.0, 1.35), (1.0, 0.75)],
    "0": [(0.0, 0.95), (1.0, 0.85)],
}


@dataclass
class Speaker:
    """Per-speaker synthesis parameters."""

    f0_base: float = 160.0        # Hz
    formant_scale: float = 1.0    # vocal-tract length factor
    rate: float = 1.0             # speaking-rate multiplier (>1 = faster)
    breathiness: float = 0.02     # aspiration noise floor in voiced spans
    amplitude: float = 9000.0

    @classmethod
    def random(cls, rng: np.random.Generator) -> "Speaker":
        return cls(
            f0_base=float(rng.uniform(95.0, 240.0)),
            formant_scale=float(rng.uniform(0.92, 1.12)),
            rate=float(rng.uniform(0.85, 1.2)),
            breathiness=float(rng.uniform(0.01, 0.05)),
            amplitude=float(rng.uniform(7000.0, 11000.0)),
        )


# ----------------------------------------------------------------------
# Segment plan construction
# ----------------------------------------------------------------------

@dataclass
class _Seg:
    kind: str                 # "sil" | "noise" | "voiced"
    dur: float
    formants: tuple | None = None   # anchor at segment midpoint
    cf: float = 0.0                 # noise center frequency
    bw: float = 0.0
    gain: float = 1.0
    f0_mult: tuple | None = None    # tone anchors覆盖 this span
    nasal: bool = False


def _final_segments(final: str, tone: str, apical: bool,
                    rng: np.random.Generator) -> list[_Seg]:
    plan = FINAL_PLANS[final]
    if apical and final == "i":
        plan = [("Z", 1.0)]
    base_dur = 0.22 if tone != "0" else 0.13
    base_dur *= float(rng.uniform(0.85, 1.15))
    segs = []
    for key, frac in plan:
        nasal = key in ("N", "G")
        segs.append(_Seg(
            kind="voiced", dur=base_dur * frac,
            formants=VOWEL_TARGETS[key],
            gain=0.45 if nasal else 1.0, nasal=nasal,
        ))
    return segs


def _initial_segments(initial: str, rng: np.random.Generator) -> list[_Seg]:
    spec = INITIAL_SPECS[initial]
    segs = []
    for s in spec.segments:
        kind = s[0]
        if kind == "sil":
            segs.append(_Seg(kind="sil", dur=s[1]))
        elif kind == "burst":
            _, cf, bw, dur = s
            segs.append(_Seg(kind="noise", dur=dur, cf=cf, bw=bw, gain=0.9))
        elif kind == "fric":
            _, cf, bw, dur = s
            segs.append(_Seg(kind="noise", dur=dur * rng.uniform(0.9, 1.1),
                             cf=cf, bw=bw, gain=0.55))
        elif kind == "asp":
            segs.append(_Seg(kind="noise", dur=s[1], cf=1800.0, bw=2200.0,
                             gain=0.35))
        elif kind == "son":
            _, key, dur = s
            segs.append(_Seg(kind="voiced", dur=dur,
                             formants=SONORANT_TARGETS[key], gain=0.5))
    return segs


def _plan_syllable(units: list[str], rng: np.random.Generator
                   ) -> tuple[list[_Seg], InitialSpec | None, str]:
    """``[initial, toned_final]`` (or ``[toned_final]``) -> segments."""
    if len(units) == 2:
        initial, toned = units
    else:
        initial, toned = None, units[0]
    tone = toned[-1] if toned[-1].isdigit() else "0"
    final = toned[:-1] if toned[-1].isdigit() else toned
    spec = INITIAL_SPECS.get(initial) if initial else None
    segs: list[_Seg] = []
    if initial:
        segs.extend(_initial_segments(initial, rng))
    fsegs = _final_segments(final, tone, spec.apical if spec else False, rng)
    # attach the tone contour across the voiced final span
    total = sum(s.dur for s in fsegs)
    at = 0.0
    for s in fsegs:
        s.f0_mult = (at / total, (at + s.dur) / total, tone)
        at += s.dur
    segs.extend(fsegs)
    return segs, spec, tone


# ----------------------------------------------------------------------
# Rendering
# ----------------------------------------------------------------------

_GRID_MS = 5.0  # formant/envelope grid


def synth_utterance(
    syllable_units: list[list[str]],
    speaker: Speaker,
    rng: np.random.Generator,
    rate: int = 16000,
    pause_prob: float = 0.15,
    pause_after: list[bool] | None = None,
) -> np.ndarray:
    """Render one utterance (a sequence of syllables, each a
    ``[initial, final]`` unit list) to a float signal at ``rate``.

    :param pause_after: optional per-syllable inter-word pause plan (so
        the caller can label the pauses); sampled from ``pause_prob``
        when None.
    """
    segs: list[_Seg] = []
    # lead silence must exceed the VAD noise-estimation window (16
    # frames = 160 ms, AudioProcessing.py:462-478) so the noise model
    # is estimated from actual background, not speech onsets
    lead = float(rng.uniform(0.22, 0.35))
    segs.append(_Seg(kind="sil", dur=lead))
    for i, units in enumerate(syllable_units):
        s, _, _ = _plan_syllable(units, rng)
        segs.extend(s)
        pause = (pause_after[i] if pause_after is not None
                 else rng.uniform() < pause_prob)
        if pause and i + 1 < len(syllable_units):
            segs.append(_Seg(kind="sil", dur=float(rng.uniform(0.08, 0.18))))
    segs.append(_Seg(kind="sil", dur=float(rng.uniform(0.12, 0.2))))

    for s in segs:
        s.dur /= speaker.rate

    total = sum(s.dur for s in segs)
    n = int(total * rate)
    grid_step = _GRID_MS / 1000.0
    g = max(2, int(np.ceil(total / grid_step)) + 1)
    tg = np.arange(g) * grid_step                     # grid times

    # ---- anchor tracks: formants (voiced anchors at midpoints), voicing
    # gain, noise spans, F0 multiplier
    anchor_t, anchor_f = [], []
    at = 0.0
    f0_anchor_t, f0_anchor_m = [0.0], [1.0]
    voiced_spans, noise_specs = [], []
    for s in segs:
        mid = at + s.dur / 2
        if s.kind == "voiced" and s.formants is not None:
            f = np.asarray(s.formants) * speaker.formant_scale
            anchor_t.append(mid)
            anchor_f.append(f)
            voiced_spans.append((at, at + s.dur, s.gain, s.nasal))
        elif s.kind == "noise":
            noise_specs.append((at, at + s.dur, s.cf, s.bw, s.gain))
        at += s.dur

    # F0 anchors: one contour per final span (collected again, cleanly)
    at = 0.0
    cur_final: list[tuple[float, float, str]] = []
    for s in segs:
        if s.kind == "voiced" and s.f0_mult is not None:
            cur_final.append((at, at + s.dur, s.f0_mult[2]))
        at += s.dur
    # group contiguous spans of the same final (they share rel coords)
    i = 0
    while i < len(cur_final):
        j = i
        tone = cur_final[i][2]
        while j + 1 < len(cur_final) and cur_final[j + 1][0] <= cur_final[j][1] + 1e-9 \
                and cur_final[j + 1][2] == tone:
            j += 1
        lo, hi = cur_final[i][0], cur_final[j][1]
        for (rt, m) in TONE_CONTOURS[tone]:
            f0_anchor_t.append(lo + rt * (hi - lo))
            f0_anchor_m.append(m * float(rng.uniform(0.97, 1.03)))
        i = j + 1
    f0_anchor_t.append(total)
    f0_anchor_m.append(f0_anchor_m[-1])
    order = np.argsort(f0_anchor_t)
    f0_t = np.asarray(f0_anchor_t)[order]
    f0_m = np.asarray(f0_anchor_m)[order]

    if not anchor_t:
        return np.zeros(n, np.float32)
    anchor_t = np.asarray(anchor_t)
    anchor_f = np.stack(anchor_f)                     # [A, 3]
    formant_g = np.stack([
        np.interp(tg, anchor_t, anchor_f[:, i]) for i in range(3)
    ], axis=1)                                        # [G, 3]

    # ---- voiced component: additive harmonics
    ts = np.arange(n) / rate
    f0 = speaker.f0_base * np.interp(ts, f0_t, f0_m)  # [n]
    phase = 2 * np.pi * np.cumsum(f0) / rate
    k_max = max(3, int((rate * 0.475) / max(speaker.f0_base * 0.6, 60.0)))
    k_max = min(k_max, 96)
    ks = np.arange(1, k_max + 1)
    # envelope on the grid, per harmonic at its (slowly varying) freq —
    # evaluate at k*median f0 per grid cell
    f0_g = speaker.f0_base * np.interp(tg, f0_t, f0_m)      # [G]
    harm_f = f0_g[:, None] * ks[None]                       # [G, K]
    bws = np.asarray([90.0, 110.0, 160.0])
    amps = np.asarray([1.0, 0.63, 0.35])
    env_g = np.zeros((g, k_max))
    for i in range(3):
        fi = formant_g[:, i: i + 1]
        env_g += amps[i] / (1.0 + ((harm_f - fi) / bws[i]) ** 2)
    env_g *= 1.0 / (1.0 + (harm_f / 2500.0) ** 2)
    env_g = np.where(harm_f < rate * 0.48, env_g, 0.0)

    # voicing gain per grid point with 8 ms raised-cosine edges
    vg = np.zeros(g)
    edge = 0.008
    for (lo, hi, gain, nasal) in voiced_spans:
        ramp_in = np.clip((tg - lo) / edge, 0.0, 1.0)
        ramp_out = np.clip((hi - tg) / edge, 0.0, 1.0)
        vg = np.maximum(vg, gain * np.minimum(ramp_in, ramp_out))

    # upsample [G] -> [n]
    gi = np.minimum((ts / grid_step), g - 1.001)
    g0 = gi.astype(np.int32)
    frac = (gi - g0)[:, None]
    env_n = env_g[g0] * (1 - frac) + env_g[g0 + 1] * frac    # [n, K]
    vg_n = np.interp(ts, tg, vg)

    voiced = np.einsum("nk,nk->n", env_n, np.sin(phase[:, None] * ks[None]))
    voiced *= vg_n

    # ---- noise components
    out = voiced
    noise_total = np.zeros(n)
    for (lo, hi, cf, bw, gain) in noise_specs:
        i0, i1 = int(lo * rate), min(int(hi * rate), n)
        if i1 <= i0 + 4:
            continue
        seg = rng.normal(size=i1 - i0)
        spec = np.fft.rfft(seg)
        fr = np.fft.rfftfreq(i1 - i0, 1.0 / rate)
        shape = np.exp(-0.5 * ((fr - cf) / bw) ** 2)
        seg = np.fft.irfft(spec * shape, n=i1 - i0)
        seg /= (np.sqrt(np.mean(seg ** 2)) + 1e-12)
        w = np.hanning(max(8, min(64, i1 - i0)))
        ramp = np.ones(i1 - i0)
        hw = len(w) // 2
        ramp[:hw] = w[:hw]
        ramp[-(len(w) - hw):] = w[hw:]
        noise_total[i0:i1] += gain * seg * ramp
    out = out + 2.2 * noise_total
    # breathiness across voiced spans
    out = out + speaker.breathiness * rng.normal(size=n) * (vg_n + 0.15)

    peak = np.max(np.abs(out)) + 1e-9
    out = out / peak * speaker.amplitude
    # constant room-noise floor (~ -52 dB of peak): gives VAD a real
    # background to estimate, keeps delta features non-degenerate in
    # silence, and avoids zero-variance GMM dimensions
    out = out + speaker.amplitude * 0.0025 * rng.normal(size=n)
    return out.astype(np.float32)


# ----------------------------------------------------------------------
# Corpus generation
# ----------------------------------------------------------------------

def _synthesizable_entries(words, pinyin):
    """word -> (pinyin syllable strings, per-syllable unit lists) for
    every word whose units the synthesizer can render AND whose
    reconstructed toned-pinyin label line round-trips through the
    training-side G2P (``pinyin.syllable_to_units``) — otherwise labels
    and audio would diverge."""
    lex_entries: list[tuple[str, list[str], list[list[str]]]] = []
    for w in words:
        p = pinyin.word2pinyin(w)
        if p is None:
            continue
        syls, units = [], []
        ok = True
        for readings in p:
            r = readings[0]                    # first reading
            us = r.split(",")
            if len(us) == 1:
                ok = False
                break
            ini, fin = us
            if ini not in INITIAL_SPECS:
                ok = False
                break
            base = fin[:-1] if fin[-1].isdigit() else fin
            if base not in FINAL_PLANS:
                ok = False
                break
            # reconstruct the toned-pinyin label token from the units:
            # zero-initials fold back into y/w/"" spellings
            tone = fin[-1] if fin[-1].isdigit() else "0"
            if ini == "#_I":
                spell = "y" + base.replace("v", "u")
            elif ini == "#_u":
                spell = "w" + base if base != "u" else "wu"
            elif ini.startswith("#_"):
                spell = base
            else:
                spell = ini + base.replace("v", "u") \
                    if ini in ("j", "q", "x", "y") else ini + base
            syls.append(spell + tone)
            units.append([ini, fin])
        if ok:
            for syl, us in zip(syls, units):
                if pinyin.syllable_to_units(syl) != us:
                    ok = False
                    break
        if ok and syls:
            lex_entries.append((w, syls, units))
    return lex_entries


def make_babble_track(
    words: list[str],
    pinyin,
    duration_s: float,
    n_talkers: int = 6,
    rate: int = 16000,
    seed: int = 0,
) -> np.ndarray:
    """Synthesize a babble-noise track: ``n_talkers`` independent
    synthetic speakers talking simultaneously (each an endless stream of
    random words), overlap-added and RMS-normalized — the synthesized
    analogue of the NOISEX-92 "babble" channel.  Used by the noisy-
    channel WER evaluation (``benchmarks/wer_run.py --noise-snr``)."""
    rng = np.random.default_rng(seed)
    entries = _synthesizable_entries(words, pinyin)
    if not entries:
        raise ValueError("no synthesizable words for babble")
    n = int(duration_s * rate)
    track = np.zeros(n, np.float64)
    for _ in range(n_talkers):
        spk = Speaker.random(rng)
        at = 0
        while at < n:
            k = int(rng.integers(1, 4))
            idx = rng.choice(len(entries), size=k)
            syl_units = [u for j in idx for u in entries[j][2]]
            sig = synth_utterance(syl_units, spk, rng, rate=rate)
            end = min(n, at + len(sig))
            track[at:end] += sig[: end - at]
            at = end
    rms = float(np.sqrt(np.mean(track ** 2)))
    if rms > 0:
        track /= rms
    return track.astype(np.float32)


def mix_at_snr(
    sig: np.ndarray,
    noise: np.ndarray,
    snr_db: float,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Add ``noise`` to ``sig`` at a target SNR in dB.  Speech power is
    measured over active samples (above 2% of peak — the synthesized
    utterances carry long lead/trail silences that would otherwise
    deflate it); noise power over the slice actually used.  A random
    offset into ``noise`` decorrelates utterances sharing one track."""
    sig = np.asarray(sig, np.float64)
    noise = np.asarray(noise, np.float64)
    if rng is None:
        rng = np.random.default_rng(0)
    if len(noise) < len(sig):
        reps = -(-len(sig) // len(noise))
        noise = np.tile(noise, reps)
    off = int(rng.integers(0, len(noise) - len(sig) + 1))
    nz = noise[off: off + len(sig)]
    active = np.abs(sig) > 0.02 * (np.max(np.abs(sig)) + 1e-12)
    p_sig = float(np.mean(sig[active] ** 2)) if active.any() \
        else float(np.mean(sig ** 2))
    p_nz = float(np.mean(nz ** 2)) + 1e-12
    scale = np.sqrt(p_sig / (p_nz * 10.0 ** (snr_db / 10.0)))
    return (sig + scale * nz).astype(np.float32)


def generate_formant_corpus(
    out_dir: str,
    words: list[str],
    pinyin,
    num_utts: int = 200,
    words_per_utt: tuple[int, int] = (2, 6),
    n_speakers: int = 8,
    rate: int = 16000,
    seed: int = 0,
    zipf: float = 1.0,
    sil_token: str | None = None,
    markov_order: int = 0,
    grammar_seed: int | None = None,
) -> tuple[str, str, list[tuple[str, list[str]]]]:
    """Write a THCHS-30-style corpus: ``record/utt*.wav`` plus
    ``label/utt*.wav.trn`` with line 0 = the word sequence (space
    separated) and line 1 = toned pinyin syllables (the
    ``label_format='pinyin'`` training line, ``load_line=1``).

    Word frequencies follow a Zipf-ish distribution so the bigram LM has
    structure.  Returns ``(audio_dir, label_dir, transcripts)`` where
    transcripts are ``(utt_name, [words])``.

    :param sil_token: when set (e.g. ``"sil"``), the pinyin label line
        marks the utterance-boundary and inter-word pauses with this
        token, enabling explicit silence-model training (the token is a
        *unit name*, passed through by ``Corpus._encode_label``).
    :param markov_order: transcript structure.  0 (default): words drawn
        i.i.d. from the Zipf marginal — only unigram statistics exist,
        so any N-gram above order 1 is informationless by construction.
        2: sentences built from a seeded 3-word collocation inventory
        whose middle words share a small pool — after a middle word the
        bigram splits mass across every phrase sharing it, while the
        two-word history resolves the continuation exactly (see the
        grammar block in the function body).
    :param grammar_seed: seed of the second-order grammar (defaults to
        ``seed``).  Train and test corpora with different ``seed``
        values must share ``grammar_seed`` so held-out sentences follow
        the grammar the LM is trained on.
    """
    rng = np.random.default_rng(seed)
    audio_dir = os.path.join(out_dir, "record")
    label_dir = os.path.join(out_dir, "label")
    os.makedirs(audio_dir, exist_ok=True)
    os.makedirs(label_dir, exist_ok=True)

    lex_entries = _synthesizable_entries(words, pinyin)
    if not lex_entries:
        raise ValueError("no synthesizable words")
    # Zipf weights over the vocabulary
    ranks = np.arange(1, len(lex_entries) + 1, dtype=np.float64)
    weights = ranks ** (-zipf)
    weights /= weights.sum()

    n_lex = len(lex_entries)
    g_seed = seed if grammar_seed is None else grammar_seed

    # second-order grammar = a collocation inventory: 3-word phrases
    # (first, middle, last) whose MIDDLE words come from a small shared
    # pool.  After a middle word a bigram splits its mass across every
    # phrase sharing that middle; the (first, middle) history resolves
    # the continuation exactly, and a Zipf distribution over phrases
    # keeps the informative histories frequent enough to learn.  This
    # is the measurable target for order-3 decoding/rescoring (the
    # reference builds Ngram(k) per order, Decoder.py:201-204, but
    # never applies more than one word of context).
    if markov_order >= 2 and n_lex >= 8:
        g = np.random.default_rng(g_seed)
        # small middle pool + distinct (first, last) pairs per middle,
        # sampled UNIFORMLY: every middle has several comparably
        # frequent continuations, so the bigram's P(. | mid) stays
        # genuinely ambiguous while each (first, mid) history is seen
        # often enough to learn (a Zipf over phrases lets one phrase
        # dominate each middle and the bigram nearly resolves it)
        n_mid = max(3, n_lex // 20)
        mids = g.choice(n_lex, size=n_mid, replace=False)
        n_phrase = max(8, n_lex // 2)
        firsts = g.integers(0, n_lex, size=n_phrase)
        lasts = g.permutation(n_phrase) % n_lex  # distinct per phrase
        phrases = np.stack([
            firsts,
            mids[np.arange(n_phrase) % n_mid],
            lasts,
        ], axis=1)
        # homophone minimal pairs: when the vocabulary contains words
        # with identical unit sequences (exact homophones — the
        # Mandarin hanzi-selection problem), plant phrase pairs
        # (f1, m, h1) / (f2, m, h2) sharing the middle: after m the
        # bigram TIES between the family members by construction and
        # only the two-word history (f, m) picks the hanzi — the
        # workload for order-3 sausage rescoring (decoder/rescore.py)
        fam: dict[tuple, list[int]] = {}
        for idx, (_, _, us) in enumerate(lex_entries):
            key = tuple(u for syl in us for u in syl)  # flat unit seq
            fam.setdefault(key, []).append(idx)
        pairs = [v[:2] for v in fam.values() if len(v) >= 2]
        g.shuffle(pairs)
        n_conf = min(len(pairs), n_phrase // 4)
        for p_i in range(n_conf):
            h1, h2 = pairs[p_i]
            m = int(mids[g.integers(n_mid)])
            f1 = int(g.integers(n_lex))
            f2 = int((f1 + 1 + g.integers(n_lex - 1)) % n_lex)
            phrases[2 * p_i] = (f1, m, h1)
            phrases[2 * p_i + 1] = (f2, m, h2)

    def _sample_sentence(k: int) -> list[int]:
        if markov_order < 2 or n_lex < 8:
            return list(rng.choice(n_lex, size=k, p=weights))
        out: list[int] = []
        while len(out) < k:
            if rng.uniform() < 0.8:
                out.extend(int(x) for x in
                           phrases[rng.integers(n_phrase)])
            else:
                out.append(int(rng.choice(n_lex, p=weights)))
        return out[:k]

    speakers = [Speaker.random(rng) for _ in range(n_speakers)]
    transcripts: list[tuple[str, list[str]]] = []
    for i in range(num_utts):
        k = int(rng.integers(words_per_utt[0], words_per_utt[1] + 1))
        idx = _sample_sentence(k)
        chosen = [lex_entries[j] for j in idx]
        syl_units = [u for (_, _, units) in chosen for u in units]
        # inter-word pause plan: pauses allowed after word-final
        # syllables only, so the sil labels align with the word stream
        n_syl = len(syl_units)
        word_end = set()
        at = -1
        for (_, syls, _) in chosen:
            at += len(syls)
            word_end.add(at)
        pause_after = [
            (j in word_end) and bool(rng.uniform() < 0.15)
            for j in range(n_syl)
        ]
        spk = speakers[i % n_speakers]
        sig = synth_utterance(syl_units, spk, rng, rate=rate,
                              pause_after=pause_after)
        name = f"utt{i:05d}"
        wav_io.write_wav(os.path.join(audio_dir, name + ".wav"), sig, rate)
        word_line = " ".join(w for (w, _, _) in chosen)
        syl_tokens: list[str] = []
        if sil_token:
            syl_tokens.append(sil_token)
        j = 0
        for (_, syls, _) in chosen:
            syl_tokens.extend(syls)
            j += len(syls)
            if sil_token and pause_after[j - 1] and j < n_syl:
                syl_tokens.append(sil_token)
        if sil_token:
            syl_tokens.append(sil_token)
        pinyin_line = " ".join(syl_tokens)
        with open(os.path.join(label_dir, name + ".wav.trn"), "w") as f:
            f.write(word_line + "\n" + pinyin_line + "\n")
        transcripts.append((name, [w for (w, _, _) in chosen]))
    return audio_dir, label_dir, transcripts
