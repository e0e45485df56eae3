"""Corpus handling: unit inventories, label files, batching (port of
``poccala_tpu/io/corpus.py``).

The host code is copied from the JAX module, which imports the JAX
frontend; ``tests/test_torch_lexicon.py`` and ``tests/test_torch_train.py``
pin the copies to the originals:

* the standard Mandarin IF / XIF / XIF_tone phone sets and the
  reference's unit-file format (``AcousticModel.py:134-162``);
* corpus scanning (``<name>.wav`` + ``<name>.wav.trn``), per-job
  sharding and label parsing (``AcousticModel.py:443-461, 664-681``);
* :class:`Corpus`: WAV -> MFCC+Δ+ΔΔ -> VAD packing through the port's
  frontend and VAD on the corpus's device, padded into fixed-shape
  :class:`Batch`es — per utterance (``corpus.py:241-257``), or a batch at
  a time with the WAVs decoded by the native loader
  (:mod:`poccala_tpu_torch.native`, a g++-built ctypes library) and the
  frontend and VAD batched (``corpus.py:259-315``);
* the synthetic corpus the tests and benchmarks train on.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from poccala_tpu_torch.config import Config
from poccala_tpu_torch.io import wav as wav_io
from poccala_tpu_torch.ops import vad as vad_ops
from poccala_tpu_torch.ops.frontend import Frontend
from poccala_tpu_torch.utils.device import resolve
from poccala_tpu_torch.utils.errors import UnitFileError

# Standard Mandarin pinyin phone sets (the linguistic inventories behind
# the reference's AcousticModel/Unit/{IF,XIF,XIF_tone} files).
INITIALS = [
    "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h",
    "j", "q", "x", "zh", "ch", "sh", "z", "c", "s", "r",
]
ZERO_INITIALS = ["#_a", "#_o", "#_e", "#_I", "#_u", "#_v"]
FINALS = [
    "a", "o", "e", "i", "u", "v", "ai", "ei", "ao", "ou", "er",
    "an", "en", "in", "un", "vn", "ang", "eng", "ing", "ong",
    "ia", "ie", "iao", "iu", "ian", "iang", "iong",
    "ua", "uo", "uai", "ui", "uan", "uang", "ue", "ve",
]
TONES = ["0", "1", "2", "3", "4"]


def standard_inventory(kind: str = "XIF_tone") -> list[str]:
    """Programmatic IF / XIF / XIF_tone unit inventories."""
    if kind == "IF":
        return INITIALS + ["#"] + FINALS
    if kind == "XIF":
        return INITIALS + ZERO_INITIALS + FINALS
    if kind == "XIF_tone":
        finals = [f + t for f in FINALS for t in TONES]
        return INITIALS + ZERO_INITIALS + finals
    raise UnitFileError(f"unknown inventory kind: {kind!r}")


@dataclass
class UnitInventory:
    """Unit set with name<->id maps (the ``loaded_units`` list plus the
    senone indexing scheme of the bank)."""

    units: list[str]

    def __post_init__(self):
        self.id_of = {u: i for i, u in enumerate(self.units)}

    def __len__(self):
        return len(self.units)

    @classmethod
    def from_file(cls, path: str) -> "UnitInventory":
        """Parse the reference unit-file format: one header line, then
        comma-separated unit rows (``AcousticModel.py:151-161``)."""
        if not os.path.exists(path):
            raise UnitFileError(f"unit file not found: {path}")
        units: list[str] = []
        with open(path) as f:
            f.readline()  # header
            for line in f:
                line = line.strip("\n")
                if not line:
                    continue
                units.extend(u for u in line.split(",") if u)
        return cls(units)

    @classmethod
    def standard(cls, kind: str = "XIF_tone") -> "UnitInventory":
        return cls(standard_inventory(kind))

    def save(self, path: str, header: str = "units") -> None:
        with open(path, "w") as f:
            f.write(header + "\n")
            f.write(",".join(self.units) + "\n")

    def encode(self, names: list[str]) -> list[int]:
        return [self.id_of[n] for n in names]


# ----------------------------------------------------------------------
# Corpus scanning / label parsing
# ----------------------------------------------------------------------

def scan_corpus(audio_dir: str, label_dir: str) -> list[tuple[str, str]]:
    """Pair ``<name>.wav`` with ``<name>.wav.trn``
    (``AcousticModel.init_audio``, ``AcousticModel.py:443-461``)."""
    pairs = []
    for root, _, files in os.walk(audio_dir):
        for fname in sorted(files):
            if not fname.endswith(".wav"):
                continue
            name = fname[: -len(".wav")]
            label = os.path.join(label_dir, name + ".wav.trn")
            pairs.append((os.path.join(root, fname), label))
    return pairs


def shard_pairs(pairs: list, job_id: int, task_num: int) -> list:
    """Contiguous per-job shard (``Task.split_data``, ``Controller.py:79-106``)."""
    if task_num <= 1:
        return pairs
    chunk = len(pairs) // task_num
    start = job_id * chunk
    end = start + chunk if job_id < task_num - 1 else len(pairs)
    return pairs[start:end]


def read_label(path: str, load_line: int = 0) -> list[str]:
    """Read the unit row of a ``.trn`` label file
    (``AcousticModel.__generator``, ``AcousticModel.py:671-679``)."""
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[load_line].strip().split(" ")


# ----------------------------------------------------------------------
# Batching
# ----------------------------------------------------------------------

@dataclass
class Batch:
    """One padded utterance batch."""

    feats: np.ndarray       # [B, T, D] float32
    t_masks: np.ndarray     # [B, T] bool
    labels: np.ndarray      # [B, L] int32
    label_lens: np.ndarray  # [B] int32


class Corpus:
    """Feature-extracting corpus iterator.

    The per-utterance pipeline (``AcousticModel.__load_audio``,
    ``AcousticModel.py:463-477``): WAV → stereo merge → MFCC+Δ+ΔΔ → VAD
    packing; then padding into fixed-shape batches.  The frontend and VAD
    run on ``device`` (the card when None, ``utils/device.py``); batches
    are host arrays.
    """

    def __init__(self, cfg: Config, inventory: UnitInventory,
                 pairs: list[tuple[str, str]] | None = None, device=None):
        self.cfg = cfg
        self.inventory = inventory
        if pairs is None:
            pairs = scan_corpus(cfg.paths.audio_file_path,
                                cfg.paths.label_file_path)
            pairs = shard_pairs(pairs, cfg.paths.env_id, cfg.train.task_num)
        self.pairs = pairs
        self.frontend = Frontend(cfg.frontend, device=resolve(device))
        self._pinyin = None
        if cfg.train.label_format == "pinyin":
            from poccala_tpu_torch.lexicon.pinyin import PinYin

            self._pinyin = PinYin()

    def _encode_label(self, names: list[str]) -> list[int]:
        """Label tokens -> unit ids, converting pinyin syllables to
        units first in 'pinyin' label format (THCHS-30 style).

        Conversion wins over unit-name pass-through: a token whose G2P
        conversion lands entirely in the inventory uses the converted
        units even when the token itself names a unit — ``er4`` is both
        the XIF_tone final and a spellable syllable, and the syllable
        reading (``#_e, er4``) is what the audio contains and what the
        decode lexicon compiles (``PinYin.word2pinyin``), so labels
        must match it (pre-r05 the unit name won and the zero-initial
        unit silently vanished from training labels).  Pass-through
        remains the fallback for non-convertible unit tokens — the
        trained ``sil`` silence model's label token."""
        if self._pinyin is not None:
            units: list[str] = []
            for syl in names:
                conv = self._pinyin.syllable_to_units(syl)
                if all(u in self.inventory.id_of for u in conv):
                    units.extend(conv)
                elif syl in self.inventory.id_of:
                    units.append(syl)
                else:
                    # unknown either way: keep the token so encode()
                    # raises KeyError -> bad-data discard upstream
                    units.append(syl)
            names = units
        return self.inventory.encode(names)

    def load_utterance(self, wav_path: str, label_path: str):
        data, rate = wav_io.load_wav(wav_path)
        signal = wav_io.preprocess_signal(
            data, drop_zeros=self.cfg.frontend.reference_quirks
        )
        feats, mask = self.frontend.mfcc(signal)
        if self.cfg.frontend.vad:
            keep = vad_ops.vad_mask(
                feats, mask,
                sample_size=self.cfg.frontend.vad_sample_size,
                alpha=self.cfg.frontend.vad_alpha,
                beta=self.cfg.frontend.vad_beta,
            )
        else:
            keep = mask
        packed, n = vad_ops.apply_mask(
            feats, keep, max_frames=self.cfg.train.max_frames
        )
        names = read_label(label_path, self.cfg.train.load_line)
        label_ids = self._encode_label(names)
        return packed, n, label_ids

    def batches(self, batch_size: int | None = None, drop_last: bool = False,
                use_native: bool | None = None):
        """Yield :class:`Batch` objects over the (sharded) corpus.

        With the native loader available (``use_native=None`` auto), WAV
        decoding runs in the C++ thread pool and the MFCC+VAD pipeline
        runs batched on the corpus's device; otherwise utterances load one
        at a time.  ``use_native=True`` without a working g++ raises."""
        if use_native is None:
            from poccala_tpu_torch import native

            use_native = native.available()
        if use_native:
            yield from self._batches_native(batch_size, drop_last)
            return
        bs = batch_size or self.cfg.train.batch_size
        t_max = self.cfg.train.max_frames
        l_max = self.cfg.train.max_label_len
        d = self.cfg.frontend.feat_dim
        buf: list[tuple[np.ndarray, int, list[int]]] = []
        for wav_path, label_path in self.pairs:
            try:
                buf.append(self.load_utterance(wav_path, label_path))
            except (KeyError, FileNotFoundError, IndexError):
                # unknown unit in label / missing label: discard the
                # utterance (bad-data discard, AcousticModel.py:751-757)
                continue
            if len(buf) == bs:
                yield self._pack(buf, bs, t_max, l_max, d)
                buf = []
        if buf and not drop_last:
            yield self._pack(buf, bs, t_max, l_max, d)

    def _batches_native(self, batch_size: int | None, drop_last: bool):
        """Native batch WAV load + batched frontend and VAD."""
        from poccala_tpu_torch import native

        fcfg = self.cfg.frontend
        bs = batch_size or self.cfg.train.batch_size
        t_max = self.cfg.train.max_frames
        l_max = self.cfg.train.max_label_len
        d = fcfg.feat_dim
        max_samples = (t_max - 1) * fcfg.frame_step + fcfg.frame_size

        for start in range(0, len(self.pairs), bs):
            chunk = self.pairs[start: start + bs]
            if len(chunk) < bs and drop_last:
                break
            labels_ok, label_ids = [], []
            for _, label_path in chunk:
                try:
                    names = read_label(label_path, self.cfg.train.load_line)
                    label_ids.append(self._encode_label(names))
                    labels_ok.append(True)
                except (KeyError, FileNotFoundError, IndexError):
                    label_ids.append([])
                    labels_ok.append(False)
            signals, lengths, _ = native.load_wav_batch(
                [p for p, _ in chunk], max_samples,
                drop_zeros=fcfg.reference_quirks,
            )
            keep = [i for i in range(len(chunk))
                    if labels_ok[i] and lengths[i] > fcfg.frame_size]
            if not keep:
                continue
            signals = signals[keep]
            lengths = lengths[keep]
            label_ids = [label_ids[i] for i in keep]
            feats, masks = self.frontend.mfcc_batch(
                signals, lengths.astype(np.int64))
            if fcfg.vad:
                keep_masks = vad_ops.vad_mask_batch(
                    feats, masks,
                    sample_size=fcfg.vad_sample_size,
                    alpha=fcfg.vad_alpha, beta=fcfg.vad_beta,
                )
            else:
                keep_masks = masks
            feats_np = feats.cpu().numpy()
            keep_np = keep_masks.cpu().numpy()
            buf = []
            for i in range(len(feats_np)):
                packed, n = vad_ops.apply_mask(
                    feats_np[i], keep_np[i], max_frames=t_max
                )
                buf.append((packed, n, label_ids[i]))
            yield self._pack(buf, bs, t_max, l_max, d)

    @staticmethod
    def _pack(buf, bs, t_max, l_max, d) -> Batch:
        b = len(buf)
        feats = np.zeros((b, t_max, d), np.float32)
        t_masks = np.zeros((b, t_max), bool)
        labels = np.zeros((b, l_max), np.int32)
        lens = np.zeros((b,), np.int32)
        for i, (packed, n, label_ids) in enumerate(buf):
            feats[i] = packed
            t_masks[i, :n] = True
            ll = min(len(label_ids), l_max)
            labels[i, :ll] = label_ids[:ll]
            lens[i] = ll
        return Batch(feats=feats, t_masks=t_masks, labels=labels,
                     label_lens=lens)


# ----------------------------------------------------------------------
# Synthetic corpus (tests / bench: the repo ships no audio corpus)
# ----------------------------------------------------------------------

def synth_unit_signal(unit_id: int, n: int, rate: int, rng) -> np.ndarray:
    """A distinct spectral signature per unit: two harmonics whose
    frequencies encode the unit id, plus noise."""
    t = np.arange(n) / rate
    f0 = 150.0 + 37.0 * (unit_id % 17)
    f1 = 900.0 + 83.0 * (unit_id % 11)
    sig = (
        4000 * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6.28))
        + 2000 * np.sin(2 * np.pi * f1 * t + rng.uniform(0, 6.28))
        + 300 * rng.normal(size=n)
    )
    return sig


def generate_synthetic_corpus(
    out_dir: str,
    inventory: UnitInventory,
    num_utts: int = 32,
    units_per_utt: tuple[int, int] = (2, 5),
    unit_seconds: float = 0.25,
    rate: int = 16000,
    seed: int = 0,
) -> tuple[str, str]:
    """Write a synthetic WAV+label corpus in the reference's directory
    layout.  Returns (audio_dir, label_dir)."""
    rng = np.random.default_rng(seed)
    audio_dir = os.path.join(out_dir, "record")
    label_dir = os.path.join(out_dir, "label")
    os.makedirs(audio_dir, exist_ok=True)
    os.makedirs(label_dir, exist_ok=True)
    n_unit = int(unit_seconds * rate)
    for i in range(num_utts):
        l = rng.integers(units_per_utt[0], units_per_utt[1] + 1)
        unit_ids = rng.integers(0, len(inventory), size=l)
        sig = np.concatenate(
            [synth_unit_signal(int(u), n_unit, rate, rng) for u in unit_ids]
        )
        name = f"utt{i:05d}"
        wav_io.write_wav(os.path.join(audio_dir, name + ".wav"), sig, rate)
        with open(os.path.join(label_dir, name + ".wav.trn"), "w") as f:
            f.write(" ".join(inventory.units[u] for u in unit_ids) + "\n")
    return audio_dir, label_dir
