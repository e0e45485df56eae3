"""Typed configuration for the framework.

Replaces the reference's two-tier config (``config.ini`` -> ``os.environ``
in ``init.py:47-62`` plus the module-level ``args`` hyperparameter dict,
``init.py:27-43``) with one typed, layered dataclass:

* defaults in code,
* optional INI file override (same section/key layout as the reference's
  ``config.ini`` so existing configs keep working),
* optional CLI ``--key=value`` overrides (the reference had no CLI flags;
  SURVEY.md §5 flags this as a gap to fix).
"""

from __future__ import annotations

import configparser
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any


@dataclass
class PathsConfig:
    """Filesystem layout (reference ``config.ini:1-27`` / ``init.py:18-23``)."""

    unit_file_path: str = "./units"
    parameters_file_path: str = "./parameters"
    log_file_path: str = "./parameters"
    audio_file_path: str = "./data/record"
    label_file_path: str = "./data/label"
    env_id: int = 0  # machine id (reference ``config.ini:26``); job index


@dataclass
class FrontendConfig:
    """MFCC + VAD frontend (reference ``AudioProcessing.py:99-543``)."""

    sample_rate: int = 16000
    frame_time_s: float = 0.025     # 25 ms frames (AudioProcessing.py:201)
    frame_overlap: float = 0.5      # 50% hop    (AudioProcessing.py:201)
    nfft: int = 512                 # rFFT size  (AudioProcessing.py:249)
    # compute |rFFT| as one concatenated MXU matmul against the DFT
    # basis instead of the XLA FFT op (~2.6x faster on TPU for these
    # sizes, matches rfft to ~1e-4 relative).  (A Pallas frontend
    # kernel was retired in r05 as a measured negative result — the
    # XLA matmul path beat it at every production shape; see ROADMAP.)
    matmul_dft: bool = True
    # matmul precision for the frontend dots when matmul_dft
    # (benchmarks/frontend_opt.json, on-chip): 'highest' = 6-pass
    # f32-exact (default — the only mode inside the 3e-4 feature-
    # accuracy bar); 'high' = bf16_3x, 1.13-1.23x the pipeline but
    # 0.025 abs max feature error (high-frequency DFT bins cancel, and
    # log amplifies their relative error) — acceptable only for
    # throughput-first serving; 'default' = one bf16 pass, 0.28-0.38
    # abs (known-bad control, never for training/parity)
    dot_precision: str = "highest"
    pre_emphasis: float = 0.98      # (AudioProcessing.py:184)
    hamming_alpha: float = 0.46     # (AudioProcessing.py:228)
    num_filters: int = 26           # mel filters (AudioProcessing.py:280)
    low_hz: float = 0.0
    high_hz: float | None = None    # defaults to sample_rate / 2
    dct_num: int = 13               # cepstral order (init.py:36)
    delta_1: bool = True            # +Δ   (init.py:37)
    delta_2: bool = True            # +ΔΔ  (init.py:38)
    delta_n: int = 2                # ±2-frame regression (AudioProcessing.py:401)
    energy_c0: bool = True          # c0 <- log frame energy (AudioProcessing.py:437-438)
    # Reference-numerics quirks, flag-gated (SURVEY.md §7 "hard parts" (b)):
    # the reference applies the Hamming window across the *frame* axis
    # (AudioProcessing.py:242-245) and deletes all zero samples on load
    # (AudioProcessing.py:176).  ``reference_quirks=True`` reproduces both
    # for parity; False uses the textbook pipeline.
    reference_quirks: bool = False
    # VAD (AudioProcessing.py:450-543)
    vad: bool = True
    vad_sample_size: int = 16       # noise estimated from first 16 frames
    vad_alpha: float = 0.5          # noise EMA
    vad_beta: float = 0.93          # OSF quantile
    # Optional per-utterance cepstral mean (and variance) normalization
    # — the textbook first remedy for channel/additive noise, absent
    # from the reference (its mfcc pipeline, AudioProcessing.py:416-448,
    # goes straight to deltas).  Masked mean over the true frames of
    # each utterance, subtracted from the cepstra (c0 included) before
    # Δ/ΔΔ; cmvn_var additionally scales to unit per-coefficient
    # variance.  Flag-gated off by default (capability addition).
    cmvn: bool = False
    cmvn_var: bool = False
    # Optional magnitude-domain spectral subtraction (Boll 1979; the
    # classical additive-noise remedy the reference lacks): the noise
    # magnitude spectrum is estimated from the first
    # ``vad_sample_size`` frames (the same lead-in window the VAD's
    # noise model uses, AudioProcessing.py:462-478), over-subtracted by
    # ``ss_alpha`` and floored at ``ss_floor`` of the noisy magnitude
    # (the standard musical-noise guard).  Applied to |DFT| before the
    # mel bank; flag-gated off (capability addition).
    spectral_subtraction: bool = False
    ss_alpha: float = 2.0
    ss_floor: float = 0.02
    # Optional pitch (F0) feature column — a capability the reference
    # lacks: MFCC is pitch-blind, so Mandarin tone contrasts are
    # unmodelable without it.  Autocorrelation F0 per frame, encoded as
    # voiced-gated scaled log2(f0/125 Hz); gets Δ/ΔΔ like the cepstra
    # (the deltas carry the tone contour slopes).
    pitch: bool = False
    pitch_low_hz: float = 60.0
    pitch_high_hz: float = 400.0
    pitch_voicing: float = 0.35     # normalized-autocorr voicing gate
    pitch_scale: float = 5.0        # match cepstral feature magnitudes

    @property
    def frame_size(self) -> int:
        return int(self.sample_rate * self.frame_time_s)

    @property
    def frame_step(self) -> int:
        return int(self.frame_size * self.frame_overlap)

    @property
    def feat_dim(self) -> int:
        """Total feature dimension (AcousticModel.py:84-88)."""
        d = self.dct_num + (1 if self.pitch else 0)
        if self.delta_2:
            return d * 3
        if self.delta_1:
            return d * 2
        return d


@dataclass
class ModelConfig:
    """Acoustic-model structure (reference ``init.py:27-43``)."""

    unit_type: str = "XIF_tone"
    state_num: int = 5              # states per unit HMM, 2 virtual (init.py:33)
    mix_level: int = 4              # initial GMM mixtures (init.py:34)
    max_mix_level: int = 13         # mixture growth ceiling (init.py:35)
    c_covariance: float = 1e-6      # covariance floor (init.py:30)
    # Relative (per-dimension) variance floor, flag-gated OFF to match
    # the reference's absolute 1e-6 floor (init.py:30, Clustering.py:
    # 641-645).  When > 0 the effective floor becomes
    # max(c_covariance, var_floor_scale * corpus_diag_var[d]) — the
    # standard LVCSR remedy (Kaldi --variance-floor style) for variance
    # collapse on starved senones.  With the reference floor, collapsed
    # dims reach 1/sigma^2 = 1e6 and per-frame log-densities of ~1e7,
    # where f32 (and the reference's own f32-contaminated t=0 forward
    # line, LHMM.py:342) loses whole nats per op; a relative floor
    # keeps |log b| ~ 1e2-1e3 and restores well-conditioned arithmetic.
    var_floor_scale: float = 0.0
    # 'textbook' uses the standard log-Gaussian normalizer
    # (-0.5*sum(log var)); 'reference' reproduces the reference's
    # deviation (-0.5*sum(var), util.py:29).  Parity tests target
    # 'reference'; production defaults to 'textbook'.
    gaussian_normalizer: str = "textbook"
    # Baum-Welch statistics exactness knobs (train/accumulators.py):
    # count_final_exit=True counts the HTK-style final-frame flow into
    # the sentence exit state so unit exit probabilities stay nonzero;
    # False reproduces the reference's statistics exactly
    # (LHMM.py:526-544, where the -inf-emission exit state starves exit
    # transitions).  bw_inner_iters>1 enables the reference's
    # per-utterance baulm_welch inner loop re-estimating the sentence pi
    # until dloglik <= 0.64 (LHMM.py:539).
    count_final_exit: bool = True
    bw_inner_iters: int = 1
    # GMM-scoring matmul operand dtype.  'float32' (default): fp32
    # operands with HIGHEST-precision dots (correctness requirement —
    # TPU f32 dots otherwise run one bf16 pass, catastrophic with
    # floor-level 1/σ² coefficients; see ops/gmm_score.py).
    # 'bfloat16': centered bf16 operands, one MXU pass — measured
    # 1.9-2.0x scoring TFLOP/s vs the f32 path at config-3/4 shapes
    # with 0.007-nat mean drift and zero Viterbi flips
    # (benchmarks/bf16_study.json); the whole-pipeline gain is small
    # because scoring is not the EM bottleneck at these scales.
    score_dtype: str = "float32"

    @property
    def emit_states(self) -> int:
        return self.state_num - 2


@dataclass
class TrainConfig:
    """Training-loop hyperparameters (reference ``init.py:27-43``,
    ``Controller.py:161-202``)."""

    task_num: int = 1               # machines / hosts (init.py:28)
    processes: int = 1              # per-host workers (init.py:31)
    load_line: int = 0              # label line in .trn files (init.py:32)
    # 'units': labels are unit sequences (the reference's format);
    # 'pinyin': labels are toned pinyin syllables (THCHS-30 style),
    # converted to units via the G2P transforms
    label_format: str = "units" 
    batch_size: int = 32            # utterances per device batch (new: TPU batching)
    max_frames: int = 512           # per-utterance frame budget (padded/bucketed)
    max_label_len: int = 32         # per-utterance unit budget (padded)
    epochs: int = 1
    # Baum-Welch stop deltas (LHMM.py:539, Clustering.py:706)
    hmm_converge_delta: float = 0.64
    gmm_converge_delta: float = 1.28
    max_bw_iters: int = 10
    max_em_iters: int = 20
    # Flat-start (init.py:39-42, AcousticModel.py:479-517)
    proportion: float = 0.05
    step: int = 25
    differentiation: bool = True
    coefficient: float = 0.25
    # SMEM (Clustering.py:483-577)
    smem: bool = True
    smem_c_max: int = 5
    # 'batched': whole-bank SMEM in O(1) device programs (production);
    # 'serial': the per-senone host loop (oracle; O(S) dispatches)
    smem_impl: str = "batched"
    add_mix: bool = False           # grow mixtures between rounds (Controller.py:153-159)
    seed: int = 0


@dataclass
class DecoderConfig:
    """Decode-time search knobs (the reference's beam pruning,
    ``Decoder.py:34,159-167``, in its TPU block-pruned form — see
    :class:`poccala_tpu_torch.decoder.device.DeviceBeamDecoder`)."""

    beam: float = 0.85              # host-tier keep fraction (Decoder.py:34)
    # Device tier block pruning: per frame only the ``active_blocks``
    # best-scoring blocks of ``block_size`` DFS-contiguous nodes run the
    # banded advance; 0 = exact dense search (default).  Worth enabling
    # for 10⁴⁺-node lexicons (benchmarks/scaling.json pruned rows).
    block_size: int = 1024
    active_blocks: int = 0
    # Sticky block selection (nats): an active block keeps its slot
    # unless a challenger beats it by this margin.  MEASURED NEGATIVE
    # on the trained-bank 37.5k-word sweep (benchmarks/
    # pruned_trained.json: +1-2pp WER at every width at 8 nats) — the
    # pruning collapse is genuine search-width starvation, not
    # selection thrash; widening active_blocks is what recovers
    # accuracy (8->16->32 blocks: +24.2 -> +11.1 -> +3.8pp vs exact).
    # Kept default-off as a tested research knob.
    prune_hysteresis: float = 0.0


@dataclass
class MeshConfig:
    """Device-mesh layout (SURVEY.md §7 step 6).

    ``data`` shards utterance batches (the reference's multi-machine data
    parallelism over pathInfo shards, Controller.py:79-106); ``state``
    shards the senone bank when it exceeds one chip's HBM (the reference's
    multi-machine unit partitioning, Controller.py:47-77)."""

    data_axis: int = -1             # -1: all devices on the data axis
    state_axis: int = 1


@dataclass
class Config:
    paths: PathsConfig = field(default_factory=PathsConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # ------------------------------------------------------------------
    @classmethod
    def from_ini(cls, path: str) -> "Config":
        """Load the reference's ``config.ini`` layout (sections LogFile /
        UnitFile / ParamFile / AudioFile / LabelFile / Environment,
        ``config.ini:1-27``) into the typed config; unknown keys error."""
        cfg = cls()
        if not os.path.exists(path):
            raise FileNotFoundError(f"config file not found: {path}")
        cp = configparser.ConfigParser()
        cp.read(path)
        mapping = {
            "log_file_path": ("paths", "log_file_path"),
            "unit_file_path": ("paths", "unit_file_path"),
            "parameters_file_path": ("paths", "parameters_file_path"),
            "audio_file_path": ("paths", "audio_file_path"),
            "label_file_path": ("paths", "label_file_path"),
            "env_id": ("paths", "env_id"),
        }
        for section in cp.sections():
            for key, value in cp.items(section):
                if not value:
                    continue
                if key in mapping:
                    group, attr = mapping[key]
                    cfg.set_by_path(f"{group}.{attr}", value)
                else:
                    cfg.set_by_path(key, value)
        return cfg

    def set_by_path(self, dotted: str, value: str | Any) -> None:
        """Set ``group.attr`` (or bare ``attr``, searched across groups)
        coercing strings to the field's annotated type."""
        if "." in dotted:
            group_name, attr = dotted.split(".", 1)
            group = getattr(self, group_name)
            if not hasattr(group, attr):
                raise KeyError(f"unknown config key: {dotted}")
            setattr(group, attr, _coerce(group, attr, value))
            return
        for group_name in ("paths", "frontend", "model", "train", "decoder",
                           "mesh"):
            group = getattr(self, group_name)
            if hasattr(group, dotted):
                setattr(group, dotted, _coerce(group, dotted, value))
                return
        raise KeyError(f"unknown config key: {dotted}")

    def apply_overrides(self, overrides: list[str]) -> None:
        """CLI ``key=value`` overrides, e.g. ``model.mix_level=8``."""
        for item in overrides:
            key, _, value = item.partition("=")
            if not _:
                raise ValueError(f"override must be key=value: {item!r}")
            self.set_by_path(key.strip(), value.strip())

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _coerce(obj: Any, attr: str, value: Any) -> Any:
    if not isinstance(value, str):
        return value
    current = getattr(obj, attr)
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    return value
