"""Training orchestration, scheme 2 (port of
``poccala_tpu/train/trainer.py``).

Scheme 2 of the reference's ``Task.auto`` (``Controller.py:174-178``,
continuous-speech style): flat start (global mean/covariance for every
GMM), then embedded Baum-Welch over sentence HMMs with all parameters
free.  Each epoch maps the E-step over the corpus's batches
(:func:`~poccala_tpu_torch.train.accumulators.batch_stats`, with the DP
on the CUDA kernels when the bank is on the GPU), folds the statistics
with ``add_stats`` and applies one M-step.

Not ported yet (ROADMAP.md Queue 1): scheme 1 — uniform segmentation or
Viterbi realignment, k-means/EM/SMEM per senone and mixture growth
(``scheme1_round``, ``_collect_frames``, ``fit_gmms``,
``add_mix_level``) — and the data-parallel / state-sharded mesh.  They
raise ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import time
from typing import Iterable, Sequence

import numpy as np
import torch

from poccala_tpu.config import Config
from poccala_tpu_torch.io.corpus import Batch, UnitInventory
from poccala_tpu_torch.models import senone_bank as sb
from poccala_tpu_torch.train import accumulators as acc
from poccala_tpu_torch.utils.errors import ModeError
from poccala_tpu_torch.utils.logging import get_logger

_NOT_PORTED = ("is not ported yet (ROADMAP.md Queue 1: scheme-1 training "
               "and parallel/ come later)")


class Trainer:
    """Single-process trainer over a senone bank on ``device``.

    Randomness (the initial bank's means, the flat start's mixture
    offsets) comes from ``generator``, a CPU ``torch.Generator`` (seeded
    from ``cfg.train.seed`` when None), so one seed gives one model on
    every device."""

    def __init__(self, cfg: Config, inventory: UnitInventory,
                 generator: torch.Generator | None = None,
                 logger: logging.Logger | None = None, mesh=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(f"mesh= (sharded training) {_NOT_PORTED}")
        self.cfg = cfg
        self.inventory = inventory
        self.device = torch.device(device if device is not None else "cpu")
        self.log = logger or get_logger("trainer", cfg.paths.env_id)
        self.generator = generator if generator is not None else \
            torch.Generator().manual_seed(cfg.train.seed)
        self.bank = sb.create_bank(len(inventory), cfg.model,
                                   cfg.frontend.feat_dim,
                                   generator=self.generator,
                                   device=self.device)
        self.mix_level = cfg.model.mix_level
        self.history: list[dict] = []
        # the relative per-dim variance floor, once computed from data
        # (ModelConfig.var_floor_scale); None = the scalar c_covariance
        self._var_floor_vec: np.ndarray | None = None

    @property
    def var_floor(self):
        """Effective covariance floor: the reference's scalar
        ``c_covariance``, or the per-dim relative floor once
        :meth:`_ensure_var_floor` has seen data."""
        if self._var_floor_vec is not None:
            return self._var_floor_vec
        return self.cfg.model.c_covariance

    def _ensure_var_floor(self, batches: Sequence[Batch]) -> None:
        """Compute the relative floor from the corpus (flat-start
        subsample rule: ``proportion`` of batches, every ``step``-th
        frame) the first time training sees data.  No-op when the flag is
        off or the floor is already set."""
        if self.cfg.model.var_floor_scale <= 0 or \
                self._var_floor_vec is not None:
            return
        tcfg = self.cfg.train
        n_take = max(1, int(len(batches) * tcfg.proportion))
        frames = [b.feats[b.t_masks][:: tcfg.step]
                  for b in batches[:n_take]]
        x = np.concatenate(frames, axis=0)
        gv = np.maximum(x.var(axis=0), 1e-8)
        self._var_floor_vec = np.maximum(
            self.cfg.model.var_floor_scale * gv,
            self.cfg.model.c_covariance).astype(np.float32)
        self.log.info(
            "relative variance floor: scale=%g, floor range [%.3g, %.3g]",
            self.cfg.model.var_floor_scale,
            float(self._var_floor_vec.min()),
            float(self._var_floor_vec.max()))

    @property
    def state_num(self) -> int:
        return self.cfg.model.state_num

    @property
    def emit_states(self) -> int:
        return self.state_num - 2

    # ------------------------------------------------------------------
    def flat_start(self, batches: Sequence[Batch]) -> None:
        """Global mean/variance from a data subsample, broadcast to every
        senone (``__flat_start``, ``AcousticModel.py:479-517``):
        ``proportion`` of batches, every ``step``-th frame."""
        tcfg = self.cfg.train
        n_take = max(1, int(len(batches) * tcfg.proportion))
        x = np.concatenate([b.feats[b.t_masks][:: tcfg.step]
                            for b in batches[:n_take]], axis=0)
        mean = x.mean(axis=0)
        var = np.maximum(x.var(axis=0), 1e-4)
        self.bank = sb.flat_start(
            self.bank, torch.from_numpy(mean), torch.from_numpy(var),
            self.generator, coefficient=tcfg.coefficient,
            differentiation=tcfg.differentiation)
        self.log.info("flat start: %d frames -> global mean/cov", len(x))

    def scheme2_epoch(self, batches: Iterable[Batch],
                      update_gmm: bool = True,
                      update_transmat: bool = True) -> float:
        """One full embedded-BW EM step over the corpus
        (``embedded_training``, ``AcousticModel.py:842-882``)."""
        if isinstance(batches, Sequence):
            self._ensure_var_floor(batches)
        elif (self.cfg.model.var_floor_scale > 0
              and self._var_floor_vec is None):
            self.log.warning(
                "var_floor_scale set but batches is a generator; "
                "relative floor not computable here — still using the "
                "scalar c_covariance floor (pass a materialized batch "
                "list, or call _ensure_var_floor first)")
        mcfg = self.cfg.model
        total = acc.zero_stats(self.bank)
        for batch in batches:
            stats, _ = acc.batch_stats(
                self.bank, batch.labels, batch.label_lens, batch.feats,
                batch.t_masks, self.state_num, self.cfg.train.max_label_len,
                normalizer=mcfg.gaussian_normalizer,
                count_final_exit=mcfg.count_final_exit,
                bw_inner_iters=mcfg.bw_inner_iters,
                score_dtype=mcfg.score_dtype)
            total = acc.add_stats(total, stats)
        self.bank = acc.apply_update(
            self.bank, total, c_covariance=self.var_floor,
            update_transmat=update_transmat, update_gmm=update_gmm)
        ll = float(total.loglik)
        n = max(float(total.n_utts), 1.0)
        self.log.info("embedded BW epoch: loglik=%.2f (%.2f/utt over %d utts)",
                      ll, ll / n, int(n))
        return ll

    # ------------------------------------------------------------------
    def scheme1_round(self, *args, **kwargs) -> float:
        raise NotImplementedError(f"scheme1_round {_NOT_PORTED}")

    def _collect_frames(self, *args, **kwargs):
        raise NotImplementedError(f"_collect_frames {_NOT_PORTED}")

    def fit_gmms(self, *args, **kwargs) -> None:
        raise NotImplementedError(f"fit_gmms {_NOT_PORTED}")

    def add_mix_level(self) -> None:
        raise NotImplementedError(f"add_mix_level {_NOT_PORTED}")

    # ------------------------------------------------------------------
    def auto(self, batches: Sequence[Batch], t: int = 1, mode: int = 1,
             init: bool = True, add_mix: bool = False) -> list[float]:
        """The ``Task.auto`` loop (``Controller.py:161-202``); only
        ``mode=2`` is ported."""
        if mode == 1:
            raise NotImplementedError(f"training scheme 1 {_NOT_PORTED}")
        if mode != 2:
            raise ModeError(f"unknown training scheme: {mode}")
        logliks = []
        self._ensure_var_floor(batches)
        for round_idx in range(t):
            t0 = time.time()
            if init:
                self.flat_start(batches)
            ll = self.scheme2_epoch(batches)
            logliks.append(ll)
            self.history.append({
                "mode": mode, "round": round_idx, "loglik": ll,
                "mix_level": self.mix_level, "seconds": time.time() - t0,
            })
            init = False
        return logliks
