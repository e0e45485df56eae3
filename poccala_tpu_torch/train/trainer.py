"""Training orchestration: the two schemes of the reference's
``Task.auto`` (``Controller.py:161-202``), port of
``poccala_tpu/train/trainer.py``.

Scheme 1 (``Controller.py:167-173``, isolated-word style):
  1. init: uniform segmentation collects per-unit data; per-senone GMMs
     are k-means-initialized and EM-trained (``multi_training`` →
     ``__cal_gmm``), with SMEM on the init round
     (``AcousticModel.py:835``);
  2. re-estimation: Viterbi forced alignment re-collects the data, GMM EM
     re-runs; mixtures may grow between rounds, forcing k-means
     re-clustering (``AcousticModel.py:552-558``);
  3. each round ends with embedded training that re-estimates only the
     transition matrices (fix_code=2, ``AcousticModel.py:789-803``).

Scheme 2 (``Controller.py:174-178``, continuous-speech style): flat start
(global mean/covariance for every GMM), then embedded Baum-Welch over
sentence HMMs with all parameters free.

Device work runs where the bank lives: the E-step and alignment DP on the
CUDA kernels when the bank is on the GPU, k-means / EM / SMEM as batched
tensor programs over the senone axis.  Frame grouping and SMEM candidate
selection run on the host, as in the JAX package.

Not ported yet (ROADMAP.md Queue 1): the data-parallel / state-sharded
mesh (``mesh=`` raises).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from poccala_tpu.config import Config
from poccala_tpu_torch.io.corpus import Batch, UnitInventory
from poccala_tpu_torch.models import senone_bank as sb
from poccala_tpu_torch.ops import em as em_ops
from poccala_tpu_torch.ops import kmeans as km_ops
from poccala_tpu_torch.train import accumulators as acc
from poccala_tpu_torch.train import alignment as align
from poccala_tpu_torch.utils.errors import ModeError
from poccala_tpu_torch.utils.logging import get_logger
from poccala_tpu_torch.utils.logmath import masked_log


class Trainer:
    """Single-process trainer over a senone bank on ``device``.

    Randomness (the initial bank's means, the flat start's mixture
    offsets, k-means seeding, bucket shuffles, SMEM's splits) comes from
    ``generator``, a CPU ``torch.Generator`` (seeded from
    ``cfg.train.seed`` when None), so one seed gives one model on every
    device.

    ``mark``, when given, is called with a phase name as each scheme-1
    phase has been enqueued — ``"alignment"``, ``"grouping"``,
    ``"kmeans"``, ``"em"``, ``"smem"``, ``"transmat"`` — for timing.
    """

    def __init__(self, cfg: Config, inventory: UnitInventory,
                 generator: torch.Generator | None = None,
                 logger: logging.Logger | None = None, mesh=None,
                 device=None, mark: Callable[[str], None] | None = None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (sharded training) is not ported yet (ROADMAP.md "
                "Queue 1: parallel/ comes later)")
        self.cfg = cfg
        self.inventory = inventory
        self.device = torch.device(device if device is not None else "cpu")
        self.log = logger or get_logger("trainer", cfg.paths.env_id)
        self.generator = generator if generator is not None else \
            torch.Generator().manual_seed(cfg.train.seed)
        self.mark = mark or (lambda _: None)
        self.bank = sb.create_bank(len(inventory), cfg.model,
                                   cfg.frontend.feat_dim,
                                   generator=self.generator,
                                   device=self.device)
        self.mix_level = cfg.model.mix_level
        self.history: list[dict] = []
        # scheme-1 counters of the current round, copied into history
        self.round_info: dict = {}
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
    # Flat start (scheme 2 init)
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

    # ------------------------------------------------------------------
    # Scheme 2: embedded Baum-Welch epoch
    # ------------------------------------------------------------------

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
    # Scheme 1: segmentation / alignment + per-senone GMM training
    # ------------------------------------------------------------------

    def _collect_frames(self, batches: Sequence[Batch], init: bool):
        """Per-senone frame buckets from uniform segmentation (init) or
        Viterbi alignment (re-estimation), grouped on the host.

        :returns: (frames ``[S, cap, D]`` float32, mask ``[S, cap]``
            bool), host arrays
        """
        num_senones = self.bank.num_states
        mcfg = self.cfg.model
        all_labels, all_lens, all_pos, all_ok = [], [], [], []
        for batch in batches:
            if init:
                label_pos = align.uniform_label_pos(batch.label_lens,
                                                    batch.t_masks)
                ok = np.ones(len(batch.feats), bool)
            else:
                _, lp = align.align_batch(
                    self.bank, batch.labels, batch.label_lens, batch.feats,
                    batch.t_masks, self.state_num,
                    self.cfg.train.max_label_len,
                    normalizer=mcfg.gaussian_normalizer,
                    score_dtype=mcfg.score_dtype)
                label_pos = lp.cpu().numpy()
                ok = align.check_alignment(label_pos, batch.labels,
                                           batch.label_lens)
                if not ok.all():
                    self.log.warning(
                        "viterbi alignment failed for %d/%d utterances "
                        "(discarded)", int((~ok).sum()), len(ok))
            all_labels.append(batch.labels)
            all_lens.append(batch.label_lens)
            all_pos.append(label_pos)
            all_ok.append(ok)
        self.mark("alignment")

        # bucket capacity: generous share of the total frame budget
        total_frames = sum(int(b.t_masks.sum()) for b in batches)
        cap = max(256, min(8192, 4 * total_frames // max(num_senones, 1)))
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self.generator))
        frames, mask, dropped = align.group_frames_by_senone(
            np.concatenate([b.feats for b in batches]),
            np.concatenate(all_labels), np.concatenate(all_lens),
            np.concatenate(all_pos), num_senones, self.emit_states,
            max_frames_per_senone=cap,
            utt_ok=np.concatenate(all_ok),
            rng=np.random.default_rng(seed),
            senone_map=self.bank.senone_map.cpu().numpy(),
        )
        if dropped:
            self.log.warning(
                "senone frame buckets overflowed: %d frames subsampled away "
                "(cap=%d)", dropped, cap)
        self.round_info.update(cap=cap, dropped=dropped)
        self.mark("grouping")
        return frames, mask

    def fit_gmms(self, frames, mask, reinit: bool,
                 smem: bool = False) -> None:
        """k-means (re)init + grouped EM over all senones
        (``__cal_gmm``, ``AcousticModel.py:532-561``), then optionally one
        SMEM pass.  ``frames [S, F, D]`` / ``mask [S, F]`` are host arrays
        or tensors; they move to the bank's device once.

        Senones with fewer frames than the mixture count keep their old
        parameters (``AcousticModel.py:549-551``)."""
        mix = self.mix_level
        bank = self.bank
        dev = bank.means.device
        frames_t = torch.as_tensor(frames, dtype=torch.float32, device=dev)
        mask_t = torch.as_tensor(mask, device=dev).to(torch.bool)
        enough = mask_t.sum(dim=1) >= max(mix, 2)                  # [S]
        sel3 = enough[:, None, None]

        means, log_var, log_w = bank.means, bank.log_var, bank.log_w
        if reinit:
            kres = km_ops.kmeans_grouped(self.generator, frames_t, mask_t,
                                         k=mix)

            def pad_mix(a):  # zero-pad the mixture axis (dim 1) to max_mix
                return torch.nn.functional.pad(
                    a, (0, 0) * (a.dim() - 2) + (0, bank.max_mix - mix))

            means = torch.where(sel3, pad_mix(kres["means"]), means)
            log_var = torch.where(
                sel3, pad_mix(torch.log(kres["variances"])), log_var)
            log_w = torch.where(enough[:, None],
                                masked_log(pad_mix(kres["alpha"])), log_w)
        self.mark("kmeans")

        mix_mask = (torch.arange(bank.max_mix, device=dev) < mix) \
            .expand(bank.num_states, -1)
        params, _, iters = em_ops.em_fit_grouped(
            means, log_var, log_w, frames_t, mask_t, mix_mask,
            c_covariance=self.var_floor,
            converge_delta=self.cfg.train.gmm_converge_delta,
            max_iters=self.cfg.train.max_em_iters,
            normalizer=self.cfg.model.gaussian_normalizer)
        self.bank = sb.replace(
            bank,
            means=torch.where(sel3, params.means, bank.means),
            log_var=torch.where(sel3, params.log_var, bank.log_var),
            log_w=torch.where(enough[:, None], params.log_w, bank.log_w),
            mix_counts=torch.where(enough, mix, bank.mix_counts)
            .to(torch.int32))
        self.round_info.update(em_iters=int(iters.max()))
        self.mark("em")
        if smem:
            from poccala_tpu_torch.train.smem import smem_pass

            self.bank, n_accepted = smem_pass(self, frames_t, mask_t,
                                              enough.cpu().numpy())
            self.round_info.update(smem_accepted=n_accepted)
            if n_accepted:
                self.log.info("SMEM: %d split-merge moves accepted",
                              n_accepted)
            self.mark("smem")

    def scheme1_round(self, batches: Sequence[Batch], init: bool,
                      smem: bool | None = None,
                      reinit: bool | None = None) -> float:
        """One scheme-1 round: (re)segment → GMM training → embedded
        transmat re-estimation (``Task.auto`` mode-1 body,
        ``Controller.py:190-196``).

        ``reinit``: force (True) or forbid (False) the k-means re-seeding
        of the GMMs; ``None`` (default) auto-detects from mixture growth
        as the reference does (``AcousticModel.py:552-558``).  The CD
        retrain passes False (its leaves must start EM from their CI
        clones; see the JAX method's docstring)."""
        self.round_info = {}
        self._ensure_var_floor(batches)
        if reinit is None:
            reinit = init or bool(
                (self.bank.mix_counts != self.mix_level).any())
        frames, mask = self._collect_frames(batches, init=init)
        if smem is None:
            smem = init and self.cfg.train.smem
        self.fit_gmms(frames, mask, reinit=reinit, smem=smem)
        # embedded training with GMMs locked (fix_code=2)
        ll = self.scheme2_epoch(batches, update_gmm=False)
        self.mark("transmat")
        return ll

    # ------------------------------------------------------------------
    # Mixture growth (Controller.add_mix_level, Controller.py:153-159)
    # ------------------------------------------------------------------

    def add_mix_level(self) -> None:
        if self.mix_level < self.cfg.model.max_mix_level:
            self.mix_level += 1
            self.log.info("mixture level -> %d", self.mix_level)

    # ------------------------------------------------------------------
    # Auto loop (Task.auto, Controller.py:161-202)
    # ------------------------------------------------------------------

    def auto(self, batches: Sequence[Batch], t: int = 1, mode: int = 1,
             init: bool = True, add_mix: bool = False) -> list[float]:
        if mode not in (1, 2):
            raise ModeError(f"unknown training scheme: {mode}")
        logliks = []
        self._ensure_var_floor(batches)
        for round_idx in range(t):
            t0 = time.time()
            if mode == 1:
                ll = self.scheme1_round(batches, init=init)
            else:
                if init:
                    self.flat_start(batches)
                ll = self.scheme2_epoch(batches)
            logliks.append(ll)
            self.history.append({
                "mode": mode, "round": round_idx, "loglik": ll,
                "mix_level": self.mix_level, "seconds": time.time() - t0,
                **(self.round_info if mode == 1 else {}),
            })
            if add_mix and mode == 1:
                self.add_mix_level()
            init = False
        return logliks
