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

With ``mesh=`` (a ``(data, state)`` mesh of
:mod:`poccala_tpu_torch.parallel.mesh`) every rank runs the same trainer
on the same batches: the E-step is data-parallel with summed statistics,
and with ``state > 1`` the bank is padded and sharded over senones, so
each rank aligns, scores, fits and updates only its own GMM rows.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from poccala_tpu_torch.config import Config
from poccala_tpu_torch.utils.device import resolve
from poccala_tpu_torch.io.corpus import Batch, UnitInventory
from poccala_tpu_torch.models import senone_bank as sb
from poccala_tpu_torch.ops import em as em_ops
from poccala_tpu_torch.ops import kmeans as km_ops
from poccala_tpu_torch.train import accumulators as acc
from poccala_tpu_torch.train import alignment as align
from poccala_tpu_torch.utils import profiling
from poccala_tpu_torch.utils.errors import ModeError
from poccala_tpu_torch.utils.logging import get_logger
from poccala_tpu_torch.utils.logmath import masked_log


def fit_grouped(generator: torch.Generator, frames: torch.Tensor,
                mask: torch.Tensor, means, log_var, log_w, mix_counts,
                mix: int, reinit: bool, c_covariance=1e-6,
                converge_delta: float = 1.28, max_iters: int = 32,
                normalizer: str = "textbook", mark=None):
    """k-means (re)init + grouped EM of the senones of ``frames [S, F, D]``
    / ``mask [S, F]`` against GMMs ``means``, ``log_var``, ``log_w``,
    ``mix_counts`` (the same S rows; ``__cal_gmm``,
    ``AcousticModel.py:532-561``).  Senones with fewer frames than the
    mixture count keep their old parameters (``AcousticModel.py:549-551``).
    The k-means seeding draws from ``generator``.

    :returns: (means, log_var, log_w, mix_counts, EM iterations ``[S]``,
        enough ``[S]`` bool)"""
    mark = mark or (lambda _: None)
    max_mix = means.shape[1]
    enough = mask.sum(dim=1) >= max(mix, 2)                  # [S]
    sel3 = enough[:, None, None]
    old = (means, log_var, log_w)
    if reinit:
        kres = km_ops.kmeans_grouped(generator, frames, mask, k=mix)

        def pad_mix(a):  # zero-pad the mixture axis (dim 1) to max_mix
            return torch.nn.functional.pad(
                a, (0, 0) * (a.dim() - 2) + (0, max_mix - mix))

        means = torch.where(sel3, pad_mix(kres["means"]), means)
        log_var = torch.where(
            sel3, pad_mix(torch.log(kres["variances"])), log_var)
        log_w = torch.where(enough[:, None],
                            masked_log(pad_mix(kres["alpha"])), log_w)
    mark("kmeans")

    mix_mask = (torch.arange(max_mix, device=means.device) < mix) \
        .expand(means.shape[0], -1)
    params, _, iters = em_ops.em_fit_grouped(
        means, log_var, log_w, frames, mask, mix_mask,
        c_covariance=c_covariance, converge_delta=converge_delta,
        max_iters=max_iters, normalizer=normalizer)
    return (torch.where(sel3, params.means, old[0]),
            torch.where(sel3, params.log_var, old[1]),
            torch.where(enough[:, None], params.log_w, old[2]),
            torch.where(enough, mix, mix_counts).to(torch.int32),
            iters, enough)


class Trainer:
    """Trainer over a senone bank on ``device``, one per rank of ``mesh``.

    Randomness (the initial bank's means, the flat start's mixture
    offsets, k-means seeding, bucket shuffles, SMEM's splits) comes from
    ``generator``, a CPU ``torch.Generator`` (seeded from
    ``cfg.train.seed`` when None), so one seed gives one model on every
    device.

    ``mark``, when given, is called with a phase name as each scheme-1
    phase has been enqueued — ``"alignment"``, ``"grouping"``,
    ``"kmeans"``, ``"em"``, ``"smem"``, ``"transmat"`` — and in each
    embedded epoch (:meth:`scheme2_epoch`, also scheme 1's transmat epoch)
    as each batch's ``"scoring"``, ``"forward_backward"`` and
    ``"statistics"`` and the epoch's ``"m_step"`` have been, for timing.

    ``mesh``: a ``(data, state)`` mesh (:func:`poccala_tpu_torch.parallel.
    mesh.make_mesh`); ``device`` then defaults to the mesh's.  Every rank
    constructs the trainer with the same seed and passes it the same
    batches.  With ``state > 1`` ``self.bank`` is this rank's padded
    state shard and :meth:`export_bank` assembles the whole bank.
    """

    def __init__(self, cfg: Config, inventory: UnitInventory,
                 generator: torch.Generator | None = None,
                 logger: logging.Logger | None = None, mesh=None,
                 device=None, mark: Callable[[str], None] | None = None):
        self.cfg = cfg
        self.inventory = inventory
        if mesh is not None and device is None:
            from poccala_tpu_torch.parallel.mesh import mesh_device

            device = mesh_device(mesh)
        self.device = resolve(device)
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
        self.mesh = mesh
        self.state_shards = 1
        self._parallel_estep = None
        self._sharded_align_fn = None
        self.use_bank(self.bank)

    def use_bank(self, bank) -> None:
        """Take a whole bank (a fresh one, a loaded checkpoint): as it is
        without a mesh; replicated from rank 0, or padded and sharded over
        the state axis with ``state > 1``, on a mesh
        (``trainer.py:79-110``)."""
        self._s_orig = bank.num_states
        if self.mesh is None:
            self.bank = bank
            return
        from poccala_tpu_torch.parallel import mesh as pmesh

        cfg = self.cfg
        self.state_shards = pmesh.mesh_shape(self.mesh)["state"]
        kw = dict(normalizer=cfg.model.gaussian_normalizer,
                  count_final_exit=cfg.model.count_final_exit,
                  bw_inner_iters=cfg.model.bw_inner_iters,
                  score_dtype=cfg.model.score_dtype)
        if self.state_shards > 1:
            # model parallelism: the GMM tensors shard over senones
            # (Controller.py:47-77 unit partitioning); memory and scoring
            # scale as 1/state_shards
            bank, self._s_orig = pmesh.pad_bank_states(bank,
                                                       self.state_shards)
            self.bank = pmesh.shard_bank_states(bank, self.mesh)
            self._parallel_estep = pmesh.make_state_sharded_estep(
                self.mesh, cfg.model.state_num, cfg.train.max_label_len, **kw)
        else:
            self.bank = pmesh.replicate_bank(bank, self.mesh)
            self._parallel_estep = pmesh.make_parallel_estep(
                self.mesh, cfg.model.state_num, cfg.train.max_label_len, **kw)

    def export_bank(self):
        """The whole bank with the state-shard padding stripped, the same
        on every rank (for checkpointing / decoding); without state
        shards, ``self.bank`` itself."""
        if self.state_shards == 1:
            return self.bank
        from poccala_tpu_torch.parallel import mesh as pmesh

        return pmesh.unpad_bank_states(
            pmesh.unshard_bank_states(self.bank, self.mesh), self._s_orig)

    def _sharded_align(self):
        """The cached state-sharded forced-alignment function."""
        if self._sharded_align_fn is None:
            from poccala_tpu_torch.parallel import mesh as pmesh

            self._sharded_align_fn = pmesh.make_state_sharded_align(
                self.mesh, self.cfg.model.state_num,
                self.cfg.train.max_label_len,
                normalizer=self.cfg.model.gaussian_normalizer,
                score_dtype=self.cfg.model.score_dtype)
        return self._sharded_align_fn

    def _padded_batch(self, batch: Batch):
        """A batch's arrays padded to a multiple of the data axis, and its
        true size."""
        from poccala_tpu_torch.parallel.mesh import pad_batch_for_mesh

        return pad_batch_for_mesh((batch.labels, batch.label_lens,
                                   batch.feats, batch.t_masks), self.mesh)

    def _mix_changed(self) -> bool:
        """Whether any senone's mixture count differs from the level (the
        reference's re-clustering trigger).  The state-shard padding is
        not a senone: its ``mix_counts`` of 0 would re-seed every round,
        as the JAX trainer does (``trainer.py:456-459``), where the
        unpadded bank would not."""
        counts = self.bank.mix_counts
        if self.state_shards > 1:
            lo = self.mesh.get_local_rank("state") * self.bank.num_states
            counts = counts[:max(0, self._s_orig - lo)]
        return self._any_shard(bool((counts != self.mix_level).any()))

    def _any_shard(self, flag: bool) -> bool:
        """``flag`` of any state shard (the same answer on every rank)."""
        if self.state_shards == 1:
            return flag
        from poccala_tpu_torch.parallel.mesh import all_reduce

        t = torch.tensor([int(flag)], device=self.bank.means.device)
        return bool(all_reduce(t, torch.distributed.ReduceOp.MAX,
                               self.mesh.get_group("state")).item())

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
        with profiling.span("train.epoch", self.device):
            total = acc.zero_stats(self.bank)
            for batch in batches:
                if self._parallel_estep is not None:
                    arrays, _ = self._padded_batch(batch)
                    stats, _ = self._parallel_estep(self.bank, *arrays)
                else:
                    stats, _ = acc.batch_stats(
                        self.bank, batch.labels, batch.label_lens,
                        batch.feats, batch.t_masks, self.state_num,
                        self.cfg.train.max_label_len,
                        normalizer=mcfg.gaussian_normalizer,
                        count_final_exit=mcfg.count_final_exit,
                        bw_inner_iters=mcfg.bw_inner_iters,
                        score_dtype=mcfg.score_dtype, mark=self.mark)
                total = acc.add_stats(total, stats)
            with profiling.span("train.mstep", self.device):
                self.bank = acc.apply_update(
                    self.bank, total, c_covariance=self.var_floor,
                    update_transmat=update_transmat, update_gmm=update_gmm)
            self.mark("m_step")
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
        Viterbi alignment (re-estimation), grouped on the host.  With state
        shards the grouping runs over the global (padded) senones and each
        rank keeps its own rows.

        :returns: (frames ``[S, cap, D]`` float32, mask ``[S, cap]``
            bool), host arrays
        """
        num_senones = self.bank.num_states * self.state_shards
        mcfg = self.cfg.model
        all_labels, all_lens, all_pos, all_ok = [], [], [], []
        for batch in batches:
            if init:
                label_pos = align.uniform_label_pos(batch.label_lens,
                                                    batch.t_masks)
                ok = np.ones(len(batch.feats), bool)
            else:
                if self.state_shards > 1:
                    # the bank stays sharded: the score lattices are
                    # assembled by max, the full-S tensors never exist
                    arrays, b_true = self._padded_batch(batch)
                    _, lp = self._sharded_align()(self.bank, *arrays)
                    lp = lp[:b_true]
                else:
                    _, lp = align.align_batch(
                        self.bank, batch.labels, batch.label_lens,
                        batch.feats, batch.t_masks, self.state_num,
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
        if self.state_shards > 1:
            s_local = self.bank.num_states
            lo = self.mesh.get_local_rank("state") * s_local
            frames, mask = frames[lo: lo + s_local], mask[lo: lo + s_local]
        self.mark("grouping")
        return frames, mask

    def fit_gmms(self, frames, mask, reinit: bool,
                 smem: bool = False) -> None:
        """k-means (re)init + grouped EM over all senones
        (:func:`fit_grouped`), then optionally one SMEM pass.
        ``frames [S, F, D]`` / ``mask [S, F]`` (this rank's rows with state
        shards) are host arrays or tensors; they move to the bank's device
        once."""
        bank = self.bank
        dev = bank.means.device
        frames_t = torch.as_tensor(frames, dtype=torch.float32, device=dev)
        mask_t = torch.as_tensor(mask, device=dev).to(torch.bool)
        generator = self.generator
        if self.state_shards > 1:
            # independent per senone: each rank fits its own rows with its
            # shard's generator; no collective, no full-S tensor
            from poccala_tpu_torch.parallel.mesh import shard_generator

            generator = shard_generator(self.generator, self.mesh)
        means, log_var, log_w, mix_counts, iters, enough = fit_grouped(
            generator, frames_t, mask_t, bank.means, bank.log_var,
            bank.log_w, bank.mix_counts, self.mix_level, reinit,
            c_covariance=self.var_floor,
            converge_delta=self.cfg.train.gmm_converge_delta,
            max_iters=self.cfg.train.max_em_iters,
            normalizer=self.cfg.model.gaussian_normalizer, mark=self.mark)
        self.bank = sb.replace(bank, means=means, log_var=log_var,
                               log_w=log_w, mix_counts=mix_counts)
        self.round_info.update(em_iters=int(iters.max()))
        self.mark("em")
        if smem:
            from poccala_tpu_torch.train.smem import smem_pass

            self.bank, n_accepted = smem_pass(self, frames_t, mask_t,
                                              enough.cpu().numpy(),
                                              generator=generator)
            if self.state_shards > 1:
                from poccala_tpu_torch.parallel.mesh import all_reduce

                n_accepted = int(all_reduce(
                    torch.tensor([n_accepted], device=dev),
                    group=self.mesh.get_group("state")).item())
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
            reinit = init or self._mix_changed()
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
