"""The timed loops, one a kind of traffic (``driver`` in a mix's file).

A driver builds the program's objects from the benchmark's inputs, warms
up every shape its cell's traffic uses (set-up), runs the measured window,
and afterwards judges what the window's program produced against the
plain reference.  ``DRIVERS`` maps a driver's name to its class.

* ``decode_offline``: the device decoder's ``decode_dispatch`` /
  ``decode_collect`` over fixed batches, double-buffered as the service
  does (call k + 1 enqueued before call k is collected);
* ``train_epochs``: ``Trainer.scheme2_epoch`` over the corpus, then
  ``align_batch`` over each batch with the new bank, the alignments copied
  to the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from asrbench.harness import ref_decode, ref_train, yardstick
from asrbench.harness.model import start_bank
from asrbench.harness.trace import Tracer
from asrbench.harness.traffic import make_batches

LOG_FLOOR = -100.0
BANK_FIELDS = ("means", "log_var", "log_w", "log_A", "log_pi", "mix_counts",
               "senone_map")


def program_bank(bank: dict):
    """The program's bank object over the benchmark's arrays (copies, so
    the program's updates never reach the inputs)."""
    from poccala_tpu_torch.models.senone_bank import SenoneBank

    return SenoneBank(**{k: bank[k].clone() for k in BANK_FIELDS})


def program_lexicon(lex):
    """The program's ``FlatLexicon`` over the benchmark's tree (word ``v``
    is the string ``w<v>``)."""
    from poccala_tpu_torch.lexicon.lexicon import FlatLexicon

    n = lex.n_nodes
    children = [[] for _ in range(n)]
    for c in range(1, n):
        children[int(lex.parent[c])].append(c)
    ptr = np.zeros(n + 1, np.int32)
    ptr[1:] = np.cumsum([len(c) for c in children])
    ids = np.asarray([c for cs in children for c in cs], np.int32)
    words = [[] for _ in range(n)]
    for v, nid in enumerate(lex.word_node):
        words[int(nid)].append(f"w{v}")
    return FlatLexicon(child_ptr=ptr, child_ids=ids,
                       node_units=lex.node_units.astype(np.int32),
                       node_syllable=[""] + [f"s{i}" for i in range(1, n)],
                       node_words=words)


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


class DecodeOffline:
    """Offline transcription: the exact (or block-pruned) device search."""

    LIBS = ("gmm_score", "decoder_scan")     # the program's CUDA libraries

    def __init__(self, model, bank, mix, seed, dev, tracer: Tracer,
                 score_dtype: str):
        from poccala_tpu_torch.decoder.device import DeviceBeamDecoder

        cfg = model.cfg
        dc = cfg["decoder"]
        self.model, self.bank, self.seed = model, bank, seed
        self.dev, self.tr = dev, tracer
        t0 = time.perf_counter()
        self.batches = make_batches(model, bank, mix, seed)
        _sync(dev)
        self.stamps = {"traffic_s": time.perf_counter() - t0}
        self.dec = DeviceBeamDecoder(
            program_bank(bank), program_lexicon(model.lexicon),
            max_words=dc["max_words"], word_penalty=dc["word_penalty"],
            active_blocks=dc.get("active_blocks"),
            block_size=dc.get("block_size", 1024),
            normalizer=cfg["gaussian_normalizer"], score_dtype=score_dtype)
        self.nbest = dc["return_nbest"]
        t0 = time.perf_counter()
        self.dec._prep_device()
        self.stamps["tables_s"] = time.perf_counter() - t0
        # set-up: every shape of the window (one, as every batch holds the
        # same lengths), through the window's own double-buffered calls
        t0 = time.perf_counter()
        self._run_calls(len(self.batches))
        _sync(dev)
        self.stamps["warmup_s"] = time.perf_counter() - t0

    def _counters(self):
        from poccala_tpu_torch.ops.cuda import decoder_scan_cuda as dk
        from poccala_tpu_torch.ops.cuda import gmm_score_cuda as gk

        return {r"decoder_scan_kernel": dk.decoder_scan_cuda.launches,
                r"decoder_pruned_kernel": dk.decoder_scan_pruned_cuda.launches,
                r"gmm_score_f32_kernel": gk.gmm_log_scores_cuda.launches
                - gk.gmm_log_scores_cuda.launches_bf16}

    def _run_calls(self, n_calls=None, seconds=None):
        tr, dec = self.tr, self.dec
        t0 = time.perf_counter()
        pending, k, audio = None, 0, 0.0
        self.answers = {}
        self.attempted = self.failed = 0
        while True:
            i = k % len(self.batches)
            bt = self.batches[i]
            with tr.span("decode_dispatch"):
                h = dec.decode_dispatch(bt.feats, bt.n_frames, self.nbest)
                ev = None
                if bt.feats.is_cuda:
                    ev = torch.cuda.Event()
                    ev.record()
            if pending is not None:
                # call k's copies queue behind call k + 1's kernels on the
                # one stream; waiting for those first leaves the span the
                # copies and the id -> word mapping
                audio += self._collect(*pending[:2], ev)
            pending = (h, i, ev)
            k += 1
            if n_calls is not None and k >= n_calls:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
        audio += self._collect(*pending)
        self.calls = k
        return audio, time.perf_counter() - t0

    def _collect(self, h, i, ev):
        if ev is not None:
            ev.synchronize()
        with self.tr.span("decode_collect"):
            got = self.dec.decode_collect(h)
        n = len(self.batches[i].n_frames)
        # an utterance with no hypothesis (or none returned) failed
        for u in range(n):
            self.answers[(i, u)] = got[u] if u < len(got) else []
            self.failed += not self.answers[(i, u)]
        self.attempted += n
        return self.batches[i].audio_s

    def window(self, seconds: float) -> dict:
        before = self._counters()
        with self.tr.profile():
            audio, wall = self._run_calls(seconds=seconds)
        self.tr.window_s = wall
        self.counted = {f: c - before[f] for f, c in self._counters().items()}
        return {"decode_audio_s_per_s": audio / wall}

    def work(self) -> dict:
        """Operations and kernel bounds of the window's calls."""
        cfg, lex = self.model.cfg, self.model.lexicon
        bt = self.batches[0]
        b, t_pad = bt.feats.shape[:2]
        frames = int(bt.n_frames.sum())
        s, m, d = (self.model.n_senones, cfg["mixtures"], cfg["dim"])
        n_s, w = 2 + 2 * self.model.emit, 2
        n_sen = int(np.unique(self.model.senone_map[
            lex.node_units[1:].reshape(-1)]).size)
        q = len(lex.word_node)
        return dict(
            flops=self.calls * yardstick.decode_flops(
                frames, d, s, m, lex.n_nodes, n_s, w),
            scan_bound_s=self.calls * 1e-3 * yardstick.scan_bound(
                lex.n_nodes, n_s, w, q, n_sen, b, t_pad, frames)["bound_ms"],
            gmm_bound_s=self.calls * 1e-3 * yardstick.gmm_bound(
                b * t_pad, s, m, d, "float32")["bound_ms"])

    def release(self):
        self.dec = None

    def check(self) -> dict:
        """The gaps of one utterance the window asked for at each slot of
        the batch (``answers``: (batch, utterance) -> its n-best, empty if
        none came): the batch drawn from the seed, and at the longest
        utterance's slot its batch."""
        rng = np.random.default_rng([self.seed, 3])
        pairs = sorted(self.answers)
        longest = max(pairs, key=lambda p: self.batches[p[0]].n_frames[p[1]])
        called = sorted({i for i, _ in pairs})
        pick = [longest if u == longest[1] else (int(rng.choice(called)), u)
                for u in range(len(self.batches[0].n_frames))]
        feats = torch.stack([self.batches[i].feats[u] for i, u in pick])
        n = np.asarray([self.batches[i].n_frames[u] for i, u in pick])
        hyps = [self.answers[p] for p in pick]
        answered = [bool(h) for h in hyps]
        words = [[int(w[1:]) for w in h[0].words] if h else [] for h in hyps]
        score = np.asarray([h[0].score if h else np.nan for h in hyps])
        cfg, lex = self.model.cfg, self.model.lexicon
        pen = cfg["decoder"]["word_penalty"]
        scores = ref_decode.frame_scores(feats, self.bank)
        best = ref_decode.best_scores(
            lex.node_units, lex.parent, lex.word_node, self.bank, feats, n,
            cfg["state_num"], pen, scores).cpu().numpy()
        chain = ref_decode.chain_scores(
            self.model.word_units, words, self.bank, feats, n,
            cfg["state_num"], pen, scores).cpu().numpy()
        ok = np.asarray(answered)
        # an answer's gap: how far its reported score lies from the best
        # path's, plus how far the best path spelling its words lies below
        # the best (0 for the right words, whatever ties the search broke)
        gap = (np.abs(score[ok] - best[ok]) + (best[ok] - chain[ok])) \
            / np.abs(best[ok])
        return {"missing": int((~ok).sum()),
                "answer_gap": float(np.max(gap, initial=0.0))}


class TrainEpochs:
    """Embedded Baum-Welch training with a realignment each step."""

    LIBS = ("hmm_banded",)

    def __init__(self, model, bank, mix, seed, dev, tracer: Tracer,
                 score_dtype: str):
        from poccala_tpu_torch.config import Config
        from poccala_tpu_torch.io.corpus import Batch, UnitInventory
        from poccala_tpu_torch.train.trainer import Trainer

        cfg, tc = model.cfg, model.cfg["train"]
        self.model, self.seed, self.dev, self.tr = model, seed, dev, tracer
        t0 = time.perf_counter()
        self.batches = make_batches(model, bank, mix, seed)
        self.start = start_bank(model, bank, seed)
        _sync(dev)
        self.stamps = {"traffic_s": time.perf_counter() - t0}
        pc = Config()
        pc.model.state_num = cfg["state_num"]
        pc.model.mix_level = pc.model.max_mix_level = cfg["mixtures"]
        pc.model.c_covariance = tc["c_covariance"]
        pc.model.count_final_exit = tc["count_final_exit"]
        pc.model.bw_inner_iters = tc["bw_inner_iters"]
        pc.model.gaussian_normalizer = cfg["gaussian_normalizer"]
        pc.model.score_dtype = score_dtype
        pc.train.max_label_len = lmax = tc["max_label_len"]
        self.pc = pc
        if max(int(b.label_lens.max()) for b in self.batches) > lmax:
            raise ValueError("a label is longer than train.max_label_len")
        self.pbatches = [Batch(
            feats=b.feats, t_masks=b.t_masks(),
            labels=torch.as_tensor(np.pad(
                b.labels, ((0, 0), (0, lmax - b.labels.shape[1]))),
                device=dev),
            label_lens=torch.as_tensor(b.label_lens, device=dev))
            for b in self.batches]
        inv = UnitInventory([f"u{i}" for i in range(model.n_units)])
        self.trainer = Trainer(pc, inv, device=dev)
        self.trainer.use_bank(program_bank(self.start))
        # set-up: the first three steps, through the window's own call;
        # the reference follows them
        t0 = time.perf_counter()
        self.first = []
        for _ in range(3):
            ll, align = self.step()
            self.first.append(dict(ll=ll, align=align,
                                   bank=_fields(self.trainer.bank)))
        _sync(dev)
        self.stamps["first_steps_s"] = time.perf_counter() - t0

    def step(self):
        from poccala_tpu_torch.train import alignment

        tr, t = self.tr, self.trainer
        with tr.span("em_epoch"):
            ll = t.scheme2_epoch(self.pbatches)
        with tr.span("align_pass"):
            out = [alignment.align_batch(
                t.bank, b.labels, b.label_lens, b.feats, b.t_masks,
                self.pc.model.state_num, self.pc.train.max_label_len,
                normalizer=self.pc.model.gaussian_normalizer,
                score_dtype=self.pc.model.score_dtype) for b in self.pbatches]
            align = [(s.cpu().numpy(), lp.cpu().numpy()) for s, lp in out]
        return ll, align

    def _counters(self):
        from poccala_tpu_torch.ops.cuda import hmm_banded_cuda as hk

        return {r"forward_(warp|block)_kernel": hk.forward_banded_cuda.launches,
                r"backward_(warp|block)_kernel":
                    hk.backward_banded_cuda.launches,
                r"viterbi_(warp|block)_kernel":
                    hk.viterbi_banded_cuda.launches}

    def window(self, seconds: float) -> dict:
        before = self._counters()
        audio = sum(b.audio_s for b in self.batches)
        self.steps = self.attempted = self.failed = 0
        with self.tr.profile():
            t0 = time.perf_counter()
            while True:
                self.attempted += 1
                prev = self.trainer.bank     # each step makes a new bank
                ll, align = self.step()
                self.steps += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            wall = time.perf_counter() - t0
        self.tr.window_s = wall
        self.last = dict(ll=ll, align=align, before=_fields(prev),
                         bank=_fields(self.trainer.bank))
        self.counted = {f: c - before[f] for f, c in self._counters().items()}
        return {"train_audio_s_per_s": self.steps * audio / wall}

    def work(self) -> dict:
        cfg = self.model.cfg
        frames = np.concatenate([b.n_frames for b in self.batches])
        states = 2 + self.model.emit * np.concatenate(
            [b.label_lens for b in self.batches])
        n = 2 + self.model.emit * cfg["train"]["max_label_len"]
        w = cfg["state_num"]
        hmm = 0.0
        for b in self.batches:
            bb, t = b.feats.shape[:2]
            hmm += sum(yardstick.hmm_bound(k, bb, t, n, w)["bound_ms"]
                       for k in ("forward", "backward", "viterbi"))
        return dict(
            flops=self.steps * yardstick.train_flops(
                frames, states, cfg["dim"], cfg["mixtures"], w),
            hmm_bound_s=self.steps * hmm * 1e-3)

    def release(self):
        self.trainer = None
        self.pbatches = None

    def check(self) -> dict:
        """The first three steps, and the window's last, against the
        reference's.  The first three follow the reference from the start
        bank: each epoch's log-likelihood, the leaves' change after one
        step (the worst leaf) and after three (the median leaf).  The last
        step is followed by one reference epoch from the program's own
        bank before it: its log-likelihood and its change (the worst
        leaf).  A leaf's gap is the gap of the two norms over the larger
        of the reference's norm of that leaf and of the median leaf (leaves
        that the reference moves by less than a thousandth of the median
        leaf's are left out).  The alignments of step 1 and of the last
        step (score, and the share of valid frames whose label position
        differs) are judged on the program's own bank that made them, as
        the reference aligns with it: the epoch before it is judged by
        itself, and the two banks differ by the float32 drift that
        ``change1_gap`` reads.  The last step's change is judged by what
        it is for, the corpus likelihood of its new bank (``update_ll_gap``).
        A number over several steps is the worst of them."""
        cfg = self.model.cfg
        tc = cfg["train"]
        sn = cfg["state_num"]
        ref, lls, banks = self.start, [], []
        for _ in range(3):
            ref, ll = ref_train.em_epoch(ref, self.batches, tc, sn)
            lls.append(ll)
            banks.append(ref)
        last = self.last
        ref_last, ll_last = ref_train.em_epoch(last["before"], self.batches,
                                               tc, sn)
        gaps = [abs(f - r) / abs(r) for f, r in zip(
            [f["ll"] for f in self.first] + [last["ll"]], lls + [ll_last])]
        out = {"loglik_gap": max(gaps)}
        # after one step the worst leaf; after three the median leaf,
        # since the worst swings from seed to seed with the later steps'
        # float32 noise (PERF.md)
        self.diag = {f"leaves{k + 1}": _change_gaps(
            self.start, self.first[k]["bank"], banks[k]) for k in (0, 2)}
        self.diag["leaves_last"] = _change_gaps(last["before"], last["bank"],
                                                ref_last)
        out["change1_gap"] = max(self.diag["leaves1"].values())
        out["change3_median_gap"] = float(np.median(
            list(self.diag["leaves3"].values())))
        # the last update judged by what it is for: the corpus likelihood
        # (the reference's) of the program's new bank against that of the
        # reference's new bank from the same one
        ll_p = ref_train.loglik(last["bank"], self.batches, sn)
        ll_r = ref_train.loglik(ref_last, self.batches, sn)
        out["update_ll_gap"] = abs(ll_p - ll_r) / abs(ll_r)
        out["align_path_mismatch"] = 0.0
        for k, (bank, align) in enumerate((
                (self.first[0]["bank"], self.first[0]["align"]),
                (last["bank"], last["align"]))):
            r_score, r_path = ref_train.align(bank, self.batches, sn)
            p_score = np.concatenate([s for s, _ in align])
            p_path = _paths(align, r_path.shape)
            valid = np.concatenate(
                [np.arange(r_path.shape[1])[None] < b.n_frames[:, None]
                 for b in self.batches])
            score = float(np.max(np.abs(p_score - r_score) / np.abs(r_score)))
            path = float((p_path != r_path)[valid].sum() / valid.sum())
            # the last bank's float32 scores are coarser (PERF.md): its
            # score gap has a limit of its own
            out["last_align_score_gap" if k else "align_score_gap"] = score
            out["align_path_mismatch"] = max(out["align_path_mismatch"], path)
        lv = last["bank"]["log_var"]
        self.diag.update(
            loglik_gaps=gaps, steps=self.steps,
            floored_dims=float((lv <= np.log(tc["c_covariance"]) + 1e-3)
                               .double().mean()))
        return out


def _fields(bank) -> dict:
    """A copy of a program bank's arrays."""
    return {k: getattr(bank, k).detach().clone() for k in BANK_FIELDS}


def _paths(align, shape) -> np.ndarray:
    """A step's alignments (a score and label positions a batch) as one
    ``[utterances, frames]`` array, -1 past each batch's frames."""
    out = np.full(shape, -1, np.int64)
    at = 0
    for _, lp in align:
        out[at:at + len(lp), :lp.shape[1]] = lp
        at += len(lp)
    return out


def _change_gaps(start: dict, prog: dict, ref: dict) -> dict:
    """Each moved leaf's gap between the program's and the reference's
    norm of the change from ``start``."""
    p_n, r_n = {}, {}
    for k in ref_train.LEAVES:
        s = start[k].double()
        live = s > -1e29
        # a log-probability below LOG_FLOOR is zero to either side (the
        # program's -1e30 sentinel, the reference's -inf, or an underflow)
        p, r = (torch.clamp(x.double(), min=LOG_FLOOR) for x in (prog[k],
                                                                  ref[k]))
        p_n[k] = float(torch.linalg.norm((p - s)[live]))
        r_n[k] = float(torch.linalg.norm((r - s)[live]))
    med = float(np.median(list(r_n.values())))
    moved = [k for k in r_n if r_n[k] >= 1e-3 * med]
    return {k: abs(p_n[k] - r_n[k]) / max(r_n[k], med) for k in moved}


DRIVERS = {"decode_offline": DecodeOffline, "train_epochs": TrainEpochs}
