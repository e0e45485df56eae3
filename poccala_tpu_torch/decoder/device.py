"""Device decoder: dense graph Viterbi over the lexicon tree (port of
``poccala_tpu/decoder/device.py``, exact search only).

Every lexicon node is always live.  Per frame, batched over utterances:

1. **in-node advance**: one banded max-plus step over all nodes against
   the frame's senone scores, with the winning source state's packed
   context riding the same compare-selects (``Token.viterbi``'s inner
   loop, ``Decoder.py:250-288``, dense over the whole tree);
2. **exit flow**: each node's exit score enters its children's entry
   states through the parent array (``passing_in_word``,
   ``Decoder.py:114-143``);
3. **word boundary**: the frame's best word emission (bigram LM applied
   to the top-16 acoustic emissions; a single argmax with no LM) writes
   one ``(prev_ptr, word)`` traceback row and re-enters every
   first-level node.

The context ``ctx = (h+1)*(V+1) + l`` packs the traceback pointer ``h``
and the last word ``l`` into one int32.  The n-best is extracted on the
device (exit scores -> top emissions over the static (node, word) slots ->
pointer-chase backtrace) and the host only maps ids to words.

Scoring goes through :func:`~poccala_tpu_torch.ops.cuda.gmm_score_cuda.
gmm_log_scores_fast`: the CUDA kernel for a bank on the GPU, the plain
version on the CPU.  Where JAX scans the frames inside one program, this
is a Python loop over frames batched over utterances; on the GPU every op
is an asynchronous launch on the current stream, so
:meth:`decode_dispatch` returns once the work is enqueued and
:meth:`decode_collect` synchronises by copying the results to the host.

Tie order follows the JAX version: strict ``>`` in every compare-select
(the smaller band offset wins a tie), first-index ``argmax``, and a
stable descending sort in place of ``lax.top_k`` (lower index first among
equal values; ``torch.topk`` leaves that order unspecified).

Not ported yet: streaming (``stream_*``), block-pruned search
(``active_blocks``) and sharded decode (``mesh=``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from poccala_tpu_torch.decoder.beam import Hypothesis
from poccala_tpu_torch.decoder.vector import VectorBeamDecoder
from poccala_tpu_torch.ops.cuda.gmm_score_cuda import gmm_log_scores_fast
from poccala_tpu_torch.utils.logmath import NEG_INF


def check_context_fits(t_pad: int, n_vocab: int) -> None:
    """The packed context ``(h+1)*(V+1) + l`` is int32: refuse a batch
    whose ``(T+1)(V+1)`` reaches 2³¹."""
    if (t_pad + 1) * (n_vocab + 1) >= 2**31:
        raise ValueError(f"packed decoder context overflows int32 at "
                         f"T={t_pad}, V={n_vocab}")


def check_lm_keys_fit(n_vocab: int) -> None:
    """The sparse device LM keys ``l*V + w`` (``l`` up to V) are int32:
    refuse a vocabulary whose ``(V+1)V`` reaches 2³¹."""
    if (n_vocab + 1) * n_vocab >= 2**31:
        raise ValueError(f"sparse device LM keys overflow int32 at V={n_vocab}")


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: descending, lower index first
    among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@dataclass
class _Tables:
    """The decoder's device tables (``_prep_device``)."""

    bands: torch.Tensor       # [N, Ns, W_eff] f32 banded log transitions
    senone: torch.Tensor      # [N, Ns] int64, clipped to >= 0
    emitting: torch.Tensor    # [N, Ns] bool, senone >= 0
    node_slot: torch.Tensor   # [Q] int64 node of each (node, word) slot
    word_slot: torch.Tensor   # [Q] int32 word id of each slot
    slot_valid: torch.Tensor  # [Q] bool
    parent: torch.Tensor      # [N] int64, clipped to >= 0
    has_parent: torch.Tensor  # [N] bool
    is_root_child: torch.Tensor  # [N] bool
    lm_sparse: tuple | None   # (uni, rboff, cbase, keys int32, vals)
    lm_flat: torch.Tensor | None  # [(V+1)*V] f32


class DeviceBeamDecoder(VectorBeamDecoder):
    """Dense graph-Viterbi decoder on the bank's device.  Constructor
    matches :class:`poccala_tpu_torch.decoder.beam.BeamDecoder`;
    ``max_words`` bounds the backtrace length of one hypothesis."""

    def __init__(self, *args, max_words: int = 64,
                 active_blocks: int | None = None, **kwargs):
        if active_blocks is not None:
            raise NotImplementedError(
                "block-pruned decode (active_blocks) is not ported yet; "
                "the PyTorch decoder runs the exact dense search")
        super().__init__(*args, **kwargs)
        self.max_words = max(2, int(max_words))
        self._tabs: _Tables | None = None

    @property
    def device(self) -> torch.device:
        return self.bank.means.device

    # ------------------------------------------------------------------
    def _prep_device(self) -> _Tables:
        if self._tabs is not None:
            return self._tabs
        self._prep_tables()
        # trim the band table to the widest transition that exists (the
        # left-to-right topology has only self-loops and +1 steps, so W
        # shrinks 5 -> 2)
        bands = self._bands
        live = np.any(bands > NEG_INF / 2, axis=(0, 1))
        w_eff = int(max(2, np.max(np.nonzero(live)[0], initial=1) + 1))
        bands = np.ascontiguousarray(bands[:, :, :w_eff])
        senone = self._senone
        word_tab = self._word_tab
        self._n_vocab = v = len(self._vocab)
        dev = self.device

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        lm_sparse = lm_flat = None
        if self._lm_sparse is not None:
            uni, rboff, cbase, keys, vals = self._lm_sparse
            check_lm_keys_fit(v)
            lm_sparse = (t(uni, torch.float32), t(rboff, torch.float32),
                         t(cbase, torch.float32),
                         t(keys.astype(np.int32), torch.int32),
                         t(vals, torch.float32))
        elif self._lm_tab is not None:
            lm_flat = t(self._lm_tab, torch.float32).reshape(-1)
        # tree parent of each node; -1 for the virtual root and for
        # first-level nodes (their entry comes from word re-entry only)
        lex = self.lexicon
        n_nodes = lex.n_nodes
        par = np.full((n_nodes,), -1, np.int64)
        for p in range(1, n_nodes):
            for c in lex.children(p):
                par[c] = p
        is_rc = np.zeros((n_nodes,), bool)
        is_rc[np.asarray(self._roots, np.int64)] = True
        # word-emission slots: the static (node, word) pairs
        node_slot, word_slot = np.nonzero(word_tab >= 0)
        if len(node_slot) == 0:
            node_slot, word_slot = np.zeros(1, np.int64), np.zeros(1, np.int64)
        words = word_tab[node_slot, word_slot]
        self._tabs = _Tables(
            bands=t(bands, torch.float32),
            senone=t(np.clip(senone, 0, None), torch.int64),
            emitting=t(senone >= 0, torch.bool),
            node_slot=t(node_slot, torch.int64),
            word_slot=t(words, torch.int32),
            slot_valid=t(words >= 0, torch.bool),
            parent=t(np.clip(par, 0, None), torch.int64),
            has_parent=t(par >= 0, torch.bool),
            is_root_child=t(is_rc, torch.bool),
            lm_sparse=lm_sparse, lm_flat=lm_flat,
        )
        return self._tabs

    # ------------------------------------------------------------------
    def decode_batch(self, feats, n_frames, return_nbest: int = 1,
                     mesh=None):
        """Decode ``[B, T, D]`` features; returns per-utterance n-best
        :class:`Hypothesis` lists."""
        return self.decode_collect(
            self.decode_dispatch(feats, n_frames, return_nbest, mesh))

    def decode_dispatch(self, feats, n_frames, return_nbest: int = 1,
                        mesh=None):
        """Enqueue one decode batch and return an opaque handle for
        :meth:`decode_collect`.  ``feats`` may be an array or a tensor on
        any device; it is moved to the bank's device."""
        if mesh is not None:
            raise NotImplementedError(
                "sharded decode (mesh=) is not ported yet")
        tabs = self._prep_device()
        b_orig = int(np.shape(feats)[0])
        if len(self._roots) == 0:
            return (None, None, b_orig, return_nbest)
        if isinstance(n_frames, torch.Tensor):
            n_frames = n_frames.cpu().numpy()
        n_frames = np.asarray(n_frames, np.int64)
        feats = torch.as_tensor(feats, dtype=torch.float32,
                                device=self.device)
        seqs, scores = self._run(tabs, feats, n_frames,
                                 self._n_cand(return_nbest))
        return (seqs, scores, b_orig, return_nbest)

    def decode_collect(self, handle):
        """Wait for a :meth:`decode_dispatch` handle (the host copy
        synchronises) and map ids to vocab words."""
        seqs, scores, b_orig, return_nbest = handle
        if seqs is None:
            return [[] for _ in range(b_orig)]
        return self._to_hypotheses(seqs.cpu().numpy(), scores.cpu().numpy(),
                                   b_orig, return_nbest)

    @staticmethod
    def _n_cand(return_nbest: int) -> int:
        """Candidate count for the device n-best extraction (the JAX
        version's power-of-two rounding, kept so both rank the same
        candidate set)."""
        return max(8, int(2 ** int(np.ceil(np.log2(max(2, 2 * return_nbest))))))

    def _to_hypotheses(self, seqs, scores, b_orig, return_nbest):
        """ids -> vocab strings; dedup identical word sequences keeping
        the best score (two (end-node, word) pairs can backtrace to the
        same words)."""
        out: list[list[Hypothesis]] = []
        vocab = self._vocab
        for u in range(b_orig):
            best: dict[tuple, float] = {}
            for c in range(seqs.shape[1]):
                if scores[u, c] <= NEG_INF / 2:
                    continue
                ids = seqs[u, c]
                words = tuple(vocab[i] for i in ids if i >= 0)
                if not words:
                    continue
                s = float(scores[u, c])
                if words not in best or s > best[words]:
                    best[words] = s
            hyps = [Hypothesis(score=s, words=w) for w, s in best.items()]
            hyps.sort(reverse=True)
            out.append(hyps[:return_nbest])
        return out

    # ------------------------------------------------------------------
    # the search
    # ------------------------------------------------------------------

    def _scores(self, feats: torch.Tensor) -> torch.Tensor:
        """All-frames × all-senones GMM scores ``[B, T, S]``."""
        b, t, d = feats.shape
        s = gmm_log_scores_fast(
            feats.reshape(b * t, d), self.bank.means, self.bank.log_var,
            self.bank.log_w, normalizer=self.normalizer,
            score_dtype=self.score_dtype)
        return s.reshape(b, t, -1)

    def _lm(self, tabs: _Tables, l_r: torch.Tensor,
            w_r: torch.Tensor) -> torch.Tensor:
        """Word-boundary score for (lm context, word id) int32 tensors:
        sparse searchsorted bigram, dense flat table, or the constant
        insertion penalty.  ``l_r == V`` is the no-previous-word row."""
        v = self._n_vocab
        if tabs.lm_sparse is not None:
            uni, rboff, cbase, keys, vals = tabs.lm_sparse
            nb = keys.shape[0]
            w_c = torch.clamp(w_r, 0, v - 1)
            l_c = torch.clamp(l_r, 0, v)
            kq = l_c * v + w_c
            idx = torch.searchsorted(keys, kq.contiguous())
            idx_c = torch.clamp(idx, max=nb - 1)
            found = (idx < nb) & (keys[idx_c] == kq)
            # unseen pair: per-row backoff + backoff column
            val = torch.where(found, vals[idx_c],
                              rboff[l_c.long()] + cbase[w_c.long()])
            return torch.where(l_r >= v, uni[w_c.long()], val)
        if tabs.lm_flat is not None:
            flat = torch.clamp(l_r, min=0).long() * v \
                + torch.clamp(w_r, 0, v - 1).long()
            return tabs.lm_flat[flat]
        return torch.full(w_r.shape, -float(self.word_penalty),
                          dtype=torch.float32, device=w_r.device)

    def _exit_of(self, tabs: _Tables, deltas, ctx):
        """Max-plus flow into the virtual exit state ``[B, N]``, with the
        winning source state's packed context."""
        bands = tabs.bands
        b, n_nodes, n_s = deltas.shape
        ex = torch.full((b, n_nodes), NEG_INF, device=deltas.device)
        ex_ctx = torch.full((b, n_nodes), self._n_vocab, dtype=torch.int32,
                            device=deltas.device)
        for k in range(1, bands.shape[2]):
            rr = n_s - 1 - k
            if rr < 0:
                continue
            cand = deltas[:, :, rr] + bands[:, rr, k]
            win = cand > ex
            ex = torch.where(win, cand, ex)
            ex_ctx = torch.where(win, ctx[:, :, rr], ex_ctx)
        return ex, ex_ctx

    def _candidates(self, tabs: _Tables, ex, ex_ctx, r: int):
        """The top-``r`` acoustic word emissions over the (node, word)
        slots with their LM-scored totals: ``(tot, slot, ctx)``, each
        ``[B, r]``."""
        vp1 = self._n_vocab + 1
        ex_q = ex[:, tabs.node_slot]
        ctx_q = ex_ctx[:, tabs.node_slot]
        ac = torch.where(tabs.slot_valid & (ex_q > NEG_INF / 2), ex_q,
                         NEG_INF)
        if r == 1:  # no LM: adding a constant keeps the argmax
            r_ix = torch.argmax(ac, dim=1, keepdim=True)
            r_sc = ac.gather(1, r_ix)
        else:
            r_sc, r_ix = _top_k(ac, r)
        c_r = ctx_q.gather(1, r_ix)
        w_r = tabs.word_slot[r_ix]
        lm_r = self._lm(tabs, c_r % vp1, w_r)
        tot = torch.where(r_sc > NEG_INF / 2, r_sc + lm_r, NEG_INF)
        return tot, r_ix, c_r

    def _step(self, tabs: _Tables, deltas, ctx, frame_scores, ti: int,
              active):
        """One frame for the whole batch.  ``deltas``/``ctx`` are
        ``[B, N, Ns]``, ``frame_scores`` ``[B, S]``, ``active`` ``[B]``.
        Returns the new carry and this frame's traceback row
        ``(prev_row, word_row)``, each ``[B]`` int32."""
        v = self._n_vocab
        vp1 = v + 1
        bands = tabs.bands

        # 1. banded in-node advance; ctx rides the same selects
        best = torch.full_like(deltas, NEG_INF)
        bctx = torch.full_like(ctx, v)
        for k in range(bands.shape[2]):
            cand = deltas + bands[:, :, k]
            cctx = ctx
            if k:
                cand = F.pad(cand[..., :-k], (k, 0), value=NEG_INF)
                cctx = F.pad(ctx[..., :-k], (k, 0), value=v)
            win = cand > best
            best = torch.where(win, cand, best)
            bctx = torch.where(win, cctx, bctx)
        log_b = torch.where(tabs.emitting, frame_scores[:, tabs.senone],
                            NEG_INF)
        log_b[..., 0] = 0.0
        d_new = torch.clamp(best + log_b, min=NEG_INF)
        ctx_new = bctx

        # 2-3. exits, best emission, entry refresh
        ex, ex_ctx = self._exit_of(tabs, d_new, ctx_new)
        r_top = 1 if self.lm is None else int(min(tabs.node_slot.shape[0], 16))
        tot, r_ix, c_r = self._candidates(tabs, ex, ex_ctx, r_top)
        rb = torch.argmax(tot, dim=1, keepdim=True)
        e_score = tot.gather(1, rb)[:, 0]
        slot = r_ix.gather(1, rb)[:, 0]
        valid = e_score > NEG_INF / 2
        prev_row = torch.where(valid, c_r.gather(1, rb)[:, 0] // vp1 - 1, -1)
        word_row = torch.where(valid, tabs.word_slot[slot], -1)

        flow = torch.where(tabs.has_parent, ex[:, tabs.parent], NEG_INF)
        flow_ctx = ex_ctx[:, tabs.parent]
        restart = torch.where(tabs.is_root_child, e_score[:, None], NEG_INF)
        use_restart = restart > flow
        entry = torch.maximum(flow, restart)
        re_ctx = (ti + 1) * vp1 + torch.where(word_row >= 0, word_row, v)
        entry_ctx = torch.where(use_restart, re_ctx[:, None], flow_ctx)
        d_new[..., 0] = entry
        ctx_new[..., 0] = entry_ctx

        keep = active[:, None, None]
        deltas = torch.where(keep, d_new, deltas)
        ctx = torch.where(keep, ctx_new, ctx)
        prev_row = torch.where(active, prev_row, -1)
        word_row = torch.where(active, word_row, -1)
        return deltas, ctx, prev_row, word_row

    def _seed(self, tabs: _Tables, b: int):
        n_nodes, n_s, _ = tabs.bands.shape
        dev = tabs.bands.device
        deltas = torch.full((b, n_nodes, n_s), NEG_INF, device=dev)
        deltas[:, :, 0] = torch.where(tabs.is_root_child, 0.0, NEG_INF)
        ctx = torch.full((b, n_nodes, n_s), self._n_vocab, dtype=torch.int32,
                         device=dev)
        return deltas, ctx

    def _finalize(self, tabs: _Tables, deltas, ctx, tb_prev, tb_word,
                  n_cand: int):
        """Device n-best: final exits -> top emissions over the static
        (node, word) slots -> pointer-chase backtrace.  Returns
        ``(seqs [B, C, L] int32, scores [B, C] f32)``."""
        vp1 = self._n_vocab + 1
        q = tabs.node_slot.shape[0]
        l_max = self.max_words
        n_cand = min(n_cand, int(q))
        r_fin = int(min(q, max(32, 2 * n_cand)))

        ex, ex_ctx = self._exit_of(tabs, deltas, ctx)
        tot, r_ix, c_r = self._candidates(tabs, ex, ex_ctx, r_fin)
        scores, c_ix = _top_k(tot, n_cand)
        last_words = tabs.word_slot[r_ix.gather(1, c_ix)]        # [B, C]
        ptr = c_r.gather(1, c_ix) // vp1 - 1                     # [B, C]

        cols = [last_words]                                     # newest-first
        for _ in range(l_max - 1):
            live = ptr >= 0
            p = torch.clamp(ptr, min=0).long()
            cols.append(torch.where(live, tb_word.gather(1, p), -1))
            ptr = torch.where(live, tb_prev.gather(1, p), -1)
        rev = torch.stack(cols, dim=2)                          # [B, C, L]
        valid_c = scores > NEG_INF / 2
        rev = torch.where(valid_c[..., None], rev, -1)
        lens = torch.sum(rev >= 0, dim=2)
        pos = lens[..., None] - 1 - torch.arange(l_max, device=rev.device)
        seqs = torch.where(pos >= 0,
                           rev.gather(2, torch.clamp(pos, min=0)), -1)
        return seqs.to(torch.int32), scores

    def _run(self, tabs: _Tables, feats: torch.Tensor, n_frames: np.ndarray,
             n_cand: int):
        """Scoring + frame loop + n-best for ``feats [B, T, D]``."""
        b, t_pad, _ = feats.shape
        check_context_fits(t_pad, self._n_vocab)
        dev = feats.device
        scores = self._scores(feats)
        deltas, ctx = self._seed(tabs, b)
        tb_prev = torch.full((b, t_pad), -1, dtype=torch.int32, device=dev)
        tb_word = torch.full((b, t_pad), -1, dtype=torch.int32, device=dev)
        actives = (torch.arange(t_pad)[None]
                   < torch.as_tensor(n_frames)[:, None]).to(dev)
        # frames past every utterance's end are frozen no-ops: stop there
        t_stop = int(min(t_pad, n_frames.max(initial=0)))
        for ti in range(t_stop):
            deltas, ctx, prev_row, word_row = self._step(
                tabs, deltas, ctx, scores[:, ti], ti, actives[:, ti])
            tb_prev[:, ti] = prev_row
            tb_word[:, ti] = word_row
        return self._finalize(tabs, deltas, ctx, tb_prev, tb_word, n_cand)
