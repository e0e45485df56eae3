"""Device decoder: dense graph Viterbi over the lexicon tree (port of
``poccala_tpu/decoder/device.py``).

Every lexicon node is live in the exact search.  Per frame, batched over
utterances:

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

**Block-pruned search** (``active_blocks``): the nodes are permuted into
DFS order, so every subtree is contiguous, and padded with dead nodes to
a multiple of ``block_size``.  Per frame only the ``active_blocks`` best
blocks by a one-step lookahead run the banded advance, on a compact carry
``[B, K, block_size, Ns]``; the entry row ``[B, N]`` and the word
emissions stay global, so a pruned block revives through word re-entry
or parent flow (the reference's keep-fraction beam, ``Decoder.py:34``).

**Streaming** (``stream_init`` / ``stream_feed`` / ``stream_result``):
the carry and the traceback rows persist across feature chunks on the
bank's device; traceback pointers are absolute frame indices, so a
chunked decode equals the one-shot decode of the concatenated features.

Scoring goes through :func:`~poccala_tpu_torch.ops.gmm_score.
gmm_log_scores_batch`, one call of the dispatcher over all ``B·T`` frames:
the CUDA kernel for a bank on the GPU, the plain version on the CPU.  Where
JAX scans the frames inside one program, :meth:`DeviceBeamDecoder._scan`
runs the exact search's frames on the GPU as one launch of the CUDA kernel
``csrc/decoder_scan.cu`` (:mod:`poccala_tpu_torch.ops.cuda.
decoder_scan_cuda`), and on the CPU as its plain version, a Python loop of
:meth:`DeviceBeamDecoder._frame_step` over frames batched over utterances;
the two agree bit for bit.  The block-pruned search is likewise one launch
of the same source's ``decoder_scan_pruned`` kernel on the GPU and a loop
of :meth:`DeviceBeamDecoder._step_pruned` on the CPU, and the n-best
(:meth:`DeviceBeamDecoder._finalize`) one launch of its
``decoder_finalize`` kernel on the GPU and
:meth:`DeviceBeamDecoder._finalize_plain` on the CPU.  On the GPU every op is an asynchronous launch on the calling
thread's current stream (the worker thread of
:class:`~poccala_tpu_torch.serve.DecodeService` runs batches and stream
chunks alike there), so :meth:`decode_dispatch` returns once the work is
enqueued and :meth:`decode_collect` synchronises by copying the results to
the host.

Tie order follows the JAX version: strict ``>`` in every compare-select
(the smaller band offset wins a tie), first-index ``argmax``, and a
stable descending sort in place of ``lax.top_k`` (lower index first among
equal values; ``torch.topk`` leaves that order unspecified).  The block
selection depends on it: many blocks tie at ``NEG_INF``.

**Sharded decode** (``mesh=``, a ``(data, state)`` mesh of
:mod:`poccala_tpu_torch.parallel.mesh`): every rank passes the same batch,
padded to a multiple of the ``data`` axis; each rank runs the frame loop,
and the GMM kernel, on its own contiguous block of utterances, and
:meth:`~DeviceBeamDecoder.decode_collect` assembles the global ``seqs`` and
``scores`` over the ``data`` group, so every rank returns the full
hypothesis list, equal to the unsharded decode.

``prune_hysteresis`` (JAX's sticky block selection): a bonus in nats
added to the K active blocks' lookahead before the top K, so a challenger
must beat an active block by that margin to displace it; 0 (the default)
or below leaves the selection as it is.  The JAX package measured it worse
than the plain selection at every width (``benchmarks/
pruned_trained.json``) and leaves it off by default, as the port does.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from poccala_tpu_torch.decoder.beam import Hypothesis
from poccala_tpu_torch.decoder.vector import VectorBeamDecoder
from poccala_tpu_torch.ops.cuda.decoder_scan_cuda import \
    decoder_finalize_cuda, decoder_scan_cuda, decoder_scan_pruned_cuda
from poccala_tpu_torch.ops.gmm_score import gmm_log_scores_batch
from poccala_tpu_torch.utils import profiling
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
    """The decoder's device tables (``_prep_device``).  With
    ``active_blocks`` set the node axis is in DFS order and padded to
    ``n_blocks * block_size`` with dead rows: not emitting, no parent, not
    a root child, bands at ``NEG_INF``, no word slot."""

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


@dataclass
class _StreamState:
    """An online decode session (:meth:`DeviceBeamDecoder.stream_init`):
    the search carry and the per-chunk traceback rows ``[B, Tc]``, all on
    the bank's device."""

    batch: int
    max_frames: int
    t_offset: int = 0
    carry: tuple | None = None
    tb_prev: list = field(default_factory=list)
    tb_word: list = field(default_factory=list)


class DeviceBeamDecoder(VectorBeamDecoder):
    """Graph-Viterbi decoder on the bank's device.  The constructor takes
    the JAX decoder's arguments: those of
    :class:`poccala_tpu_torch.decoder.beam.BeamDecoder`, ``max_words``
    (bounds the backtrace length of one hypothesis), ``emit_top``
    (accepted and ignored, as in JAX), ``block_size`` (clamped to >= 8)
    and ``active_blocks`` (clamped to >= 1; None keeps the exact search),
    and ``prune_hysteresis`` (the sticky selection's bonus in nats, taken
    as a float; only a positive value acts)."""

    def __init__(self, *args, emit_top: int = 4, max_words: int = 64,
                 block_size: int = 1024, active_blocks: int | None = None,
                 prune_hysteresis: float = 0.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.emit_top = max(1, int(emit_top))  # accepted; not used
        self.max_words = max(2, int(max_words))
        self.block_size = max(8, int(block_size))
        self.active_blocks = (None if active_blocks is None
                              else max(1, int(active_blocks)))
        self.prune_hysteresis = float(prune_hysteresis)
        self._tabs: _Tables | None = None
        self._prune_on = False
        self._perm = None  # new -> old node permutation (pruned mode)

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

        # block pruning: DFS-permute so subtrees are block-contiguous (a
        # live word keeps its prefix path in few blocks) and pad to a
        # block multiple with dead nodes.  Traceback rows hold frame
        # pointers and word ids, never node ids, so hypotheses do not see
        # the permutation.  As in JAX the permuted tables stay when the
        # pruning turns out to be a no-op.
        self._prune_on = (self.active_blocks is not None
                          and n_nodes > self.block_size)
        if self._prune_on:
            perm = np.zeros(n_nodes, np.int64)      # new -> old
            pos, stack = 0, [0]
            seen = np.zeros(n_nodes, bool)
            while stack:
                nid = stack.pop()
                if seen[nid]:
                    continue
                seen[nid] = True
                perm[pos] = nid
                pos += 1
                stack.extend(reversed(list(lex.children(nid))))
            assert pos == n_nodes, "lexicon tree has unreachable nodes"
            self._perm = perm
            new_of = np.empty(n_nodes, np.int64)
            new_of[perm] = np.arange(n_nodes)
            bands, senone, word_tab = bands[perm], senone[perm], word_tab[perm]
            par = np.where(par[perm] >= 0,
                           new_of[np.clip(par[perm], 0, None)], -1)
            is_rc = is_rc[perm]
            pad = (-n_nodes) % self.block_size
            bands = np.pad(bands, ((0, pad), (0, 0), (0, 0)),
                           constant_values=NEG_INF)
            senone = np.pad(senone, ((0, pad), (0, 0)), constant_values=-1)
            word_tab = np.pad(word_tab, ((0, pad), (0, 0)),
                              constant_values=-1)
            par = np.pad(par, (0, pad), constant_values=-1)
            is_rc = np.pad(is_rc, (0, pad))
            self._n_blocks = bands.shape[0] // self.block_size
            if self.active_blocks >= self._n_blocks:
                self._prune_on = False  # pruning would be a no-op
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
        any device; it is moved to the bank's device.  With ``mesh`` only
        this rank's rows of the batch are decoded here."""
        self._prep_device()
        b_orig = int(np.shape(feats)[0])
        if len(self._roots) == 0:
            return (None, None, b_orig, return_nbest, None)
        with profiling.span("decode.dispatch"):
            if mesh is not None:
                from poccala_tpu_torch.parallel import mesh as pmesh

                if isinstance(n_frames, torch.Tensor):
                    n_frames = n_frames.cpu().numpy()
                (feats, n_frames), _ = pmesh.pad_batch_for_mesh(
                    (feats, np.asarray(n_frames)), mesh)
                rows = pmesh.data_rows(mesh, feats.shape[0])
                feats, n_frames = feats[rows], n_frames[rows]
            seqs, scores = self._run(feats, n_frames,
                                     self._n_cand(return_nbest))
        return (seqs, scores, b_orig, return_nbest, mesh)

    def _run(self, feats, n_frames, n_cand: int):
        """Scoring, the frame loop and the device n-best of ``[B, T, D]``:
        ``(seqs [B, C, L] int32, scores [B, C] f32)`` on the device.  Each
        phase is a span timed on the device (``decode.score``,
        ``decode.scan``, ``decode.finalize``)."""
        tabs = self._prep_device()
        dev = self.device
        feats = torch.as_tensor(feats, dtype=torch.float32, device=dev)
        t_pad = feats.shape[1]
        check_context_fits(t_pad, self._n_vocab)
        with profiling.span("decode.score", dev):
            scores = self._scores(feats)
        with profiling.span("decode.scan", dev):
            carry, tb_prev, tb_word = self._scan(
                tabs, self._seed(tabs, feats.shape[0]), scores, 0, n_frames)
        with profiling.span("decode.finalize", dev):
            return self._finalize(tabs, carry, tb_prev, tb_word, n_cand)

    def decode_collect(self, handle):
        """Wait for a :meth:`decode_dispatch` handle (the host copy
        synchronises) and map ids to vocab words.  A sharded handle first
        sums each rank's rows, in zero buffers, over the ``data`` group."""
        seqs, scores, b_orig, return_nbest, mesh = handle
        if seqs is None:
            return [[] for _ in range(b_orig)]
        if mesh is not None:
            from poccala_tpu_torch.parallel.mesh import gather_rows, \
                mesh_shape

            b_pad = seqs.shape[0] * mesh_shape(mesh)["data"]
            seqs = gather_rows(seqs, mesh, b_pad)
            scores = gather_rows(scores, mesh, b_pad)
        return self._host_hypotheses(seqs, scores, b_orig, return_nbest)

    def _host_hypotheses(self, seqs, scores, b_orig, return_nbest):
        """The n-best's two host copies (they wait for the call's device
        work), then :meth:`_to_hypotheses`."""
        with profiling.span("decode.copy"):
            seqs, scores = seqs.cpu().numpy(), scores.cpu().numpy()
        with profiling.span("decode.map"):
            return self._to_hypotheses(seqs, scores, b_orig, return_nbest)

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
    # Streaming (online) decode: the reference's record -> VAD -> decode
    # serving intent (Decoder.py:190-218) as a chunk-incremental API.
    # ------------------------------------------------------------------

    def stream_init(self, batch: int = 1,
                    max_frames: int = 4096) -> _StreamState:
        """Start a streaming decode session.

        :param batch: number of parallel (lockstep) audio streams
        :param max_frames: total-frame capacity; exceeding it raises at
            feed time
        """
        self._prep_device()
        check_context_fits(max_frames, self._n_vocab)
        return _StreamState(batch=batch, max_frames=max_frames)

    def stream_feed(self, st: _StreamState, feats_chunk,
                    n_valid=None) -> _StreamState:
        """Advance the decoder over one feature chunk.

        :param feats_chunk: ``[B, Tc, D]`` (or ``[Tc, D]`` when
            ``batch == 1``), array or tensor on any device
        :param n_valid: ``[B]`` valid frame counts (default: the whole
            chunk); later frames are frozen, and the frame offset still
            advances by ``Tc``
        """
        tabs = self._prep_device()
        feats = torch.as_tensor(feats_chunk, dtype=torch.float32,
                                device=self.device)
        if feats.ndim == 2:
            feats = feats[None]
        b, t_c, _ = feats.shape
        if b != st.batch:
            raise ValueError(f"stream batch {st.batch} != chunk batch {b}")
        if st.t_offset + t_c > st.max_frames:
            raise ValueError(
                f"stream exceeds max_frames={st.max_frames}; "
                f"restart with a larger capacity")
        if n_valid is None:
            n_valid = np.full((b,), t_c, np.int64)
        if st.carry is None:
            st.carry = self._seed(tabs, b)
        st.carry, tb_prev, tb_word = self._scan(
            tabs, st.carry, self._scores(feats), st.t_offset, n_valid)
        st.tb_prev.append(tb_prev)
        st.tb_word.append(tb_word)
        st.t_offset += t_c
        return st

    def stream_result(self, st: _StreamState, return_nbest: int = 1):
        """Current n-best hypotheses per stream (callable at any point;
        the stream may continue afterwards)."""
        if st.carry is None:
            return [[] for _ in range(st.batch)]
        tabs = self._prep_device()
        seqs, scores = self._finalize(
            tabs, st.carry, torch.cat(st.tb_prev, dim=1),
            torch.cat(st.tb_word, dim=1), self._n_cand(return_nbest))
        return self._host_hypotheses(seqs, scores, st.batch, return_nbest)

    def decode_stream(self, chunks, return_nbest: int = 1):
        """Decode one utterance (or a lockstep batch) delivered as a list
        of feature chunks; equals :meth:`decode_batch` on the
        concatenated features."""
        if not len(chunks):
            return []
        b = 1 if chunks[0].ndim == 2 else chunks[0].shape[0]
        st = self.stream_init(batch=b,
                              max_frames=sum(c.shape[-2] for c in chunks))
        for c in chunks:
            st = self.stream_feed(st, c)
        return self.stream_result(st, return_nbest=return_nbest)

    # ------------------------------------------------------------------
    # the search
    # ------------------------------------------------------------------

    def _scores(self, feats: torch.Tensor) -> torch.Tensor:
        """All-frames × all-senones GMM scores ``[B, T, S]``."""
        return gmm_log_scores_batch(
            feats, None, self.bank.means, self.bank.log_var, self.bank.log_w,
            normalizer=self.normalizer, score_dtype=self.score_dtype)[0]

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

    def _advance(self, bands, deltas, ctx):
        """Banded in-node max-plus advance over the last axis, with the
        winning source state's context: ``deltas``/``ctx`` ``[..., Ns]``
        against ``bands`` ``[..., Ns, W]`` (broadcast)."""
        v = self._n_vocab
        best = torch.full_like(deltas, NEG_INF)
        bctx = torch.full_like(ctx, v)
        for k in range(bands.shape[-1]):
            cand = deltas + bands[..., k]
            cctx = ctx
            if k:
                cand = F.pad(cand[..., :-k], (k, 0), value=NEG_INF)
                cctx = F.pad(ctx[..., :-k], (k, 0), value=v)
            win = cand > best
            best = torch.where(win, cand, best)
            bctx = torch.where(win, cctx, bctx)
        return best, bctx

    def _exit_of(self, bands, deltas, ctx):
        """Max-plus flow into the virtual exit state ``[...]`` of each
        node, with the winning source state's packed context."""
        n_s = deltas.shape[-1]
        ex = torch.full(deltas.shape[:-1], NEG_INF, device=deltas.device)
        ex_ctx = torch.full(deltas.shape[:-1], self._n_vocab,
                            dtype=torch.int32, device=deltas.device)
        for k in range(1, bands.shape[-1]):
            rr = n_s - 1 - k
            if rr < 0:
                continue
            cand = deltas[..., rr] + bands[..., rr, k]
            win = cand > ex
            ex = torch.where(win, cand, ex)
            ex_ctx = torch.where(win, ctx[..., rr], ex_ctx)
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

    def _r_top(self, tabs: _Tables) -> int:
        """Acoustic candidates of a frame's word emission: with no LM
        adding a constant keeps the argmax, so one; else the top 16."""
        return 1 if self.lm is None else int(min(tabs.node_slot.shape[0], 16))

    def _enter(self, tabs: _Tables, ex, ex_ctx, ti: int):
        """The frame's best word emission and the new entry row from the
        flat exits ``ex``/``ex_ctx`` ``[B, N]``: ``(entry, entry_ctx)``
        ``[B, N]`` and the traceback row ``(prev_row, word_row)`` ``[B]``."""
        v = self._n_vocab
        vp1 = v + 1
        tot, r_ix, c_r = self._candidates(tabs, ex, ex_ctx, self._r_top(tabs))
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
        return entry, entry_ctx, prev_row, word_row

    def _frame_step(self, tabs: _Tables, carry, frame_scores, ti: int,
                    active):
        """One frame of the exact search for the whole batch (named apart
        from the host tiers' :meth:`BeamDecoder._step`, which this class
        inherits unchanged, as in JAX).  The carry
        is ``(deltas, ctx)``, each ``[B, N, Ns]``; ``frame_scores`` is
        ``[B, S]`` and ``active`` ``[B]``.  Returns the new carry and this
        frame's traceback row ``(prev_row, word_row)``, each ``[B]``."""
        deltas, ctx = carry
        # 1. banded in-node advance; ctx rides the same selects
        best, ctx_new = self._advance(tabs.bands, deltas, ctx)
        log_b = torch.where(tabs.emitting, frame_scores[:, tabs.senone],
                            NEG_INF)
        log_b[..., 0] = 0.0
        d_new = torch.clamp(best + log_b, min=NEG_INF)

        # 2-3. exits, best emission, entry refresh
        ex, ex_ctx = self._exit_of(tabs.bands, d_new, ctx_new)
        entry, entry_ctx, prev_row, word_row = self._enter(tabs, ex, ex_ctx,
                                                           ti)
        d_new[..., 0] = entry
        ctx_new[..., 0] = entry_ctx

        keep = active[:, None, None]
        deltas = torch.where(keep, d_new, deltas)
        ctx = torch.where(keep, ctx_new, ctx)
        prev_row = torch.where(active, prev_row, -1)
        word_row = torch.where(active, word_row, -1)
        return (deltas, ctx), prev_row, word_row

    def _step_pruned(self, tabs: _Tables, carry, frame_scores, ti: int,
                     active):
        """One frame of the block-pruned search (``make_pruned``'s
        ``step_pruned``) on the compact carry ``(kb [B, K], d_act
        [B, K, blk, Ns], c_act, entry [B, N], entry_ctx [B, N])``: only the
        K active blocks' token scores are carried, plus the global entry
        row.  Same returns as :meth:`_frame_step`."""
        kb, d_act, c_act, entry, entry_ctx = carry
        b, k_act = kb.shape
        blk, n_blk = self.block_size, self._n_blocks
        n_s = tabs.bands.shape[1]
        v = self._n_vocab
        dev = kb.device
        rows = torch.arange(b, device=dev)[:, None]

        # 0. block selection by a one-step lookahead: best token (entry
        # row included) plus the node's best emitting score this frame.
        # lb_full [B, N, Ns] is the one O(N·Ns) temporary per frame.
        lb_full = torch.where(tabs.emitting, frame_scores[:, tabs.senone],
                              NEG_INF)
        la = lb_full.amax(dim=2)                            # [B, N]
        pot = entry + la
        blk_best = pot.view(b, n_blk, blk).amax(dim=2)      # [B, n_blk]
        la_act = la.view(b, n_blk, blk)[rows, kb]           # [B, K, blk]
        int_pot = (d_act.amax(dim=3) + la_act).amax(dim=2)  # [B, K]
        blk_best = blk_best.scatter_reduce(1, kb, int_pot, "amax")
        if self.prune_hysteresis > 0.0:
            # sticky selection: the active blocks' bonus after every term
            # of their value (a dead block's NEG_INF absorbs it)
            blk_best = blk_best.scatter_add(
                1, kb, torch.full_like(int_pot, self.prune_hysteresis))
        _, kb_new = _top_k(blk_best, k_act)

        # 1. carry remap old -> new active set: surviving blocks keep
        # their interior, fresh ones start dead; every active block's
        # entry state refreshes from the global entry row
        eq = kb_new[:, :, None] == kb[:, None, :]           # [B, K, K]
        found = eq.any(dim=2)[..., None, None]
        src = torch.argmax(eq.to(torch.int32), dim=2)
        d = torch.where(found, d_act[rows, src], NEG_INF)
        c = torch.where(found, c_act[rows, src], v)
        d[..., 0] = entry.view(b, n_blk, blk)[rows, kb_new]
        c[..., 0] = entry_ctx.view(b, n_blk, blk)[rows, kb_new]
        bz = tabs.bands.view(n_blk, blk, n_s, -1)[kb_new]  # [B, K, blk, Ns, W]
        log_b = lb_full.view(b, n_blk, blk, n_s)[rows, kb_new]
        log_b[..., 0] = 0.0

        # 2. banded in-node advance on the active blocks only
        best, ctx_adv = self._advance(bz, d, c)
        d_new = torch.clamp(best + log_b, min=NEG_INF)

        # 3. exits of the active blocks, scattered to the flat node axis
        ex_k, exc_k = self._exit_of(bz, d_new, ctx_adv)    # [B, K, blk]
        ex = torch.full((b, n_blk, blk), NEG_INF, device=dev)
        ex[rows, kb_new] = ex_k
        ex_ctx = torch.full((b, n_blk, blk), v, dtype=torch.int32,
                            device=dev)
        ex_ctx[rows, kb_new] = exc_k

        # 4-5. emission and entry refresh over the global [B, N] rows
        entry_new, entry_ctx_new, prev_row, word_row = self._enter(
            tabs, ex.view(b, -1), ex_ctx.view(b, -1), ti)

        # 6. freeze everything on inactive frames
        a1, a3 = active[:, None], active[:, None, None, None]
        carry = (torch.where(a1, kb_new, kb),
                 torch.where(a3, d_new, d_act),
                 torch.where(a3, ctx_adv, c_act),
                 torch.where(a1, entry_new, entry),
                 torch.where(a1, entry_ctx_new, entry_ctx))
        prev_row = torch.where(active, prev_row, -1)
        word_row = torch.where(active, word_row, -1)
        return carry, prev_row, word_row

    def _seed(self, tabs: _Tables, b: int):
        """The carry before the first frame: every first-level node's
        entry state at 0."""
        n_nodes, n_s, _ = tabs.bands.shape
        dev = tabs.bands.device
        v = self._n_vocab
        entry = torch.where(tabs.is_root_child, 0.0, NEG_INF)
        if not self._prune_on:
            deltas = torch.full((b, n_nodes, n_s), NEG_INF, device=dev)
            deltas[:, :, 0] = entry
            return deltas, torch.full((b, n_nodes, n_s), v,
                                      dtype=torch.int32, device=dev)
        blk, k_act = self.block_size, self.active_blocks
        kb = torch.arange(k_act, device=dev).expand(b, k_act).contiguous()
        d = torch.full((b, k_act, blk, n_s), NEG_INF, device=dev)
        d[..., 0] = entry.view(-1, blk)[kb]
        c = torch.full((b, k_act, blk, n_s), v, dtype=torch.int32, device=dev)
        return (kb, d, c, entry.expand(b, n_nodes).contiguous(),
                torch.full((b, n_nodes), v, dtype=torch.int32, device=dev))

    def _expand(self, tabs: _Tables, carry):
        """The carry as full ``(deltas, ctx)`` ``[B, N, Ns]`` (the compact
        pruned carry scattered back once, for the n-best)."""
        if not self._prune_on:
            return carry
        kb, d_act, c_act, entry, entry_ctx = carry
        b = kb.shape[0]
        n_nodes, n_s, _ = tabs.bands.shape
        rows = torch.arange(b, device=kb.device)[:, None]
        d3 = torch.full((b, self._n_blocks, self.block_size, n_s), NEG_INF,
                        device=kb.device)
        d3[rows, kb] = d_act
        c3 = torch.full(d3.shape, self._n_vocab, dtype=torch.int32,
                        device=kb.device)
        c3[rows, kb] = c_act
        deltas = d3.view(b, n_nodes, n_s)
        ctx = c3.view(b, n_nodes, n_s)
        deltas[..., 0] = entry
        ctx[..., 0] = entry_ctx
        return deltas, ctx

    def _scan(self, tabs: _Tables, carry, scores: torch.Tensor, t0: int,
              n_valid):
        """Advance ``carry`` over the frames of ``scores`` ``[B, Tc, S]``,
        whose first frame has the absolute index ``t0``; frames at or past
        ``n_valid`` ``[B]`` are frozen.  Returns ``(carry, tb_prev,
        tb_word)``, the rows ``[B, Tc]`` int32 (-1 where no word).

        On a CUDA tensor the exact search is one launch of the frame-scan
        kernel and the block-pruned search one launch of the pruned scan's
        (either raises if it cannot launch); a CPU tensor takes
        :meth:`_scan_plain`."""
        if not scores.is_cuda:
            return self._scan_plain(tabs, carry, scores, t0, n_valid)
        kw = dict(n_vocab=self._n_vocab, r_top=self._r_top(tabs),
                  penalty=-float(self.word_penalty))
        if self._prune_on:
            return decoder_scan_pruned_cuda(
                tabs, carry, scores.contiguous(), t0, n_valid,
                block_size=self.block_size,
                hysteresis=self.prune_hysteresis, **kw)
        return decoder_scan_cuda(tabs, carry, scores.contiguous(), t0,
                                 n_valid, **kw)

    def _scan_plain(self, tabs: _Tables, carry, scores: torch.Tensor,
                    t0: int, n_valid):
        """:meth:`_scan` as a loop of :meth:`_frame_step` (or, pruned,
        :meth:`_step_pruned`) over frames, on any device: the plain version
        of the frame-scan kernel (or of the pruned scan's)."""
        b, t_c, _ = scores.shape
        dev = scores.device
        if isinstance(n_valid, torch.Tensor):
            n_valid = n_valid.cpu().numpy()
        n_valid = np.asarray(n_valid, np.int64)
        tb_prev = torch.full((b, t_c), -1, dtype=torch.int32, device=dev)
        tb_word = torch.full((b, t_c), -1, dtype=torch.int32, device=dev)
        actives = (torch.arange(t_c)[None]
                   < torch.as_tensor(n_valid)[:, None]).to(dev)
        step = self._step_pruned if self._prune_on else self._frame_step
        # frames past every utterance's end are frozen no-ops: stop there
        for i in range(int(min(t_c, n_valid.max(initial=0)))):
            carry, prev_row, word_row = step(tabs, carry, scores[:, i],
                                             t0 + i, actives[:, i])
            tb_prev[:, i] = prev_row
            tb_word[:, i] = word_row
        return carry, tb_prev, tb_word

    def _finalize(self, tabs: _Tables, carry, tb_prev, tb_word, n_cand: int):
        """Device n-best: final exits -> top emissions over the static
        (node, word) slots -> pointer-chase backtrace.  Returns
        ``(seqs [B, C, L] int32, scores [B, C] f32)``.

        On a CUDA tensor this is one launch of the n-best kernel (it raises
        if it cannot launch), on the full carry (the pruned search's
        compact carry is expanded first, in PyTorch); a CPU tensor takes
        :meth:`_finalize_plain`."""
        if tb_prev.is_cuda:
            deltas, ctx = self._expand(tabs, carry)
            return decoder_finalize_cuda(
                tabs, (deltas.contiguous(), ctx.contiguous()),
                tb_prev.contiguous(), tb_word.contiguous(), n_cand,
                n_vocab=self._n_vocab, r_top=self._r_top(tabs),
                penalty=-float(self.word_penalty), max_words=self.max_words)
        return self._finalize_plain(tabs, carry, tb_prev, tb_word, n_cand)

    def _finalize_plain(self, tabs: _Tables, carry, tb_prev, tb_word,
                        n_cand: int):
        """:meth:`_finalize` in eager PyTorch ops on any device (the
        pointer chase is ``max_words - 1`` steps of gathers): the n-best
        kernel's plain version."""
        vp1 = self._n_vocab + 1
        q = tabs.node_slot.shape[0]
        l_max = self.max_words
        n_cand = min(n_cand, int(q))
        r_fin = int(min(q, max(32, 2 * n_cand)))

        deltas, ctx = self._expand(tabs, carry)
        ex, ex_ctx = self._exit_of(tabs.bands, deltas, ctx)
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
