"""Distributed beam decode over a rank mesh (port of
``poccala_tpu/parallel/decode.py``, BASELINE config 5).

Utterance batches shard over the ``data`` axis, the bank and the
lexicon/LM tables are whole on every rank, and every rank runs the same
frame loop (:class:`~poccala_tpu_torch.decoder.device.DeviceBeamDecoder`)
on its rows.  Per-utterance decode is independent, so the only
collectives assemble the results.

``decode_sharded`` is the library entry; ``dryrun`` is a tiny
self-contained run for :func:`poccala_tpu_torch.parallel.dryrun.
dryrun_multichip`.  JAX's single controller feeds every device of a served
mesh implicitly; here one rank owns the request loop, so the others
:func:`follow` it: :class:`DecodeLeader` announces each
``decode_dispatch`` and ``decode_collect`` of rank 0 by broadcast, and the
followers issue the same calls, hence the same collectives in the same
order.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from poccala_tpu_torch.parallel import mesh as pmesh

_STOP, _DISPATCH, _COLLECT = 0, 1, 2


def decode_sharded(decoder, feats, n_frames, mesh, return_nbest: int = 1):
    """Decode ``[B, T, D]`` with utterances sharded over ``mesh``'s
    ``data`` axis.  Thin alias of
    ``DeviceBeamDecoder.decode_batch(..., mesh=mesh)``."""
    return decoder.decode_batch(feats, n_frames, return_nbest=return_nbest,
                                mesh=mesh)


def decode_sharded_global(decoder, feats_local, n_frames_local, mesh,
                          return_nbest: int = 1):
    """Multi-host distributed decode: each process decodes its own rows
    (from :func:`poccala_tpu_torch.parallel.mesh.distribute_batch`, each
    host's pathInfo slice, ``Controller.py:79-106``) and gathers nothing,
    as JAX's global arrays are fetched by no one process.

    :returns: ``(seqs [b, C, L], scores [b, C], offset)``: this rank's
        rows on its device and the global index of its first row
    """
    counts = pmesh.row_counts(mesh, int(np.shape(feats_local)[0]))
    offset = int(counts[:mesh.get_local_rank("data")].sum())
    seqs, scores = decoder._run(feats_local, n_frames_local,
                                decoder._n_cand(return_nbest))
    return seqs, scores, offset


def _header(dev, op=_STOP, b=0, t=0, d=0, nbest=0) -> torch.Tensor:
    return torch.tensor([op, b, t, d, nbest], dtype=torch.int64, device=dev)


class DecodeLeader:
    """Rank 0's decoder in a served mesh: every ``decode_dispatch`` and
    ``decode_collect`` is first announced to the ranks in :func:`follow`
    (the batch, its frame counts and ``return_nbest`` by broadcast), so all
    ranks run the same sharded calls.  Anything else is the wrapped
    decoder's, run on rank 0 alone.  :meth:`stop` ends the followers'
    loop."""

    def __init__(self, decoder, mesh):
        self.decoder = decoder
        self.mesh = mesh
        self._dev = pmesh.mesh_device(mesh)

    def __getattr__(self, name):
        return getattr(self.decoder, name)

    def decode_dispatch(self, feats, n_frames, return_nbest: int = 1,
                        mesh=None):
        feats = torch.as_tensor(feats, dtype=torch.float32,
                                device=self._dev).contiguous()
        n_frames = torch.as_tensor(np.asarray(n_frames), dtype=torch.int64,
                                   device=self._dev)
        pmesh.broadcast(_header(self._dev, _DISPATCH, *feats.shape,
                                return_nbest))
        pmesh.broadcast(feats)
        pmesh.broadcast(n_frames)
        return self.decoder.decode_dispatch(feats, n_frames.cpu().numpy(),
                                            return_nbest, mesh=self.mesh)

    def decode_collect(self, handle):
        pmesh.broadcast(_header(self._dev, _COLLECT))
        return self.decoder.decode_collect(handle)

    def stop(self) -> None:
        pmesh.broadcast(_header(self._dev))


def follow(decoder, mesh) -> int:
    """The loop of a rank > 0 of a served mesh: receive each call that
    :class:`DecodeLeader` announces and run it, until the stop message.

    :returns: the number of batches decoded"""
    dev = pmesh.mesh_device(mesh)
    pending = deque()
    n = 0
    while True:
        op, b, t, d, nbest = pmesh.broadcast(_header(dev)).tolist()
        if op == _STOP:
            return n
        if op == _DISPATCH:
            feats = pmesh.broadcast(torch.empty((b, t, d), device=dev))
            n_frames = pmesh.broadcast(
                torch.empty((b,), dtype=torch.int64, device=dev))
            pending.append(decoder.decode_dispatch(
                feats, n_frames.cpu().numpy(), nbest, mesh=mesh))
            n += 1
        else:
            decoder.decode_collect(pending.popleft())


def _toy_world(seed: int = 0, device=None):
    """A tiny trained-by-construction decode world: 6 units whose senone
    means are separable embeddings, 3 words over them."""
    from poccala_tpu_torch.config import ModelConfig
    from poccala_tpu_torch.decoder.device import DeviceBeamDecoder
    from poccala_tpu_torch.io.corpus import UnitInventory
    from poccala_tpu_torch.lexicon import (FlatLexicon, PinYin,
                                           PronunciationLexicon)
    from poccala_tpu_torch.models import senone_bank as sb

    rng = np.random.default_rng(seed)
    units = ["n", "i3", "h", "ao3", "m", "a1"]
    inv = UnitInventory(units)
    d = 8
    cfg = ModelConfig(state_num=5, mix_level=1, max_mix_level=1)
    bank = sb.create_bank(len(units), cfg, d, differentiation=False,
                          device=device)
    emb = rng.normal(size=(len(units), d)).astype(np.float32) * 4
    means = np.repeat(emb, cfg.state_num - 2, axis=0)[:, None, :]
    bank = sb.replace(bank, means=torch.as_tensor(means,
                                                  device=bank.means.device))

    table = {"你": ["ni3"], "好": ["hao3"], "马": ["ma1"]}
    lex = PronunciationLexicon()
    lex.generate(["你好", "你", "马"], PinYin(table))
    flat = FlatLexicon.from_tree(lex.lexicon, inv)
    dec = DeviceBeamDecoder(bank, flat, candidate=3)

    def utt(unit_ids, frames_per_unit=8):
        xs = [emb[u] + rng.normal(size=(frames_per_unit, d)) * 0.3
              for u in unit_ids]
        return np.concatenate(xs).astype(np.float32)

    return dec, utt


def dryrun(mesh, batch_per_device: int = 2):
    """Run a sharded decode of ``data_axis * batch_per_device`` toy
    utterances over ``mesh``; returns (per-utterance word counts,
    per-utterance best scores), the same on every rank."""
    shape = pmesh.mesh_shape(mesh)
    b = shape["data"] * batch_per_device
    dec, utt = _toy_world(device=pmesh.mesh_device(mesh))
    seqs = [[0, 1, 2, 3], [4, 5], [0, 1], [4, 5, 0, 1]]
    t_max = 48
    feats = np.zeros((b, t_max, 8), np.float32)
    n_frames = np.zeros((b,), np.int32)
    for i in range(b):
        x = utt(seqs[i % len(seqs)])
        feats[i, : len(x)] = x
        n_frames[i] = len(x)
    out = dec.decode_batch(feats, n_frames, mesh=mesh)
    words = np.asarray([len(h[0].words) if h else 0 for h in out])
    scores = np.asarray([h[0].score if h else np.nan for h in out])
    return words, scores
