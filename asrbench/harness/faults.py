"""Faults planted underneath the timed path, to see ``correct`` come out
false (the benchmark's own runs never plant one).  Each is a patch of
one program function, applied with :func:`plant` and undone by the
returned callable.

* ``state_unchanged``: a step that returns its state unchanged (decode:
  the frame scan returns its carry and no word; training: the epoch keeps
  the old bank);
* ``half_batch``: half of the batch left out (decode: only the first half
  dispatched; training: the statistics of the first half alone, so the
  update's means are taken over the rest);
* ``answer_altered``: an answer altered where it is produced (decode: each
  word id of the n-best moved by one; training: each frame's aligned
  label position moved by one).
"""

from __future__ import annotations

import torch

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def _decode(name):
    from poccala_tpu_torch.decoder.device import DeviceBeamDecoder as D

    if name == "state_unchanged":
        orig = D._scan

        def scan(self, tabs, carry, scores, t0, n_valid):
            _, prev, word = orig(self, tabs, carry, scores, t0, n_valid)
            return carry, torch.full_like(prev, -1), torch.full_like(word, -1)
        return D, "_scan", scan
    if name == "half_batch":
        orig = D.decode_dispatch

        def dispatch(self, feats, n_frames, return_nbest=1, mesh=None):
            h = len(n_frames) // 2
            return orig(self, feats[:h], n_frames[:h], return_nbest, mesh)
        return D, "decode_dispatch", dispatch
    orig = D._finalize

    def finalize(self, tabs, carry, tb_prev, tb_word, n_cand):
        seqs, scores = orig(self, tabs, carry, tb_prev, tb_word, n_cand)
        return torch.where(seqs >= 0, (seqs + 1) % self._n_vocab, seqs), scores
    return D, "_finalize", finalize


def _train(name):
    from poccala_tpu_torch.train import accumulators, alignment
    from poccala_tpu_torch.train.trainer import Trainer

    if name == "state_unchanged":
        orig = Trainer.scheme2_epoch

        def epoch(self, batches, **kw):
            bank = self.bank
            ll = orig(self, batches, **kw)
            self.bank = bank
            return ll
        return Trainer, "scheme2_epoch", epoch
    if name == "half_batch":
        orig = accumulators.batch_stats

        def stats(bank, labels, label_lens, xs, t_masks, *a, **kw):
            h = len(label_lens) // 2
            return orig(bank, labels[:h], label_lens[:h], xs[:h],
                        t_masks[:h], *a, **kw)
        return accumulators, "batch_stats", stats
    orig = alignment.align_batch

    def align(*a, **kw):
        score, pos = orig(*a, **kw)
        return score, torch.where(pos >= 0, pos + 1, pos)
    return alignment, "align_batch", align


def plant(driver: str, name: str):
    """Patch the program under ``driver`` (a mix's driver name) with fault
    ``name``; returns the undo."""
    owner, attr, fn = (_train if driver == "train_epochs" else _decode)(name)
    old = getattr(owner, attr)
    setattr(owner, attr, fn)
    return lambda: setattr(owner, attr, old)
