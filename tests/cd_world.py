"""A context-dependent decode world built from the port's own constructors.

Within-word triples over ``synthetic_lexicon``'s vocabulary
(``models/context.py``: ``cd_entries_from_flat``, ``CDInventory``,
``build_cd_lexicon``), their emitting states tied at random to a random
bank of ``senones`` x ``mixtures`` diagonal Gaussians, and frames drawn
from that bank.  A node's two CD units are nearly its own, so such a tree
has almost as many (unit, unit) groups as nodes.  At the full vocabulary
(``synthetic_lexicon``'s default 21,589 syllable nodes) the tree has 30,237
nodes and 18,004 groups over 12,648 CD units: the size class of the
6,000 x 32 full-vocabulary configuration's tree.
"""

from __future__ import annotations

import numpy as np
import torch

from poccala_tpu_torch.decoder.device import DeviceBeamDecoder
from poccala_tpu_torch.io.corpus import UnitInventory
from poccala_tpu_torch.lexicon.build import synthetic_lexicon
from poccala_tpu_torch.models import context as ctx
from poccala_tpu_torch.models.senone_bank import SenoneBank, unit_transmat

NEG_INF = -1e30


def cd_lexicon(min_nodes: int | None = None, n_chars: int | None = None):
    """``(FlatLexicon over CD unit ids, CDInventory)``: the within-word
    triples of ``synthetic_lexicon(min_nodes, n_chars)``'s words."""
    inv = UnitInventory.standard("XIF_tone")
    flat, _, _ = synthetic_lexicon(
        inv, n_chars=n_chars,
        **({} if min_nodes is None else dict(min_nodes=min_nodes)))
    entries = ctx.cd_entries_from_flat(flat)
    cd = ctx.CDInventory.from_words(
        [[u for syl in syls for u in syl] for _, syls in entries], inv)
    return ctx.build_cd_lexicon(entries, cd), cd


def cd_decoder(senones: int, mixtures: int, min_nodes: int | None = None,
               n_chars: int | None = None, dim: int = 39, state_num: int = 5,
               seed: int = 0, device="cpu", **kw) -> DeviceBeamDecoder:
    """A ``DeviceBeamDecoder`` on ``device`` over :func:`cd_lexicon`'s
    tree: each CD unit's emitting states tied at random to ``senones``
    senones (every one named), means N(0, 1), variances U(0.5, 1.5),
    mixture weights a softmax of N(0, 0.25), the standard transitions."""
    flat, cd = cd_lexicon(min_nodes, n_chars)
    rng = np.random.default_rng(seed)
    emit = state_num - 2
    tied = rng.permutation(np.arange(len(cd) * emit) % senones)
    means = rng.normal(size=(senones, mixtures, dim))
    log_var = np.log(rng.uniform(0.5, 1.5, size=(senones, mixtures, dim)))
    w = np.exp(0.5 * rng.normal(size=(senones, mixtures)))
    with np.errstate(divide="ignore"):
        log_a = np.log(unit_transmat(state_num))
    bank = SenoneBank(
        means, log_var, np.log(w / w.sum(1, keepdims=True)),
        np.repeat(np.maximum(log_a, NEG_INF)[None], len(cd), 0),
        np.full((len(cd), state_num), -np.log(state_num)),
        np.full(senones, mixtures), tied.reshape(len(cd), emit))
    return DeviceBeamDecoder(bank.to(device), flat, **kw)


def cd_frames(dec: DeviceBeamDecoder, b: int, t: int, seed: int = 0):
    """``[b, t, D]`` float32 frames on the decoder's device, each drawn
    from one Gaussian of a random senone of its bank."""
    rng = np.random.default_rng(seed)
    bank = dec.bank
    s = rng.integers(0, bank.num_states, size=(b, t))
    m = rng.integers(0, bank.max_mix, size=(b, t))
    mu = bank.means.cpu().numpy()[s, m]
    sd = np.exp(0.5 * bank.log_var.cpu().numpy()[s, m])
    x = mu + sd * rng.normal(size=mu.shape)
    return torch.tensor(x, dtype=torch.float32, device=bank.means.device)
