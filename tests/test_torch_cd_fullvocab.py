"""A tied-triphone bank of 32 mixtures over a full-vocabulary
context-dependent tree, decoded through ``DeviceBeamDecoder``'s plain
path on the CPU and held to the benchmark's plain float64 reference.

The configuration is the benchmark's ``cd_tied6k_m32_fullvocab`` (within-
word triples, 32 mixtures, 39 dims, float32 scoring), written out here cut
to a small size: 10 syllables, two-syllable words and three-syllable words
until the syllable tree has 200 nodes (379 once the syllables' units take
their within-word contexts), tied into 64 senones.  Weights, tying and
traffic come from ``asrbench/harness/model.py`` and ``harness/traffic.py``
(a few utterances of 0.5-1 s sampled from the model's own HMMs), and the
judge is ``asrbench/harness/ref_decode.py``, which imports neither JAX nor
the port.  For each utterance the answer's score lies within the float32
tolerance of the best path's, the best path spelling the answer's words
within it of the best, and no utterance goes unanswered; decoded with the
bfloat16 scoring (the precision below the configuration's) the same
comparison fails, so it does catch a lower precision.
"""

import numpy as np
import pytest
import torch

from asrbench.harness import ref_decode
from asrbench.harness.model import build_model, make_bank
from asrbench.harness.traffic import make_batches
from poccala_tpu_torch.decoder.device import DeviceBeamDecoder
from poccala_tpu_torch.lexicon.lexicon import FlatLexicon
from poccala_tpu_torch.models.senone_bank import FIELDS, SenoneBank

torch.set_num_threads(1)

SEED = 2**31 + 2323
# relative to the best path's score: the benchmark cells' answer_gap limit,
# ~30x above what float32 scoring reads here (3.1e-7) and ~17x below what
# bfloat16's reads (1.7e-4)
TOL = 1e-5


def small_config() -> dict:
    """The configuration at 10 syllables and 64 senones."""
    return {
        "units": {"inventory": "XIF_tone", "initials": 27, "finals": 175,
                  "silence": True, "context": "within_word_triples"},
        "senones": 64, "state_num": 5, "mixtures": 32, "dim": 39,
        "score_dtype": "float32", "gaussian_normalizer": "textbook",
        "lexicon": {"vocab_seed": 0, "syllables": 10, "min_nodes": 200},
        "decoder": {"search": "exact", "active_blocks": None,
                    "return_nbest": 1, "word_penalty": 0.0, "max_words": 64,
                    "lm": None}}


# the traffic mix offline_read_b128 at four utterances of 0.5-1 s
MIX = {"batch": 4, "batches": 1, "syllables_per_s": 4.0, "frames_per_s": 80,
       "silence": False,
       "seconds": {"dist": "lognormal", "median": 0.8, "sigma": 0.35,
                   "lo": 0.5, "hi": 1.0}}


def program_lexicon(lex) -> FlatLexicon:
    """The port's lexicon over the generated tree (word ``v`` is
    ``w<v>``)."""
    n = lex.n_nodes
    children = [[] for _ in range(n)]
    for c in range(1, n):
        children[int(lex.parent[c])].append(c)
    ptr = np.zeros(n + 1, np.int32)
    ptr[1:] = np.cumsum([len(c) for c in children])
    words = [[] for _ in range(n)]
    for v, nid in enumerate(lex.word_node):
        words[int(nid)].append(f"w{v}")
    return FlatLexicon(
        child_ptr=ptr,
        child_ids=np.asarray([c for cs in children for c in cs], np.int32),
        node_units=lex.node_units.astype(np.int32),
        node_syllable=[""] + [f"s{i}" for i in range(1, n)],
        node_words=words)


@pytest.fixture(scope="module")
def world():
    cfg = small_config()
    model = build_model(cfg, SEED)
    bank = make_bank(model, SEED, "cpu")
    batch, = make_batches(model, bank, MIX, SEED)
    lex = model.lexicon
    scores = ref_decode.frame_scores(batch.feats, bank)
    best = ref_decode.best_scores(
        lex.node_units, lex.parent, lex.word_node, bank, batch.feats,
        batch.n_frames, cfg["state_num"], 0.0, scores).numpy()
    return dict(cfg=cfg, model=model, bank=bank, batch=batch, scores=scores,
                best=best)


def decode(world, score_dtype):
    """The port's answers: per utterance its 1-best (score, word ids), or
    None where there is none."""
    cfg, model, batch = world["cfg"], world["model"], world["batch"]
    dc = cfg["decoder"]
    dec = DeviceBeamDecoder(
        SenoneBank(**{f: world["bank"][f] for f in FIELDS}),
        program_lexicon(model.lexicon),
        max_words=dc["max_words"], word_penalty=dc["word_penalty"],
        normalizer=cfg["gaussian_normalizer"], score_dtype=score_dtype)
    hyps = dec.decode_batch(batch.feats, batch.n_frames, dc["return_nbest"])
    return [(h[0].score, [int(w[1:]) for w in h[0].words]) if h else None
            for h in hyps]


def gaps(world, answers):
    """``(missing, score gaps, word gaps)``: the answers' relative distance
    from the best path's score, and the best path spelling their words'."""
    cfg, model, batch = world["cfg"], world["model"], world["batch"]
    ok = [a is not None for a in answers]
    chain = ref_decode.chain_scores(
        model.word_units, [a[1] if a else [] for a in answers], world["bank"],
        batch.feats, batch.n_frames, cfg["state_num"], 0.0,
        world["scores"]).numpy()
    best = world["best"][ok]
    score = np.asarray([a[0] for a in answers if a is not None])
    return (len(ok) - sum(ok), np.abs(score - best) / np.abs(best),
            (best - chain[ok]) / np.abs(best))


def test_the_tree_is_context_dependent_over_a_full_vocabulary(world):
    model = world["model"]
    assert model.cfg["mixtures"] == 32 and model.cfg["dim"] == 39
    assert model.n_senones == 64 and model.n_units > 200
    lex = model.lexicon
    assert lex.n_nodes > 300 and len(lex.word_node) > 150
    # nearly every node its own (unit, unit) pair: many groups
    assert len(np.unique(lex.node_units[1:], axis=0)) > 0.7 * lex.n_nodes


def test_plain_decode_is_the_float64_reference(world):
    missing, score_gap, word_gap = gaps(world, decode(world, "float32"))
    assert missing == 0
    assert score_gap.max() <= TOL, score_gap
    assert np.all(word_gap >= -TOL) and word_gap.max() <= TOL, word_gap


def test_bfloat16_scoring_fails_the_tolerance(world):
    missing, score_gap, word_gap = gaps(world, decode(world, "bfloat16"))
    assert missing > 0 or max(score_gap.max(initial=0.0),
                              word_gap.max(initial=0.0)) > TOL
