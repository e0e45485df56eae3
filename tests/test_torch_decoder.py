"""The PyTorch port's device decoder vs the JAX ``DeviceBeamDecoder``.

Both decode the same features with the same bank (a JAX bank converted
through the numpy weight converter) over the built-in lexicon, with no
LM, a sparse bigram LM and a dense (foreign-object) LM, at
``return_nbest`` 1 and 3: the n-best word sequences must be equal and
the scores within rtol 1e-4.  On the CPU the port scores with the plain
PyTorch version of the GMM kernel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poccala_tpu.config import ModelConfig
from poccala_tpu.decoder.device import DeviceBeamDecoder as JaxDecoder
from poccala_tpu.io.corpus import UnitInventory as JaxInventory
from poccala_tpu.lexicon import FlatLexicon as JaxFlat
from poccala_tpu.lexicon import PinYin as JaxPinYin
from poccala_tpu.lexicon import PronunciationLexicon as JaxLexicon
from poccala_tpu.lexicon.builtin_table import BUILTIN_PINYIN
from poccala_tpu.lm.ngram import Ngram
from poccala_tpu.models import senone_bank as jsb
from poccala_tpu_torch.decoder.device import (
    DeviceBeamDecoder, _top_k, check_context_fits, check_lm_keys_fit)
from poccala_tpu_torch.io.corpus import UnitInventory
from poccala_tpu_torch.lexicon import FlatLexicon, PinYin, PronunciationLexicon
from poccala_tpu_torch.models import senone_bank as tsb
from poccala_tpu_torch.ops.cuda import gmm_score_cuda as gk

from .test_torch_lexicon import _ForeignLM

torch.set_num_threads(1)

D = 13


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(11)
    cfg = ModelConfig(state_num=5, mix_level=2, max_mix_level=2)
    jinv = JaxInventory.standard("XIF_tone")
    jbank = jsb.create_bank(len(jinv), cfg, D, key=jax.random.PRNGKey(1))
    means = rng.normal(size=np.shape(jbank.means)).astype(np.float32) * 2
    jbank = dataclasses.replace(jbank, means=jnp.asarray(means))
    tbank = tsb.bank_from_numpy({f: np.asarray(getattr(jbank, f))
                                 for f in tsb.FIELDS}, device="cpu")
    words = list(BUILTIN_PINYIN)
    jl, tl = JaxLexicon(), PronunciationLexicon()
    jl.generate(words, JaxPinYin())
    tl.generate(words, PinYin())
    jflat = JaxFlat.from_tree(jl.lexicon, jinv)
    tflat = FlatLexicon.from_tree(tl.lexicon, UnitInventory.standard())
    lm = Ngram(2)
    lm.train([list(rng.choice(words, size=6)) for _ in range(200)])
    feats = (rng.normal(size=(3, 48, D)) * 2).astype(np.float32)
    n_frames = np.array([48, 37, 20])
    return dict(jbank=jbank, tbank=tbank, jflat=jflat, tflat=tflat, lm=lm,
                feats=feats, n_frames=n_frames)


@pytest.mark.parametrize("lm_kind", ["none", "sparse", "dense"])
def test_nbest_matches_jax(world, lm_kind):
    lm = {"none": None, "sparse": world["lm"],
          "dense": _ForeignLM(world["lm"])}[lm_kind]
    jd = JaxDecoder(world["jbank"], world["jflat"], lm=lm, lm_weight=3.0)
    td = DeviceBeamDecoder(world["tbank"], world["tflat"], lm=lm,
                           lm_weight=3.0)
    for nbest in (1, 3):
        want = jd.decode_batch(world["feats"], world["n_frames"],
                               return_nbest=nbest)
        got = td.decode_batch(world["feats"], world["n_frames"],
                              return_nbest=nbest)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert len(g) == len(w) == nbest
            assert [h.words for h in g] == [h.words for h in w]
            assert np.allclose([h.score for h in g], [h.score for h in w],
                               rtol=1e-4, atol=0.0)


def test_device_tables_match_jax(world):
    jd = JaxDecoder(world["jbank"], world["jflat"], lm=world["lm"])
    td = DeviceBeamDecoder(world["tbank"], world["tflat"], lm=world["lm"])
    jd._prep_device()
    tabs = td._prep_device()
    assert np.array_equal(tabs.bands.numpy(), np.asarray(jd._j_bands))
    assert tabs.bands.shape[2] == 2  # trimmed to self-loop + next
    senone = np.asarray(jd._j_senone)
    assert np.array_equal(tabs.senone.numpy(), np.clip(senone, 0, None))
    assert np.array_equal(tabs.emitting.numpy(), senone >= 0)
    assert np.array_equal(tabs.node_slot.numpy(), np.asarray(jd._j_node_slot))
    assert np.array_equal(tabs.word_slot.numpy(), np.asarray(jd._j_word_slot))
    par = np.asarray(jd._j_parent)
    assert np.array_equal(tabs.parent.numpy(), np.clip(par, 0, None))
    assert np.array_equal(tabs.has_parent.numpy(), par >= 0)
    assert np.array_equal(tabs.is_root_child.numpy(),
                          np.asarray(jd._j_is_root_child))
    for a, b in zip(tabs.lm_sparse, jd._j_lm_sparse):
        assert np.array_equal(a.numpy(), np.asarray(b))


def separable_world(rng, d=8):
    """``tests/test_streaming_decode.py:_world`` in the port."""
    units = ["n", "i3", "h", "ao3", "m", "a1"]
    cfg = ModelConfig(state_num=5, mix_level=1, max_mix_level=1)
    arrays = tsb.bank_to_numpy(
        tsb.create_bank(len(units), cfg, d, differentiation=False,
                        device="cpu"))
    emb = rng.normal(size=(len(units), d)).astype(np.float32) * 4
    arrays["means"] = np.repeat(emb, cfg.state_num - 2, axis=0)[:, None, :]
    lex = PronunciationLexicon()
    lex.generate(["你好", "你", "马"],
                 PinYin({"你": ["ni3"], "好": ["hao3"], "马": ["ma1"]}))
    dec = DeviceBeamDecoder(tsb.bank_from_numpy(arrays, device="cpu"),
                            FlatLexicon.from_tree(lex.lexicon,
                                                  UnitInventory(units)))

    def utt(ids):
        return np.concatenate([emb[u] + rng.normal(size=(12, d)) * 0.3
                               for u in ids]).astype(np.float32)

    return dec, utt


def test_known_answer(rng):
    dec, utt = separable_world(rng)
    a, b = utt([0, 1, 2, 3]), utt([4, 5])
    feats = np.zeros((2, len(a), a.shape[1]), np.float32)
    feats[0], feats[1, : len(b)] = a, b
    gk.gmm_log_scores_cuda.launches = 0
    out = dec.decode_batch(feats, torch.tensor([len(a), len(b)]),
                           return_nbest=2)
    assert out[0][0].words == ("你好",)
    assert out[1][0].words == ("马",)
    assert gk.gmm_log_scores_cuda.launches == 0  # the CPU runs the plain path


def test_top_k_orders_ties_by_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = _top_k(x, 4)
    assert idx.tolist() == [[1, 2, 4, 3]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0]]


def test_unported_modes_raise(world, rng, tmp_path):
    """``mesh=``, which raised until the parallel tier was ported, decodes:
    on a one-rank mesh as the unsharded call does.  (Block pruning and its
    ``prune_hysteresis``, refused here until they were ported, are held to
    JAX in tests/test_torch_pruned.py.)"""
    import torch.distributed as dist

    from poccala_tpu_torch.parallel.mesh import make_mesh

    dec, utt = separable_world(rng)
    feats = np.stack([utt([4, 5]), utt([0, 1])])
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        got = dec.decode_batch(feats, [24, 24], return_nbest=3,
                               mesh=make_mesh(device="cpu"))
    finally:
        dist.destroy_process_group()
    want = dec.decode_batch(feats, [24, 24], return_nbest=3)
    assert [[h.words for h in u] for u in got] == \
        [[h.words for h in u] for u in want]
    assert [u[0].words for u in got] == [("马",), ("你",)]
    assert [[h.score for h in u] for u in got] == \
        [[h.score for h in u] for u in want]


def test_empty_lexicon_answers_nothing(world):
    lex = PronunciationLexicon()
    lex.generate(["马"], PinYin({"马": ["ma1"]}))
    flat = FlatLexicon.from_tree(lex.lexicon, UnitInventory(["n"]))
    dec = DeviceBeamDecoder(world["tbank"], flat)
    assert flat.n_nodes == 1
    assert dec.decode_batch(world["feats"], world["n_frames"]) == [[], [], []]


@pytest.mark.parametrize("t_pad,ok", [(2**24 - 2, True), (2**24 - 1, False)])
def test_context_packing_guard_at_the_limit(t_pad, ok):
    """``(T+1)(V+1) < 2³¹`` with V+1 = 128: T = 2²⁴-2 is the last frame
    count that packs into int32, T = 2²⁴-1 reaches 2³¹ exactly."""
    if ok:
        check_context_fits(t_pad, 127)
    else:
        with pytest.raises(ValueError, match="overflows int32"):
            check_context_fits(t_pad, 127)


@pytest.mark.parametrize("v,ok", [(46340, True), (46341, False)])
def test_lm_key_guard_at_the_limit(v, ok):
    """``(V+1)V < 2³¹``: 46341·46340 fits, 46342·46341 does not."""
    if ok:
        check_lm_keys_fit(v)
    else:
        with pytest.raises(ValueError, match="overflow int32"):
            check_lm_keys_fit(v)


def test_decode_refuses_an_overflowing_batch(world):
    """The guard runs before any work: a batch of (T+1)(V+1) = 2³¹ frames,
    passed as a broadcast view that allocates nothing, is refused."""
    dec = DeviceBeamDecoder(world["tbank"], world["tflat"])
    dec._prep_device()
    v = dec._n_vocab
    t_pad = -(-2**31 // (v + 1)) - 1
    assert (t_pad + 1) * (v + 1) >= 2**31 > t_pad * (v + 1)
    feats = torch.zeros((1, 1, D)).expand(1, t_pad, D)
    with pytest.raises(ValueError, match="overflows int32"):
        dec.decode_batch(feats, [t_pad])
