"""Streaming decode in the port (``stream_init`` / ``stream_feed`` /
``stream_result`` / ``decode_stream`` and ``DecodeService.open_stream``)
against the JAX decoder's, on ``tests/test_streaming_decode.py``'s world.

Both decoders share one bank (the JAX bank through the numpy weight
converter) and one lexicon; the features come from seeded numpy.  Every
case must give the JAX hypotheses — the same words, scores at rtol
1e-5 — and the port's own one-shot ``decode_batch``.
"""

import dataclasses

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
from poccala_tpu.models import senone_bank as jsb
from poccala_tpu.serve import DecodeService as JaxService
from poccala_tpu_torch.decoder.device import DeviceBeamDecoder
from poccala_tpu_torch.io.corpus import UnitInventory
from poccala_tpu_torch.lexicon import FlatLexicon, PinYin, PronunciationLexicon
from poccala_tpu_torch.models import senone_bank as tsb
from poccala_tpu_torch.serve import DecodeService

torch.set_num_threads(1)

UNITS = ["n", "i3", "h", "ao3", "m", "a1"]
TABLE = {"你": ["ni3"], "好": ["hao3"], "马": ["ma1"]}
D = 8


@pytest.fixture(scope="module")
def world():
    """``tests/test_streaming_decode.py:_world`` built once for both
    packages: a separable bank (one mean per unit) and the three-word
    lexicon."""
    rng = np.random.default_rng(0)
    cfg = ModelConfig(state_num=5, mix_level=1, max_mix_level=1)
    jbank = jsb.create_bank(len(UNITS), cfg, D, differentiation=False)
    emb = rng.normal(size=(len(UNITS), D)).astype(np.float32) * 4
    means = np.repeat(emb, cfg.state_num - 2, axis=0)[:, None, :]
    jbank = dataclasses.replace(jbank, means=jnp.asarray(means))
    tbank = tsb.bank_from_numpy({f: np.asarray(getattr(jbank, f))
                                 for f in tsb.FIELDS})
    jl, tl = JaxLexicon(), PronunciationLexicon()
    jl.generate(["你好", "你", "马"], JaxPinYin(TABLE))
    tl.generate(["你好", "你", "马"], PinYin(TABLE))
    jd = JaxDecoder(jbank, JaxFlat.from_tree(jl.lexicon,
                                             JaxInventory(UNITS)),
                    candidate=3)
    td = DeviceBeamDecoder(tbank, FlatLexicon.from_tree(
        tl.lexicon, UnitInventory(UNITS)), candidate=3)

    def utt(unit_ids, seed, frames_per_unit=12):
        r = np.random.default_rng(seed)
        return np.concatenate([emb[u] + r.normal(size=(frames_per_unit, D))
                               * 0.3 for u in unit_ids]).astype(np.float32)

    return jd, td, utt


def same(got, want, rtol=1e-5):
    """Per-stream n-best lists: the same words, scores at ``rtol``."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g, "a hypothesis must exist"
        assert [h.words for h in g] == [h.words for h in w]
        assert np.allclose([h.score for h in g], [h.score for h in w],
                           rtol=rtol, atol=0.0)


@pytest.mark.parametrize("case", ["four_chunks", "uneven_chunks"])
def test_decode_stream_matches_jax_and_one_shot(world, case):
    jd, td, utt = world
    if case == "four_chunks":
        x = utt([0, 1, 2, 3], seed=1)         # ni3 hao3 -> 你好
        chunks = np.split(x, 4)
    else:
        x = utt([4, 5], seed=2)               # ma1 -> 马
        chunks = [x[:11], x[11:13], x[13:]]
    got = td.decode_stream(chunks, return_nbest=3)
    same(got, jd.decode_stream(chunks, return_nbest=3))
    same(got, td.decode_batch(x[None], [len(x)], return_nbest=3))
    assert got[0][0].words == (("你好",) if case == "four_chunks"
                               else ("马",))


def test_mid_stream_result_then_continue(world):
    """``stream_result`` is a checkpoint, not a terminator."""
    jd, td, utt = world
    x = utt([0, 1, 4, 5], seed=3)             # 你 马
    half = len(x) // 2
    out = {}
    for name, dec in (("jax", jd), ("torch", td)):
        st = dec.stream_init(batch=1, max_frames=len(x))
        st = dec.stream_feed(st, x[:half])
        mid = dec.stream_result(st, return_nbest=2)
        st = dec.stream_feed(st, x[half:])
        out[name] = (mid, dec.stream_result(st, return_nbest=2), st.t_offset)
    same(out["torch"][0], out["jax"][0])
    same(out["torch"][1], out["jax"][1])
    assert out["torch"][2] == out["jax"][2] == len(x)
    same(out["torch"][1], td.decode_batch(x[None], [len(x)], 2))


def test_batched_streams(world):
    jd, td, utt = world
    xa, xb = utt([0, 1], seed=4), utt([4, 5], seed=5)
    feats = np.stack([xa, xb])
    t = len(xa)
    out = {}
    for name, dec in (("jax", jd), ("torch", td)):
        st = dec.stream_init(batch=2, max_frames=t)
        for lo in range(0, t, 8):
            st = dec.stream_feed(st, feats[:, lo:lo + 8])
        out[name] = dec.stream_result(st, return_nbest=2)
    same(out["torch"], out["jax"])
    same(out["torch"], td.decode_batch(feats, [t, t], 2))


def test_padded_final_chunk(world):
    """A final chunk padded to the chunk length with ``n_valid < Tc``
    (as ``ServiceStream`` sends it): the frames past ``n_valid`` are
    frozen, ``t_offset`` still advances by ``Tc``, as in JAX."""
    jd, td, utt = world
    x = utt([0, 1, 2, 3], seed=6)             # 48 frames
    tc = 20
    padded = np.zeros((1, 60, D), np.float32)
    padded[0, : len(x)] = x
    out = {}
    for name, dec in (("jax", jd), ("torch", td)):
        st = dec.stream_init(batch=1, max_frames=60)
        for lo in range(0, 60, tc):
            n = np.array([min(tc, len(x) - lo)], np.int32)
            st = dec.stream_feed(st, padded[:, lo:lo + tc], n_valid=n)
        out[name] = (dec.stream_result(st, return_nbest=2), st.t_offset)
    assert out["torch"][1] == out["jax"][1] == 60
    same(out["torch"][0], out["jax"][0])
    same(out["torch"][0], td.decode_batch(x[None], [len(x)], 2))


def test_capacity_guard(world):
    jd, td, utt = world
    x = utt([0, 1], seed=7)
    for dec in (jd, td):
        st = dec.stream_init(batch=1, max_frames=10)
        with pytest.raises(ValueError, match="max_frames"):
            dec.stream_feed(st, x)


def test_stream_init_refuses_an_int32_overflow(world):
    """The packed context ``(h+1)(V+1) + l`` must fit int32 over the whole
    session: the guard runs at ``stream_init``, before any chunk."""
    _, td, _ = world
    td._prep_device()
    v = td._n_vocab
    t_bad = -(-2**31 // (v + 1)) - 1          # (T+1)(V+1) reaches 2³¹
    with pytest.raises(ValueError, match="overflows int32"):
        td.stream_init(max_frames=t_bad)
    assert td.stream_init(max_frames=t_bad - 1).t_offset == 0


@pytest.mark.parametrize("batch", [1, 2])
def test_service_stream_matches_jax(world, batch):
    """``DecodeService.open_stream`` with the port's decoder against the
    JAX service: the same partial and final hypotheses, and the same
    ``stream_sessions`` / ``stream_chunks`` counts."""
    jd, td, utt = world
    xs = [utt([0, 1, 4, 5], seed=8), utt([4, 5, 0, 1], seed=9)][:batch]
    x = np.stack(xs) if batch > 1 else xs[0]
    out = {}
    for name, svc_cls, dec in (("jax", JaxService, jd),
                               ("torch", DecodeService, td)):
        with svc_cls(dec, batch_size=2) as svc:
            s = svc.open_stream(chunk_frames=10, max_frames=64, batch=batch)
            s.feed(x[..., :17, :])
            mid = s.result(return_nbest=2).result(timeout=120)
            s.feed(x[..., 17:, :])
            final = s.result(return_nbest=2).result(timeout=120)
        out[name] = (mid, final, svc.stats.stream_sessions,
                     svc.stats.stream_chunks, svc.stats.frames)
    g, w = out["torch"], out["jax"]
    wrap = (lambda h: [h]) if batch == 1 else (lambda h: h)
    same(wrap(g[0]), wrap(w[0]))
    same(wrap(g[1]), wrap(w[1]))
    assert g[2:] == w[2:] == (1, 6, 48 * batch)  # 10 + 7 + 3·10 + 1 frames
    one_shot = td.decode_batch(np.stack(xs), [48] * batch, 2)
    same(wrap(g[1]), one_shot)


def test_failing_feed_surfaces_on_result(world):
    """A chunk whose device work fails (here: the wrong feature width)
    must fail the session's next ``result()`` and ``feed()``: the error
    reaches ``ServiceStream._err`` instead of ending the transcript early
    without anyone seeing."""
    _, td, utt = world
    x = utt([0, 1], seed=10)
    with DecodeService(td, batch_size=2) as svc:
        s = svc.open_stream(chunk_frames=8, max_frames=64)
        s.feed(x[:8])
        s.feed(np.zeros((8, D + 1), np.float32))
        with pytest.raises(RuntimeError, match="earlier chunk"):
            s.result().result(timeout=120)
        assert s._err is not None
        with pytest.raises(RuntimeError, match="earlier chunk"):
            s.feed(x[8:16])
        assert svc.stats.stream_chunks == 1
