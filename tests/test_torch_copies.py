"""The port's own copies of the JAX package's framework-free modules,
pinned to their originals, and the port's default device.

``poccala_tpu_torch`` imports nothing of ``poccala_tpu``
(``tests/test_torch_no_jax.py``): it carries ``config``, ``io.wav``,
``io.audio_device``, ``io.synth_formant``, ``io.dataset``, ``lm.ngram``,
``models.questions``, ``native`` (with ``wavio.cpp``), ``ops.hierarchical``,
``serve``, ``eval``, ``utils.errors`` and the command line's parser as
copies.  Each copy
must keep the original's code (docstrings and the package's own name
aside) and give the original's outputs on seeded numpy inputs, so that
one ``Config`` object, one checkpoint, one WAV file and one LM file serve
both packages.

The second half pins ``utils/device.py``: ``device=None`` means the card,
and without one the entry points raise rather than fall to the CPU.
"""

import argparse
import ast
import dataclasses
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from poccala_tpu import cli as jcli
from poccala_tpu import config as jconfig
from poccala_tpu import native as jnative
from poccala_tpu import serve as jserve
from poccala_tpu.io import synth_formant as jformant
from poccala_tpu.io import wav as jwav
from poccala_tpu.lexicon.pinyin import PinYin as JaxPinYin
from poccala_tpu.lm import ngram as jngram
from poccala_tpu_torch import cli as tcli
from poccala_tpu_torch import config as tconfig
from poccala_tpu_torch import native as tnative
from poccala_tpu_torch import serve as tserve
from poccala_tpu_torch.io import corpus as tcorpus
from poccala_tpu_torch.io import synth_formant as tformant
from poccala_tpu_torch.io import wav as twav
from poccala_tpu_torch.lexicon.pinyin import PinYin
from poccala_tpu_torch.lm import ngram as tngram
from poccala_tpu_torch.models import senone_bank as tsb
from poccala_tpu_torch.ops.frontend import Frontend
from poccala_tpu_torch.train import accumulators as tacc
from poccala_tpu_torch.train import checkpoint as tckpt
from poccala_tpu_torch.train.trainer import Trainer
from poccala_tpu_torch.utils import device as tdevice

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# module -> module-level names whose value the copy deliberately changes
COPIES = {
    "config.py": (),
    "io/wav.py": (),
    "io/audio_device.py": (),
    "lm/__init__.py": (),
    "lm/ngram.py": (),
    "native/__init__.py": ("_BUILD_DIR",),   # build/poccala_tpu_torch/
    "serve.py": (),
    "eval/__init__.py": (),
    "eval/wer.py": (),
    "models/questions.py": (),
    "io/synth_formant.py": (),
    "io/dataset.py": (),
    "utils/errors.py": (),
    "ops/hierarchical.py": (),
}


def code_of(path: Path, drop=()) -> str:
    """The module's code without docstrings, with the package's own name
    normalised and the assignments in ``drop`` left out."""
    tree = ast.parse(path.read_text().replace("poccala_tpu_torch",
                                              "poccala_tpu"))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) \
                and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            # keep a placeholder: a body may not be empty
            body[0] = ast.Pass()
    tree.body = [n for n in tree.body
                 if not (isinstance(n, ast.Assign)
                         and any(getattr(t, "id", None) in drop
                                 for t in n.targets))]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", list(COPIES))
def test_copy_keeps_the_original_code(rel):
    drop = COPIES[rel]
    assert code_of(ROOT / "poccala_tpu_torch" / rel, drop) \
        == code_of(ROOT / "poccala_tpu" / rel, drop)


def test_wavio_source_is_the_original():
    def text(pkg):
        return (ROOT / pkg / "native" / "wavio.cpp").read_text().replace(
            "poccala_tpu_torch", "poccala_tpu")
    assert text("poccala_tpu_torch") == text("poccala_tpu")


def test_native_library_builds_outside_the_package():
    assert Path(tnative._BUILD_DIR) == ROOT / "build" / "poccala_tpu_torch"
    assert tnative.available(), "native toolchain expected in this image"
    assert Path(tnative._LIB_PATH).exists()


# ----------------------------------------------------------------------
# same outputs
# ----------------------------------------------------------------------

OVERRIDES = ["model.mix_level=3", "frontend.vad=false", "train.step=4",
             "decoder.active_blocks=8", "paths.audio_file_path=/x/y",
             "model.score_dtype=bfloat16", "frontend.pre_emphasis=0.95"]


def test_config_defaults_and_overrides_equal():
    j, t = jconfig.Config(), tconfig.Config()
    assert t.to_dict() == j.to_dict()
    j.apply_overrides(OVERRIDES)
    t.apply_overrides(OVERRIDES)
    assert t.to_dict() == j.to_dict()
    assert t.model.mix_level == 3 and t.frontend.vad is False
    assert isinstance(t.frontend.pre_emphasis, float)
    with pytest.raises(Exception):
        t.apply_overrides(["model.no_such_field=1"])


def test_config_ini_round_trip(tmp_path):
    ini = tmp_path / "c.ini"
    ini.write_text("[model]\nmix_level = 5\nstate_num = 5\n"
                   "[frontend]\nvad = false\n[train]\nbatch_size = 16\n")
    assert tconfig.Config.from_ini(str(ini)).to_dict() \
        == jconfig.Config.from_ini(str(ini)).to_dict()


def test_port_takes_the_jax_config_by_duck_typing():
    """One ``poccala_tpu.config.Config`` serves both packages: the port
    never checks the class."""
    cfg = jconfig.Config()
    cfg.model.mix_level = cfg.model.max_mix_level = 2
    inv = tcorpus.UnitInventory(["a", "o"])
    tr = Trainer(cfg, inv, device="cpu")
    assert tr.bank.means.shape == (6, 2, cfg.frontend.feat_dim)
    assert Frontend(cfg.frontend, device="cpu").cfg is cfg.frontend
    for f in dataclasses.fields(jconfig.Config):
        assert type(getattr(tconfig.Config(), f.name)).__name__ \
            == type(getattr(cfg, f.name)).__name__


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_files_cross_read(tmp_path, rng, channels):
    shape = (4000,) if channels == 1 else (4000, 2)
    sig = rng.normal(size=shape) * 3000
    pj, pt = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    jwav.write_wav(pj, sig, 16000)
    twav.write_wav(pt, sig, 16000)
    assert Path(pj).read_bytes() == Path(pt).read_bytes()
    for path in (pj, pt):
        (dj, rj), (dt, rt) = jwav.load_wav(path), twav.load_wav(path)
        assert rj == rt == 16000 and np.array_equal(dj, dt)
        for quirk in (False, True):
            assert np.array_equal(
                twav.preprocess_signal(dt, drop_zeros=quirk),
                jwav.preprocess_signal(dj, drop_zeros=quirk))


def test_formant_corpus_files_equal(tmp_path):
    """One seed, both packages' ``generate_formant_corpus``: byte-equal
    WAVs and labels, the same transcripts; and the same questions."""
    from poccala_tpu.models import questions as jq
    from poccala_tpu_torch.models import questions as tq

    words = ["你好", "马", "我", "好"]
    kw = dict(num_utts=5, words_per_utt=(1, 3), n_speakers=2, seed=3,
              sil_token="sil")
    ja, jl, jt = jformant.generate_formant_corpus(
        str(tmp_path / "j"), words, JaxPinYin(), **kw)
    ta, tl, tt = tformant.generate_formant_corpus(
        str(tmp_path / "t"), words, PinYin(), **kw)
    assert tt == jt and len(tt) == 5
    for jd, td in ((ja, ta), (jl, tl)):
        names = sorted(p.name for p in Path(jd).iterdir())
        assert names == sorted(p.name for p in Path(td).iterdir())
        assert len(names) == 5
        for n in names:
            assert (Path(jd) / n).read_bytes() == (Path(td) / n).read_bytes()
    units = tcorpus.standard_inventory("XIF_tone") + ["sil"]
    got, want = tq.default_questions(units), jq.default_questions(units)
    assert [(q.name, q.members) for q in got] == \
        [(q.name, q.members) for q in want]
    assert len(got) > 10 and tq.split_tone("ang2") == jq.split_tone("ang2")


@pytest.mark.parametrize("smoothing", ["jm", "wb"])
def test_ngram_scores_and_files_equal(tmp_path, rng, smoothing):
    vocab = ["你", "好", "马", "吗", "我"]
    sents = [[vocab[i] for i in rng.integers(0, len(vocab),
                                             size=rng.integers(2, 7))]
             for _ in range(40)]
    j = jngram.Ngram(3, smoothing=smoothing)
    t = tngram.Ngram(3, smoothing=smoothing)
    j.train(sents)
    t.train(sents)
    for w in vocab:
        for ctx in (None, ["你"], ["好", "马"]):
            assert t.logprob(w, ctx) == j.logprob(w, ctx)
    tables = "bigram_tables" if smoothing == "jm" else "bigram_tables_backoff"
    for a, b in zip(getattr(t, tables)(vocab), getattr(j, tables)(vocab)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(t.bigram_matrix(vocab), j.bigram_matrix(vocab))
    # a file written by either package is read by both
    pj, pt = str(tmp_path / "j.lm"), str(tmp_path / "t.lm")
    j.save(pj)
    t.save(pt)
    for path in (pj, pt):
        back_t = tngram.Ngram(3)
        back_t.init_gram(path)
        back_j = jngram.Ngram(3)
        back_j.init_gram(path)
        assert back_t.logprob("好", ["你"]) == back_j.logprob("好", ["你"]) \
            == j.logprob("好", ["你"])


def test_native_batch_loader_equals_per_file_and_original(tmp_path, rng):
    paths = []
    for i, n in enumerate((3000, 5000, 1200)):
        sig = rng.normal(size=n) * 2000
        sig[100:140] = 0.0
        paths.append(str(tmp_path / f"u{i}.wav"))
        twav.write_wav(paths[-1], sig, 16000)
    paths.append(str(tmp_path / "missing.wav"))
    for quirk in (False, True):
        got = tnative.load_wav_batch(paths, 4096, drop_zeros=quirk)
        want = jnative.load_wav_batch(paths, 4096, drop_zeros=quirk)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        sigs, lens, rates = got
        assert lens[-1] == -1
        for i, path in enumerate(paths[:-1]):
            one = twav.preprocess_signal(twav.load_wav(path)[0],
                                         drop_zeros=quirk)[:4096]
            assert lens[i] == len(one) and rates[i] == 16000
            np.testing.assert_allclose(sigs[i, : len(one)], one, rtol=1e-6)


def parser_shape(parser, skip=()):
    """{subcommand: {flag: (default, choices, required, nargs)}}."""
    def flags(p):
        return {a.option_strings[0] if a.option_strings else a.dest:
                (a.default, a.choices and tuple(a.choices), a.required,
                 a.nargs)
                for a in p._actions
                if not isinstance(a, (argparse._HelpAction,
                                      argparse._SubParsersAction))
                and a.dest not in skip}
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {"": flags(parser),
            **{name: flags(sp) for name, sp in sub.choices.items()}}


def test_parser_is_the_jax_parser_plus_device():
    """Flags, defaults, choices and positionals of every subcommand; the
    port adds ``--device``.  ``decode``'s default tier is JAX's."""
    j = parser_shape(jcli.build_parser())
    t = parser_shape(tcli.build_parser())
    assert t[""].pop("--device") == ("cuda", None, False, None)
    assert t["decode"]["--decoder"] == j["decode"]["--decoder"]
    assert j["decode"]["--decoder"][0] == "vector"
    assert t == j


class StubDecoder:
    """A deterministic stand-in with the device decoder's serving surface:
    the 'hypothesis' of an utterance is a checksum of its valid frames."""

    def decode_dispatch(self, feats, n_frames, return_nbest=1, mesh=None):
        return np.asarray(feats), np.asarray(n_frames), return_nbest

    def decode_collect(self, handle):
        feats, n_frames, nbest = handle
        return [[("utt", round(float(f[:n].sum()), 3), k)
                 for k in range(nbest)] if n else []
                for f, n in zip(feats, n_frames)]

    def stream_init(self, batch=1, max_frames=4096):
        return {"sum": np.zeros(batch), "frames": 0, "max": max_frames}

    def stream_feed(self, st, feats, n_valid=None):
        feats = np.asarray(feats)
        feats = feats[None] if feats.ndim == 2 else feats
        n = feats.shape[1] if n_valid is None else int(n_valid[0])
        st["sum"] = st["sum"] + feats[:, :n].sum(axis=(1, 2))
        st["frames"] += n
        return st

    def stream_result(self, st, return_nbest=1):
        return [[("stream", round(float(s), 3), st["frames"], k)
                 for k in range(return_nbest)] for s in st["sum"]]


@pytest.mark.parametrize("mod", [jserve, tserve], ids=["jax", "port"])
def test_service_and_stream_results(mod, rng):
    """Both packages' DecodeService / ServiceStream, over the same decoder
    outputs, give the same answers and counters."""
    rng = np.random.default_rng(11)
    utts = [rng.normal(size=(int(n), 5)).astype(np.float32)
            for n in rng.integers(10, 90, size=9)]
    with mod.DecodeService(StubDecoder(), batch_size=4, frame_bucket=32,
                           return_nbest=2) as svc:
        got = svc.decode_many(utts)
        with svc.open_stream(chunk_frames=8, max_frames=96) as stream:
            for lo in range(0, len(utts[0]), 13):
                stream.feed(utts[0][lo: lo + 13])
            streamed = stream.result(return_nbest=2).result(timeout=60)
        stats = svc.stats
    want = [[("utt", round(float(u.sum()), 3), k) for k in range(2)]
            for u in utts]
    assert got == want
    assert [h[:2] for h in streamed] == \
        [("stream", pytest.approx(float(utts[0].sum()), abs=2e-3))] * 2
    assert streamed[0][2] == len(utts[0])
    assert stats.requests == 9
    assert stats.frames == sum(map(len, utts)) + len(utts[0])  # + the stream
    assert stats.stream_sessions == 1
    assert stats.stream_chunks == -(-len(utts[0]) // 8)
    assert all(t % 32 == 0 and b == 4 for b, t in stats.shapes)
    assert set(stats.latency_summary()) == {"n", "p50_ms", "p95_ms",
                                            "p99_ms", "mean_ms", "max_ms"}
    with pytest.raises(RuntimeError):
        svc.submit(utts[0])


def test_serve_is_the_ports_own():
    assert tserve.DecodeService is not jserve.DecodeService
    for name in ("DecodeService", "ServiceStream", "ServiceStats"):
        assert getattr(tserve, name).__module__ == "poccala_tpu_torch.serve"
    assert importlib.import_module("poccala_tpu_torch.lm").Ngram \
        is tngram.Ngram


# ----------------------------------------------------------------------
# the default device
# ----------------------------------------------------------------------

@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def small_cfg():
    cfg = tconfig.Config()
    cfg.model.mix_level = cfg.model.max_mix_level = 1
    return cfg


def test_resolve(no_card):
    assert tdevice.resolve("cpu") == torch.device("cpu")
    assert tdevice.resolve(torch.device("cpu")).type == "cpu"
    for dev in (None, "cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdevice.resolve(dev)


def test_resolve_none_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tdevice.resolve(None) == torch.device("cuda")
    assert tdevice.resolve("cuda:1") == torch.device("cuda", 1)


def entry_points(tmp_path):
    """name -> callable(device) for every entry point that places state."""
    cfg = small_cfg()
    inv = tcorpus.UnitInventory(["a", "o"])
    bank = tsb.create_bank(2, cfg.model, 4, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(ckpt, bank, units=inv.units)
    ref = str(tmp_path / "ref")
    tckpt.export_reference_layout(ref, bank, inv, "XIF")
    stats = {f: np.zeros((2, 2), np.float32) for f in tacc.STATS_FIELDS}
    return {
        "Trainer": lambda d: Trainer(cfg, inv, device=d).device,
        "Frontend": lambda d: Frontend(cfg.frontend, device=d).device,
        "Corpus": lambda d: tcorpus.Corpus(cfg, inv, pairs=[],
                                           device=d).frontend.device,
        "load_checkpoint":
            lambda d: tckpt.load_checkpoint(ckpt, device=d)[0].means.device,
        "import_reference_layout":
            lambda d: tckpt.import_reference_layout(
                ref, inv, "XIF", cfg.model.state_num, 1,
                device=d).means.device,
        "create_bank":
            lambda d: tsb.create_bank(2, cfg.model, 4, device=d).means.device,
        "bank_from_numpy":
            lambda d: tsb.bank_from_numpy(tsb.bank_to_numpy(bank),
                                          device=d).means.device,
        "stats_from_numpy":
            lambda d: tacc.stats_from_numpy(stats, device=d).loglik.device,
    }


ENTRY_POINTS = ["Trainer", "Frontend", "Corpus", "load_checkpoint",
                "import_reference_layout", "create_bank", "bank_from_numpy",
                "stats_from_numpy"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_default_device_raises_without_a_card(no_card, tmp_path, name):
    call = entry_points(tmp_path)[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call("cuda")


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_cpu_on_request(no_card, tmp_path, name):
    assert entry_points(tmp_path)[name]("cpu").type == "cpu"


def test_positional_defaults_raise_without_a_card(no_card, tmp_path):
    """The calls as a user writes them, with no ``device`` at all."""
    cfg = small_cfg()
    inv = tcorpus.UnitInventory(["a", "o"])
    tckpt.save_checkpoint(str(tmp_path / "c"),
                          tsb.create_bank(2, cfg.model, 4, device="cpu"))
    for call in (lambda: Trainer(cfg, inv), lambda: Frontend(cfg.frontend),
                 lambda: tckpt.load_checkpoint(str(tmp_path / "c")),
                 lambda: tsb.create_bank(2, cfg.model, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
