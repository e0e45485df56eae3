"""The port's command line (``python -m poccala_tpu_torch.cli``) against the
JAX package's (``tests/test_cli.py``'s pipeline) with ``--device cpu``.

Both CLIs run on one synthetic corpus with per-utterance mean
normalisation (CMVN without the variance part: with it, the second
epoch's loglik sums to about -47 from terms of thousands, and its
relative error says nothing) and a deterministic flat start: the
scheme-2 ``--history`` logliks agree within 1e-4 relative,
``align`` gives the JAX CLI's frames on the same checkpoint, and ``decode``
its words on every tier (``--decoder device``, ``vector`` -- the default
of both CLIs -- and ``simple``; scores at rtol 1e-4).  ``listen``'s final
n-best equals the device tier's ``decode``, ``serve`` answers in input
order with its 1-best, the reference-layout export/import round-trips,
the flags that raised while their parts were unported answer, and
``--device cuda`` without a card raises instead of running on the CPU.

The context-dependent workflow (``tests/test_cli.py``'s ``TestCliCdExpand``
corpus): both CLIs run ``cd-expand`` on one CI checkpoint and give the same
triples, trees and senone count (the Viterbi alignment is exact, the
float64 statistics see float32 features of two frontends, and a gain is a
small difference of large log-likelihoods: gains at rtol 1e-5, ten times
what they differed by), and each CLI decodes, with ``--cd``, the checkpoint
and sidecar the other wrote, to the same words.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from poccala_tpu import cli as jcli
from poccala_tpu_torch import cli as tcli

torch.set_num_threads(1)


def run(capsys, main, *argv):
    main(list(argv))
    return capsys.readouterr().out


def tcpu(capsys, *argv):
    return run(capsys, tcli.main, "--device", "cpu", *argv)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("torch_cli"))
    units_file = os.path.join(wd, "units")
    with open(units_file, "w") as f:
        f.write("test units\nn,i3,h,ao3,m,a1\n")
    words_file = os.path.join(wd, "words.txt")
    with open(words_file, "w") as f:
        f.write("你好\n你\n马\n")
    lm_text = os.path.join(wd, "text.txt")
    with open(lm_text, "w") as f:
        f.write("你好 马\n你好\n")
    return dict(wd=wd, units=units_file, words=words_file, lm_text=lm_text)


def common(world, dirs):
    return [
        "--units", world["units"],
        "--set", f"paths.audio_file_path={dirs['audio_dir']}",
        "--set", f"paths.label_file_path={dirs['label_dir']}",
        "--set", "train.load_line=0",
        "--set", "frontend.vad=false",
        "--set", "frontend.cmvn=true",
        "--set", "train.differentiation=false",
        "--set", "model.mix_level=1",
        "--set", "model.max_mix_level=2",
        "--set", "train.max_frames=256",
        "--set", "train.batch_size=6",
        "--set", "train.proportion=1.0",
        "--set", "train.step=4",
    ]


@pytest.fixture(scope="module")
def trained(world, tmp_path_factory):
    """synth-corpus, build-lexicon and train-lm through both CLIs, then
    two scheme-2 rounds of each from its own flat start."""
    # module-scoped fixtures cannot take capsys: read the files instead
    wd = world["wd"]
    outs = {}
    for name, main, pre in (("jax", jcli.main, []),
                            ("torch", tcli.main, ["--device", "cpu"])):
        root = os.path.join(wd, name)
        os.makedirs(root)
        main(pre + ["--units", world["units"], "synth-corpus", "--out", root,
                    "--num-utts", "12"])
        dirs = {"audio_dir": os.path.join(root, "record"),
                "label_dir": os.path.join(root, "label")}
        args = common(world, dirs)
        lex = os.path.join(root, "lex.pkl")
        main(pre + args + ["build-lexicon", "--words", world["words"],
                           "--out", lex])
        lm = os.path.join(root, "lm.json")
        main(pre + args + ["train-lm", "--text", world["lm_text"],
                           "--out", lm])
        ckpt = os.path.join(root, "ckpt")
        hist = os.path.join(root, "hist.json")
        main(pre + args + ["train", "--mode", "2", "--epochs", "2",
                           "--checkpoint", ckpt, "--history", hist])
        outs[name] = dict(root=root, dirs=dirs, args=args, lex=lex, lm=lm,
                          ckpt=ckpt, hist=hist)
    return outs


def test_synth_lexicon_and_lm_files_equal(trained):
    j, t = trained["jax"], trained["torch"]
    for sub in ("record", "label"):
        names = sorted(os.listdir(os.path.join(j["root"], sub)))
        assert names == sorted(os.listdir(os.path.join(t["root"], sub)))
        for n in names:
            with open(os.path.join(j["root"], sub, n), "rb") as a, \
                    open(os.path.join(t["root"], sub, n), "rb") as b:
                assert a.read() == b.read(), n
    with open(j["lex"], "rb") as a, open(t["lex"], "rb") as b:
        assert pickle.load(a) == pickle.load(b)
    with open(j["lm"]) as a, open(t["lm"]) as b:
        assert json.load(a) == json.load(b)


def test_train_history_matches_jax(trained):
    with open(trained["jax"]["hist"]) as f:
        want = [h["loglik"] for h in json.load(f)]
    with open(trained["torch"]["hist"]) as f:
        hist = json.load(f)
    got = [h["loglik"] for h in hist]
    assert len(got) == 2 and got[1] > got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert os.path.exists(os.path.join(trained["torch"]["ckpt"], "bank.npz"))


def test_train_resume_scheme1_with_mixture_growth(trained, capsys):
    """tests/test_cli.py's step 3 on the port: scheme-1 rounds resumed
    from the scheme-2 checkpoint (round 2), growing to two mixtures."""
    import shutil

    from poccala_tpu_torch.train import checkpoint as ck

    t = trained["torch"]
    ckpt = os.path.join(t["root"], "ckpt_s1")
    shutil.copytree(t["ckpt"], ckpt)
    hist = os.path.join(t["root"], "hist_s1.json")
    tcpu(capsys, *t["args"], "train", "--mode", "1", "--epochs", "3",
         "--no-init", "--add-mix", "--checkpoint", ckpt, "--resume",
         "--history", hist)
    with open(hist) as f:
        rounds = json.load(f)
    assert len(rounds) == 1 and rounds[0]["mode"] == 1
    assert np.isfinite(rounds[0]["loglik"])
    bank, man = ck.load_checkpoint(ckpt, device="cpu")
    assert man["round"] == 3 and man["mode"] == 1 and man["mix_level"] == 2
    assert torch.isfinite(bank.means).all()


def test_align_matches_jax(trained, capsys):
    j = trained["jax"]
    want = run(capsys, jcli.main, *j["args"], "align", "--checkpoint",
               j["ckpt"])
    got = tcpu(capsys, *j["args"], "align", "--checkpoint", j["ckpt"])
    want = [json.loads(l) for l in want.strip().splitlines()]
    got = [json.loads(l) for l in got.strip().splitlines()]
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g["frames"] == w["frames"]
        assert np.isclose(g["score"], w["score"], rtol=1e-4)


@pytest.mark.parametrize("prune", [False, True])
def test_decode_matches_jax(trained, capsys, prune):
    """``decode --decoder device`` on the JAX CLI's checkpoint; with the
    block-pruning knobs set (a no-op on this 4-node lexicon, as in
    tests/test_cli.py, so the plumbing runs)."""
    j = trained["jax"]
    knobs = (["--set", "decoder.active_blocks=2", "--set",
              "decoder.block_size=8"] if prune else [])
    wavs = [os.path.join(j["dirs"]["audio_dir"], f"utt{i:05d}.wav")
            for i in range(3)]
    argv = [*j["args"], *knobs, "decode", "--decoder", "device",
            "--checkpoint", j["ckpt"], "--lexicon", j["lex"], "--lm", j["lm"],
            *wavs]
    want = [json.loads(l) for l in
            run(capsys, jcli.main, *argv).strip().splitlines()]
    got = [json.loads(l) for l in tcpu(capsys, *argv).strip().splitlines()]
    assert [g["wav"] for g in got] == wavs
    assert any(g["nbest"] for g in got)
    for g, w in zip(got, want):
        assert [h["words"] for h in g["nbest"]] == \
            [h["words"] for h in w["nbest"]]
        assert np.allclose([h["score"] for h in g["nbest"]],
                           [h["score"] for h in w["nbest"]], rtol=1e-4)


def test_decode_sticky_pruning_matches_jax(trained, capsys, tmp_path):
    """``decode --decoder device`` with ``decoder.active_blocks``,
    ``decoder.block_size`` and ``decoder.prune_hysteresis = 4.0`` set in
    the config, over a lexicon of every word of up to four 你 / 好
    characters (a node a character: 31 nodes in 4 blocks of 8, 2 active,
    so the pruning and its sticky selection run): the JAX CLI's words on
    its checkpoint."""
    import itertools

    from poccala_tpu_torch.io.corpus import UnitInventory
    from poccala_tpu_torch.lexicon import FlatLexicon, PronunciationLexicon

    j = trained["jax"]
    words = tmp_path / "words.txt"
    words.write_text("".join("".join(w) + "\n" for r in (1, 2, 3, 4)
                             for w in itertools.product("你好", repeat=r)))
    lex = str(tmp_path / "lex.pkl")
    run(capsys, jcli.main, *j["args"], "build-lexicon", "--words", str(words),
        "--out", lex)
    tree = PronunciationLexicon()
    tree.load(lex)
    inv = UnitInventory(["n", "i3", "h", "ao3", "m", "a1"])
    assert FlatLexicon.from_tree(tree.lexicon, inv).n_nodes == 31
    knobs = ["--set", "decoder.active_blocks=2", "--set",
             "decoder.block_size=8", "--set", "decoder.prune_hysteresis=4.0"]
    wavs = [os.path.join(j["dirs"]["audio_dir"], f"utt{i:05d}.wav")
            for i in range(4)]
    argv = [*j["args"], *knobs, "decode", "--decoder", "device",
            "--checkpoint", j["ckpt"], "--lexicon", lex, *wavs]
    want = [json.loads(l) for l in
            run(capsys, jcli.main, *argv).strip().splitlines()]
    got = [json.loads(l) for l in tcpu(capsys, *argv).strip().splitlines()]
    assert any(g["nbest"] for g in got)
    for g, w in zip(got, want):
        assert [h["words"] for h in g["nbest"]] == \
            [h["words"] for h in w["nbest"]]
        assert np.allclose([h["score"] for h in g["nbest"]],
                           [h["score"] for h in w["nbest"]], rtol=1e-4)


@pytest.mark.parametrize("tier", ["vector", "simple", "default"])
def test_host_tier_decode_matches_jax(trained, capsys, tier):
    """``decode --decoder vector|simple`` of both CLIs on the JAX CLI's
    checkpoint, with the bigram LM and ``--rescore-lm``: the same n-best
    words, scores at rtol 1e-4.  Without ``--decoder`` both CLIs print
    what ``--decoder vector`` prints."""
    j = trained["jax"]
    wavs = [os.path.join(j["dirs"]["audio_dir"], f"utt{i:05d}.wav")
            for i in range(3)]
    flag = [] if tier == "default" else ["--decoder", tier]
    argv = [*j["args"], "decode", *flag, "--checkpoint", j["ckpt"],
            "--lexicon", j["lex"], "--lm", j["lm"], "--rescore-lm", j["lm"],
            *wavs]
    want = [json.loads(l) for l in
            run(capsys, jcli.main, *argv).strip().splitlines()]
    got = [json.loads(l) for l in tcpu(capsys, *argv).strip().splitlines()]
    assert [g["wav"] for g in got] == wavs
    assert all(g["nbest"] for g in got)
    for g, w in zip(got, want):
        assert [h["words"] for h in g["nbest"]] == \
            [h["words"] for h in w["nbest"]]
        assert np.allclose([h["score"] for h in g["nbest"]],
                           [h["score"] for h in w["nbest"]], rtol=1e-4)
    if tier == "default":
        argv[argv.index("decode") + 1:argv.index("decode") + 1] = \
            ["--decoder", "vector"]
        vector = [json.loads(l) for l in tcpu(capsys, *argv).strip()
                  .splitlines()]
        assert vector == got


def test_listen_and_serve_match_decode(trained, capsys):
    t = trained["torch"]
    base = [*t["args"]]
    model = ["--checkpoint", t["ckpt"], "--lexicon", t["lex"], "--lm",
             t["lm"]]
    wavs = [os.path.join(t["dirs"]["audio_dir"], f"utt{i:05d}.wav")
            for i in range(3)]
    solo = [json.loads(l) for l in tcpu(
        capsys, *base, "decode", "--decoder", "device", *model,
        *wavs).strip().splitlines()]
    assert all(s["nbest"] for s in solo)

    lines = [json.loads(l) for l in tcpu(
        capsys, *base, "listen", *model, "--wav", wavs[0],
        "--chunk-frames", "16").strip().splitlines()]
    partials = [l for l in lines[:-1] if "partial" in l]
    assert len(partials) >= 2
    assert partials[-1]["frames"] > partials[0]["frames"]
    final = lines[-1]["final"]
    assert [h["words"] for h in final] == \
        [h["words"] for h in solo[0]["nbest"]]
    assert np.allclose([h["score"] for h in final],
                       [h["score"] for h in solo[0]["nbest"]], rtol=1e-5)

    wav_list = os.path.join(t["root"], "wavs.txt")
    with open(wav_list, "w") as f:
        f.write("\n".join(wavs) + "\n")
    served = [json.loads(l) for l in tcpu(
        capsys, *base, "serve", *model, "--list", wav_list, "--batch-size",
        "2", "--frame-bucket", "32", "--nbest", "2").strip().splitlines()]
    assert [s["wav"] for s in served] == wavs
    for s, d in zip(served, solo):
        assert s["nbest"][0]["words"] == d["nbest"][0]["words"]
        assert np.isclose(s["nbest"][0]["score"], d["nbest"][0]["score"],
                          rtol=1e-5)


def test_export_import_round_trip(trained, capsys):
    from poccala_tpu_torch.train import checkpoint as ck

    t = trained["torch"]
    ref_dir = os.path.join(t["root"], "refparams")
    tcpu(capsys, *t["args"], "--set", "model.unit_type=TESTUNITS",
         "export-ref", "--checkpoint", t["ckpt"], "--out", ref_dir)
    assert os.path.isdir(os.path.join(ref_dir, "TESTUNITS", "n", "HMM"))
    ckpt2 = os.path.join(t["root"], "ckpt2")
    tcpu(capsys, *t["args"], "--set", "model.unit_type=TESTUNITS",
         "import-ref", "--src", ref_dir, "--checkpoint", ckpt2)
    bank1, _ = ck.load_checkpoint(t["ckpt"], device="cpu")
    bank2, _ = ck.load_checkpoint(ckpt2, device="cpu")
    assert torch.allclose(bank1.log_A, bank2.log_A, atol=1e-5)
    # the reference layout keeps each senone's active mixtures only
    active = torch.arange(bank1.max_mix)[None] < bank1.mix_counts[:, None]
    assert torch.equal(bank2.mix_counts, bank1.mix_counts)
    assert torch.allclose(bank1.means[active], bank2.means[active], atol=1e-5)


# ----------------------------------------------------------------------
# context-dependent units
# ----------------------------------------------------------------------

CD_UNITS = ["n", "i3", "h", "ao3", "m", "a1", "sil"]
CD_WORDS = {"你好": ["ni3", "hao3"], "你": ["ni3"], "马": ["ma1"]}
CD_SYLLABLES = {"ni3": ["n", "i3"], "hao3": ["h", "ao3"], "ma1": ["m", "a1"]}


@pytest.fixture(scope="module")
def cd_world(tmp_path_factory):
    """14 utterances of one or two words between silences (word line 0,
    toned-pinyin line 1); a CI checkpoint trained by the JAX CLI; then
    ``cd-expand`` of that checkpoint through each CLI, and one lexicon."""
    from poccala_tpu_torch.io import wav as wav_io
    from poccala_tpu_torch.io.corpus import synth_unit_signal

    wd = str(tmp_path_factory.mktemp("torch_cli_cd"))
    units_file = os.path.join(wd, "units")
    with open(units_file, "w") as f:
        f.write("test units\n" + ",".join(CD_UNITS) + "\n")
    table = os.path.join(wd, "table.dat")
    with open(table, "w") as f:
        f.write("4F60\tni3\n597D\thao3\n9A6C\tma1\n")
    audio, label = os.path.join(wd, "record"), os.path.join(wd, "label")
    os.makedirs(audio)
    os.makedirs(label)
    rng = np.random.default_rng(7)
    keys = list(CD_WORDS)
    for i in range(14):
        ws = [keys[int(rng.integers(len(keys)))]
              for _ in range(int(rng.integers(1, 3)))]
        syls = [s for w in ws for s in CD_WORDS[w]]
        us = ["sil"] + [u for s in syls for u in CD_SYLLABLES[s]] + ["sil"]
        sig = np.concatenate([synth_unit_signal(CD_UNITS.index(u), 3200,
                                                16000, rng) for u in us])
        name = f"utt{i:05d}"
        wav_io.write_wav(os.path.join(audio, name + ".wav"), sig, 16000)
        with open(os.path.join(label, name + ".wav.trn"), "w") as f:
            f.write(" ".join(ws) + "\n"
                    + " ".join(["sil"] + syls + ["sil"]) + "\n")
    args = [
        "--units", units_file,
        "--set", f"paths.audio_file_path={audio}",
        "--set", f"paths.label_file_path={label}",
        "--set", "train.label_format=pinyin",
        "--set", "train.load_line=1",
        "--set", "frontend.vad=false",
        "--set", "frontend.cmvn=true",
        "--set", "train.differentiation=false",
        "--set", "model.mix_level=1",
        "--set", "model.max_mix_level=2",
        "--set", "model.var_floor_scale=0.01",
        "--set", "train.max_frames=256",
        "--set", "train.batch_size=7",
        "--set", "train.proportion=1.0",
        "--set", "train.step=4",
    ]
    ci = os.path.join(wd, "ckpt_ci")
    jcli.main(args + ["train", "--mode", "2", "--epochs", "2",
                      "--checkpoint", ci])
    vocab = os.path.join(wd, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("你好\n你\n马\n")
    lex = os.path.join(wd, "lex.pkl")
    tcli.main(["--device", "cpu"] + args + [
        "build-lexicon", "--words", vocab, "--mandarin-dat", table,
        "--out", lex])
    out = dict(args=args, ci=ci, lex=lex, vocab=vocab, table=table,
               wavs=[os.path.join(audio, f"utt{i:05d}.wav")
                     for i in range(3)])
    for name, main, pre in (("jax", jcli.main, []),
                            ("torch", tcli.main, ["--device", "cpu"])):
        out[name] = dict(ckpt=os.path.join(wd, f"ckpt_cd_{name}"),
                         cd=os.path.join(wd, f"cd_{name}.json"))
        main(pre + args + [
            "cd-expand", "--checkpoint", ci, "--vocab", vocab, "--table",
            table, "--out-checkpoint", out[name]["ckpt"], "--out-cd",
            out[name]["cd"], "--target-senones", "60", "--retrain-epochs",
            "2", "--min-occ", "4", "--map-tau", "8"])
    return out


def test_cd_expand_matches_jax(cd_world):
    from poccala_tpu_torch.train import checkpoint as ck

    with open(cd_world["jax"]["cd"]) as f:
        want = json.load(f)
    with open(cd_world["torch"]["cd"]) as f:
        got = json.load(f)
    for key in ("base_units", "context_free", "triples", "senone_of",
                "n_senones", "question_names", "nodes"):
        assert got[key] == want[key], key
    assert len(got["triples"]) > len(CD_UNITS)
    assert len(got["splits_log"]) == len(want["splits_log"]) > 0
    for g, w in zip(got["splits_log"], want["splits_log"]):
        assert {k: v for k, v in g.items() if k != "gain"} == \
            {k: v for k, v in w.items() if k != "gain"}
        assert np.isclose(g["gain"], w["gain"], rtol=1e-5)
    ci_bank, _ = ck.load_checkpoint(cd_world["ci"], device="cpu")
    tbank, tman = ck.load_checkpoint(cd_world["torch"]["ckpt"], device="cpu")
    jbank, jman = ck.load_checkpoint(cd_world["jax"]["ckpt"], device="cpu")
    assert tman["cd"] is True and jman["cd"] is True
    assert tman["mix_level"] == jman["mix_level"]
    assert tbank.num_states == jbank.num_states == got["n_senones"] \
        >= ci_bank.num_states
    assert tbank.num_units == jbank.num_units == len(got["triples"])
    assert torch.equal(tbank.senone_map, jbank.senone_map)
    # the port writes the JAX CLI's manifest: the same keys, and the
    # same values but for the sidecar's path
    assert set(tman) == set(jman) and "retrain_logliks" not in tman
    assert {k: v for k, v in tman.items() if k != "cd_sidecar"} == \
        {k: v for k, v in jman.items() if k != "cd_sidecar"}
    # two float32 retrains (grouped EM, two Baum-Welch passes, the MAP
    # blend) of one clone on features of two frontends
    for f in ("means", "log_var", "log_A"):
        assert torch.allclose(getattr(tbank, f), getattr(jbank, f),
                              rtol=1e-3, atol=1e-3), f


def cd_decode(capsys, main, pre, cd_world, system, cmd="decode", extra=()):
    sysd = cd_world[system]
    out = run(capsys, main, *pre, *cd_world["args"], cmd, *extra,
              "--checkpoint", sysd["ckpt"], "--lexicon", cd_world["lex"],
              "--cd", sysd["cd"],
              *(cd_world["wavs"] if cmd == "decode" else ()))
    return [json.loads(l) for l in out.strip().splitlines()]


@pytest.mark.parametrize("system", ["jax", "torch"])
def test_cd_decode_matches_jax(cd_world, capsys, system):
    """A CD checkpoint and sidecar written by either CLI, decoded by
    both."""
    device = ["--decoder", "device"]
    want = cd_decode(capsys, jcli.main, [], cd_world, system, extra=device)
    got = cd_decode(capsys, tcli.main, ["--device", "cpu"], cd_world, system,
                    extra=device)
    assert [g["wav"] for g in got] == cd_world["wavs"]
    assert all(g["nbest"] for g in got)
    for g, w in zip(got, want):
        assert [h["words"] for h in g["nbest"]] == \
            [h["words"] for h in w["nbest"]]
        assert np.allclose([h["score"] for h in g["nbest"]],
                           [h["score"] for h in w["nbest"]], rtol=1e-4)


def test_cd_systems_decode_to_the_same_words(cd_world, capsys):
    pre, device = ["--device", "cpu"], ["--decoder", "device"]
    a = cd_decode(capsys, tcli.main, pre, cd_world, "jax", extra=device)
    b = cd_decode(capsys, tcli.main, pre, cd_world, "torch", extra=device)
    assert [x["nbest"][0]["words"] for x in a] == \
        [x["nbest"][0]["words"] for x in b]


def test_cd_listen_and_serve_match_decode(cd_world, capsys):
    pre = ["--device", "cpu"]
    solo = cd_decode(capsys, tcli.main, pre, cd_world, "torch",
                     extra=["--decoder", "device"])
    lines = cd_decode(capsys, tcli.main, pre, cd_world, "torch", "listen",
                      ["--wav", cd_world["wavs"][0], "--chunk-frames", "16"])
    assert [h["words"] for h in lines[-1]["final"]] == \
        [h["words"] for h in solo[0]["nbest"]]
    wav_list = os.path.join(os.path.dirname(cd_world["lex"]), "wavs.txt")
    with open(wav_list, "w") as f:
        f.write("\n".join(cd_world["wavs"]) + "\n")
    served = cd_decode(capsys, tcli.main, pre, cd_world, "torch", "serve",
                       ["--list", wav_list, "--batch-size", "2",
                        "--frame-bucket", "32"])
    assert [s["wav"] for s in served] == cd_world["wavs"]
    for s, d in zip(served, solo):
        assert s["nbest"][0]["words"] == d["nbest"][0]["words"]


def test_cd_sidecar_of_another_inventory_is_refused(cd_world, trained):
    t = trained["torch"]
    with pytest.raises(SystemExit, match="base inventory"):
        tcli.main(["--device", "cpu", *t["args"], "decode", "--checkpoint",
                   t["ckpt"], "--lexicon", t["lex"], "--cd",
                   cd_world["torch"]["cd"], cd_world["wavs"][0]])


@pytest.mark.parametrize("argv", [
    ["decode", "--decoder", "vector"],
    ["decode", "--decoder", "simple"],
    ["decode", "--cd", "cd.json"],
    ["decode", "--distributed"],
    ["serve", "--distributed"],
    ["listen", "--cd", "cd.json"],
    ["cd-expand"],
    ["train", "--distributed"],
], ids=lambda a: "-".join(x.strip("-") for x in a[:2]))
def test_unported_flags_raise(trained, cd_world, capsys, argv):
    """The flags that raised while their parts were unported answer:
    ``--cd`` and ``cd-expand`` (context-dependent units), ``--distributed``
    (the parallel tier: on a one-rank CPU mesh ``decode --decoder device``
    and ``serve`` print what they print without it, and ``train`` writes
    its checkpoint) and ``--decoder vector|simple`` (the host decoder
    tiers: every WAV gets a non-empty n-best)."""
    if "--decoder" in argv:
        t = trained["torch"]
        wavs = [os.path.join(t["dirs"]["audio_dir"], f"utt{i:05d}.wav")
                for i in range(2)]
        lines = [json.loads(l) for l in tcpu(
            capsys, *t["args"], *argv, "--checkpoint", t["ckpt"],
            "--lexicon", t["lex"], *wavs).strip().splitlines()]
        assert [l["wav"] for l in lines] == wavs
        assert all(l["nbest"] and l["nbest"][0]["words"] for l in lines)
        return
    if "--distributed" in argv:
        t = trained["torch"]
        wav = os.path.join(t["dirs"]["audio_dir"], "utt00000.wav")
        if argv[0] == "train":
            ckpt = os.path.join(t["root"], "ckpt_distributed")
            tcpu(capsys, *t["args"], "train", "--epochs", "1",
                 "--checkpoint", ckpt, "--distributed")
            assert os.path.exists(os.path.join(ckpt, "bank.npz"))
        else:
            tail = [wav]
            if argv[0] == "serve":
                tail = ["--list", os.path.join(t["root"], "one_wav.txt")]
                with open(tail[1], "w") as f:
                    f.write(wav + "\n")
            model = ["--checkpoint", t["ckpt"], "--lexicon", t["lex"]]
            if argv[0] == "decode":
                model += ["--decoder", "device"]
            got = tcpu(capsys, *t["args"], argv[0], *model, *tail,
                       "--distributed")
            want = tcpu(capsys, *t["args"], argv[0], *model, *tail)
            assert got == want and json.loads(got.splitlines()[0])["nbest"]
        assert not torch.distributed.is_initialized()
        return
    if "--cd" in argv:
        lines = cd_decode(
            capsys, tcli.main, ["--device", "cpu"], cd_world, "torch",
            argv[0], ["--wav", cd_world["wavs"][0]] * (argv[0] == "listen"))
        answer = lines[-1]["final"] if argv[0] == "listen" \
            else lines[0]["nbest"]
        assert answer and answer[0]["words"]
        return
    if argv[0] == "cd-expand":
        sysd = cd_world["torch"]
        assert os.path.exists(os.path.join(sysd["ckpt"], "bank.npz"))
        with open(sysd["cd"]) as f:
            assert json.load(f)["n_senones"] > 3 * len(CD_UNITS) - 3
        return
    t = trained["torch"]
    model = ["--checkpoint", t["ckpt"]]
    if argv[0] in ("decode", "listen", "serve"):
        model += ["--lexicon", t["lex"]]
    tail = [os.path.join(t["dirs"]["audio_dir"], "utt00000.wav")] \
        if argv[0] == "decode" else []
    if argv[0] == "train":
        model = []
    if argv[0] == "cd-expand":
        model += ["--vocab", "v.txt", "--out-checkpoint", "o",
                  "--out-cd", "cd.json"]
    with pytest.raises(NotImplementedError, match="not ported"):
        tcli.main(["--device", "cpu", *t["args"], *argv, *model, *tail])


def test_device_cuda_without_a_card_raises(trained, monkeypatch):
    t = trained["torch"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([*t["args"], "align", "--checkpoint", t["ckpt"]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--device", "cuda", *t["args"], "train", "--epochs", "1"])


def test_parser_is_the_jax_flag_set_with_port_handlers():
    """The port reuses the JAX CLI's parser: every subcommand and option
    string is JAX's, apart from the global ``--device``; every handler is
    the port's, and ``decode`` defaults to JAX's ``vector`` tier."""
    import argparse

    def subcommands(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        return sub.choices

    def options(parser):
        return {s for a in parser._actions for s in a.option_strings}

    jp, tp = jcli.build_parser(), tcli.build_parser()
    assert options(tp) == options(jp) | {"--device"}
    jsub, tsub = subcommands(jp), subcommands(tp)
    assert list(tsub) == list(jsub)
    for name, sp in tsub.items():
        assert options(sp) == options(jsub[name]), name
        assert sp.get_default("fn") is tcli.COMMANDS[name], name
        assert sp.get_default("fn").__module__ == "poccala_tpu_torch.cli"
    assert tp.parse_args(["decode", "--checkpoint", "c", "--lexicon", "l",
                          "a.wav"]).decoder == "vector"
    assert jp.parse_args(["decode", "--checkpoint", "c", "--lexicon", "l",
                          "a.wav"]).decoder == "vector"
    assert tp.parse_args(["align", "--checkpoint", "c"]).device == "cuda"
