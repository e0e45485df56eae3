"""The port's command line (``python -m poccala_tpu_torch.cli``) against the
JAX package's (``tests/test_cli.py``'s pipeline) with ``--device cpu``.

Both CLIs run on one synthetic corpus with per-utterance mean
normalisation (CMVN without the variance part: with it, the second
epoch's loglik sums to about -47 from terms of thousands, and its
relative error says nothing) and a deterministic flat start: the
scheme-2 ``--history`` logliks agree within 1e-4 relative,
``align`` gives the JAX CLI's frames on the same checkpoint, and
``decode --decoder device`` its words (scores at rtol 1e-4).  ``listen``'s
final n-best equals ``decode``'s, ``serve`` answers in input order with
``decode``'s 1-best, the reference-layout export/import round-trips, the
flags of the unported parts raise, and ``--device cuda`` without a card
raises instead of running on the CPU.
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


def test_listen_and_serve_match_decode(trained, capsys):
    t = trained["torch"]
    base = [*t["args"]]
    model = ["--checkpoint", t["ckpt"], "--lexicon", t["lex"], "--lm",
             t["lm"]]
    wavs = [os.path.join(t["dirs"]["audio_dir"], f"utt{i:05d}.wav")
            for i in range(3)]
    solo = [json.loads(l) for l in tcpu(
        capsys, *base, "decode", *model, *wavs).strip().splitlines()]
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
def test_unported_flags_raise(trained, argv):
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
    the port's, and ``decode`` defaults to the device tier."""
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
                          "a.wav"]).decoder == "device"
    assert jp.parse_args(["decode", "--checkpoint", "c", "--lexicon", "l",
                          "a.wav"]).decoder == "vector"
    assert tp.parse_args(["align", "--checkpoint", "c"]).device == "cuda"
