"""The PyTorch port never imports jax, nor anything of the JAX package.

The machine the port runs on has no jax, so ``poccala_tpu_torch`` (and
``chip_smoke.py``, which drives it there) imports nothing of
``poccala_tpu``, not even a module there that is jax-free: the port keeps
its own copies.  An AST scan pins the rule statically; a subprocess runs
the serving slice (batch and streaming), a block-pruned decode, the
command line and small training runs of both schemes on the CPU and
checks that neither jax nor any ``poccala_tpu`` module was loaded.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ALLOWED = set()   # modules of poccala_tpu the port may import: none
SOURCES = sorted((ROOT / "poccala_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def imported_modules(path: Path):
    """Every module an import statement of ``path`` names (for
    ``from pkg import name`` both ``pkg`` and ``pkg.name``)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, [alias.name]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module, [f"{node.module}.{a.name}"
                                for a in node.names]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for module, names in imported_modules(path):
        top = module.split(".")[0]
        assert top not in ("jax", "jaxlib", "orbax"), (path, module)
        if top == "poccala_tpu":
            assert module in ALLOWED or all(n in ALLOWED for n in names), \
                (path, module, names)


SLICE = textwrap.dedent("""
    import os, sys, tempfile
    import numpy as np, torch
    torch.set_num_threads(1)
    from poccala_tpu_torch.config import Config
    from poccala_tpu_torch.io import wav as wav_io
    from poccala_tpu_torch.decoder.device import DeviceBeamDecoder
    from poccala_tpu_torch.io.corpus import UnitInventory
    from poccala_tpu_torch.lexicon import FlatLexicon, PinYin, PronunciationLexicon
    from poccala_tpu_torch.models.senone_bank import create_bank
    from poccala_tpu_torch.ops import vad
    from poccala_tpu_torch.ops.frontend import Frontend
    from poccala_tpu_torch.serve import DecodeService

    cfg = Config()
    cfg.model.mix_level = cfg.model.max_mix_level = 2
    inv = UnitInventory.standard("XIF_tone")
    bank = create_bank(len(inv), cfg.model, cfg.frontend.feat_dim,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    lex = PronunciationLexicon()
    lex.generate(["你好", "马"], PinYin())
    dec = DeviceBeamDecoder(bank, FlatLexicon.from_tree(lex.lexicon, inv))
    fe = Frontend(cfg.frontend, device="cpu")
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "a.wav")
        sig = rng.normal(size=16000) * 30
        sig[6000:12000] += 3000 * np.sin(np.arange(6000) * 0.08)
        wav_io.write_wav(path, sig, 16000)
        data, _ = wav_io.load_wav(path)
        feats, mask = fe.mfcc(wav_io.preprocess_signal(data))
        packed, n = vad.apply_mask(feats, vad.vad_mask(feats, mask))
    with DecodeService(dec, batch_size=2) as svc:
        hyps = svc.submit(packed[:n]).result(timeout=120)
        # the padded final chunk counts against the capacity
        stream = svc.open_stream(chunk_frames=8, max_frames=-(-n // 8) * 8)
        stream.feed(packed[:n])
        streamed = stream.result().result(timeout=120)
    assert len(hyps) == 1, hyps
    assert [h.words for h in streamed] == [h.words for h in hyps]

    # a block-pruned decode over a synthetic lexicon of ~500 nodes
    from poccala_tpu_torch.lexicon.build import synthetic_lexicon
    big, _, _ = synthetic_lexicon(inv, min_nodes=500, n_chars=8)
    pruned = DeviceBeamDecoder(bank, big, block_size=64, active_blocks=2)
    out = pruned.decode_batch(packed[None, :n], [n])
    assert pruned._prune_on and len(out[0]) == 1, out

    # the command line: checkpoint + lexicon pickle + WAV -> decode
    import contextlib, io, json
    from poccala_tpu_torch import cli
    from poccala_tpu_torch.train.checkpoint import save_checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "a.wav")
        wav_io.write_wav(wav, sig, 16000)
        save_checkpoint(os.path.join(tmp, "ck"), bank, units=inv.units)
        lex.save(os.path.join(tmp, "lex.pkl"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["--device", "cpu", "--set", "model.mix_level=2",
                      "--set", "model.max_mix_level=2", "decode",
                      "--checkpoint", os.path.join(tmp, "ck"),
                      "--lexicon", os.path.join(tmp, "lex.pkl"), wav])
    line = json.loads(buf.getvalue())
    assert line["wav"] == wav and line["nbest"], line

    # a small training step: synthetic corpus -> flat start -> embedded
    # Baum-Welch -> forced alignment -> checkpoint
    from poccala_tpu_torch.io import corpus as tcorpus
    from poccala_tpu_torch.train import alignment
    from poccala_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from poccala_tpu_torch.train.trainer import Trainer
    tinv = tcorpus.UnitInventory(["a", "o", "e"])
    with tempfile.TemporaryDirectory() as tmp:
        audio, label = tcorpus.generate_synthetic_corpus(
            tmp, tinv, num_utts=4, units_per_utt=(2, 3), unit_seconds=0.2)
        tcfg = Config()
        tcfg.paths.audio_file_path, tcfg.paths.label_file_path = audio, label
        tcfg.frontend.vad = False
        tcfg.model.mix_level = tcfg.model.max_mix_level = 1
        tcfg.train.batch_size, tcfg.train.max_frames = 4, 64
        tcfg.train.max_label_len, tcfg.train.proportion = 3, 1.0
        batches = list(tcorpus.Corpus(tcfg, tinv, device="cpu").batches())
        tr = Trainer(tcfg, tinv, device="cpu")
        lls = tr.auto(batches, t=2, mode=2)
        b = batches[0]
        _, lp = alignment.align_batch(tr.bank, b.labels, b.label_lens, b.feats,
                                      b.t_masks, 5, 3)
        save_checkpoint(os.path.join(tmp, "ckpt"), tr.bank)
        bank2, _ = load_checkpoint(os.path.join(tmp, "ckpt"),
                                   device="cpu")
        # scheme 1: uniform segmentation -> k-means -> EM -> batched SMEM
        # -> transmat epoch, then realignment with one more mixture
        tcfg.model.mix_level, tcfg.model.max_mix_level = 3, 4
        tcfg.train.smem, tcfg.train.smem_impl = True, "batched"
        tr1 = Trainer(tcfg, tinv, device="cpu")
        lls1 = tr1.auto(batches, t=2, mode=1, add_mix=True)
    assert lls[1] > lls[0], lls
    assert int((lp >= 0).sum()) > 0
    assert torch.equal(bank2.means, tr.bank.means)
    assert np.isfinite(lls1).all() and tr1.mix_level == 4, lls1
    assert "smem_accepted" in tr1.history[0], tr1.history
    assert "jax" not in sys.modules, "the port imported jax"
    loaded = [m for m in sys.modules if m.split(".")[0] == "poccala_tpu"]
    assert not loaded, f"the port imported the JAX package: {loaded}"
    print("OK", n)
""")


def test_slice_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", SLICE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")
