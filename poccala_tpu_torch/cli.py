"""Command-line driver of the PyTorch port (port of ``poccala_tpu/cli.py``).

    python -m poccala_tpu_torch.cli [--device cuda|cpu] [--config INI]
        [--set KEY=VALUE ...] [--units FILE|KIND] <command> ...

The subcommands, flags and JSON output lines are the JAX CLI's (the
port keeps its own copy of ``build_parser``, with its own handlers):

* ``train``      — ``Trainer.auto`` (schemes 1/2, mixture growth,
                   round-granular checkpoint/resume)
* ``align``      — Viterbi forced alignment over a corpus
* ``decode``     — WAV(s) → word hypotheses via the device decoder
                   (exact or block-pruned search, ``--set
                   decoder.active_blocks=K decoder.block_size=N``), with an
                   optional n-best rescore by a higher-order LM
* ``listen``     — microphone window (or ``--wav``) → stream decode with a
                   partial 1-best per chunk
* ``serve``      — WAV paths → :class:`~poccala_tpu_torch.serve.DecodeService`
* ``export-ref`` / ``import-ref`` — reference parameter-layout interop
* ``synth-corpus`` — generate a synthetic WAV corpus
* ``build-lexicon`` — word list → pronunciation-lexicon pickle
* ``train-lm``   — text → N-gram counts

One addition: the global ``--device`` (default ``cuda``) places the bank,
the frontend and the trainer (:func:`poccala_tpu_torch.utils.device.resolve`).
``--device cuda`` without a CUDA device raises; nothing falls back to the
CPU.

Deviations while the port is partial (``ROADMAP.md`` Queue 1): ``decode``
defaults to ``--decoder device``, where the JAX CLI defaults to the host
``vector`` tier, because the host tiers are not ported and ``--decoder
vector|simple`` raise; ``cd-expand``, ``--cd`` (context-dependent units)
and ``--distributed`` raise ``NotImplementedError`` too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def _load_config(args) -> "Config":
    from poccala_tpu_torch.config import Config

    cfg = Config.from_ini(args.config) if args.config else Config()
    if args.set:
        cfg.apply_overrides(args.set)
    return cfg


def _load_inventory(cfg, args):
    from poccala_tpu_torch.io.corpus import UnitInventory

    if args.units and os.path.exists(args.units):
        return UnitInventory.from_file(args.units)
    kind = args.units or cfg.model.unit_type
    return UnitInventory.standard(kind)


def _device(args) -> torch.device:
    """The ``--device`` of the commands that place tensors; a CUDA device
    that is not there is an error, never a reason to run on the CPU."""
    from poccala_tpu_torch.utils.device import resolve

    return resolve(args.device)


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to poccala_tpu_torch yet (ROADMAP.md "
        f"Queue 1 item {item}); use python -m poccala_tpu.cli")


def _check_unported(args) -> None:
    if getattr(args, "distributed", False):
        _not_ported("--distributed (the device mesh)", "6")
    if getattr(args, "cd", None):
        _not_ported("--cd (context-dependent decoding)", "5")


def _load_decode_graph(args, inv):
    """Lexicon pickle -> FlatLexicon."""
    from poccala_tpu_torch.lexicon import FlatLexicon, PronunciationLexicon

    lex = PronunciationLexicon()
    lex.load(args.lexicon)
    return FlatLexicon.from_tree(lex.lexicon, inv)


def _load_lm(args):
    if not args.lm:
        return None
    from poccala_tpu_torch.lm.ngram import Ngram

    lm = Ngram(args.lm_order)
    lm.init_gram(args.lm)
    return lm


def _device_decoder(args, cfg, inv, dev):
    """Checkpoint + lexicon + LM -> :class:`DeviceBeamDecoder` on ``dev``,
    with the block-pruning knobs from ``cfg.decoder``."""
    from poccala_tpu_torch.decoder.device import DeviceBeamDecoder
    from poccala_tpu_torch.train import checkpoint as ckpt

    bank, _ = ckpt.load_checkpoint(args.checkpoint, device=dev)
    flat = _load_decode_graph(args, inv)
    return DeviceBeamDecoder(bank, flat, beam=args.beam, lm=_load_lm(args),
                             normalizer=cfg.model.gaussian_normalizer,
                             score_dtype=cfg.model.score_dtype,
                             block_size=cfg.decoder.block_size,
                             active_blocks=cfg.decoder.active_blocks or None,
                             prune_hysteresis=cfg.decoder.prune_hysteresis)


def _features_fn(cfg, dev):
    """WAV path -> VAD-packed ``[T, D]`` features, as the JAX CLI computes
    them (``cmd_decode``/``cmd_serve``), with the frontend on ``dev``."""
    from poccala_tpu_torch.io import wav as wav_io
    from poccala_tpu_torch.ops import vad as vad_ops
    from poccala_tpu_torch.ops.frontend import Frontend

    fe = Frontend(cfg.frontend, device=dev)

    def features(path):
        data, _ = wav_io.load_wav(path)
        sig = wav_io.preprocess_signal(
            data, drop_zeros=cfg.frontend.reference_quirks)
        feats, mask = fe.mfcc(sig)
        keep = vad_ops.vad_mask(feats, mask) if cfg.frontend.vad else mask
        packed, n = vad_ops.apply_mask(feats, keep)
        return packed[: int(n)]

    return features


def _print_nbest(path, hyps, **kw):
    print(json.dumps({
        "wav": path,
        "nbest": [{"words": list(h.words), "score": h.score} for h in hyps],
    }, ensure_ascii=False), **kw)


def cmd_train(args):
    from poccala_tpu_torch.io.corpus import Corpus
    from poccala_tpu_torch.train import checkpoint as ckpt
    from poccala_tpu_torch.train.trainer import Trainer

    _check_unported(args)
    dev = _device(args)
    cfg = _load_config(args)
    inv = _load_inventory(cfg, args)
    corpus = Corpus(cfg, inv, device=dev)
    print(f"corpus: {len(corpus.pairs)} utterances, {len(inv)} units",
          file=sys.stderr)
    batches = list(corpus.batches())
    tr = Trainer(cfg, inv, device=dev)

    start_round = 0
    if args.resume and args.checkpoint and os.path.isdir(args.checkpoint):
        tr.bank, manifest = ckpt.load_checkpoint(args.checkpoint, device=dev)
        tr.mix_level = manifest.get("mix_level", tr.mix_level)
        start_round = manifest.get("round", 0)
        print(f"resumed at round {start_round}", file=sys.stderr)

    init = args.init and start_round == 0
    for r in range(start_round, args.epochs):
        lls = tr.auto(batches, t=1, mode=args.mode, init=init,
                      add_mix=args.add_mix)
        init = False
        print(f"round {r}: loglik={lls[0]:.2f}", file=sys.stderr)
        if args.checkpoint:
            ckpt.save_checkpoint(
                args.checkpoint, tr.export_bank(),
                {"round": r + 1, "mode": args.mode, "mix_level": tr.mix_level},
                units=inv.units,
            )
    if args.history:
        with open(args.history, "w") as f:
            json.dump(tr.history, f, indent=2)


def cmd_align(args):
    from poccala_tpu_torch.io.corpus import Corpus
    from poccala_tpu_torch.train import alignment as align
    from poccala_tpu_torch.train import checkpoint as ckpt

    dev = _device(args)
    cfg = _load_config(args)
    inv = _load_inventory(cfg, args)
    bank, _ = ckpt.load_checkpoint(args.checkpoint, device=dev)
    corpus = Corpus(cfg, inv, device=dev)
    for batch in corpus.batches():
        scores, lp = align.align_batch(
            bank, batch.labels, batch.label_lens, batch.feats, batch.t_masks,
            cfg.model.state_num, cfg.train.max_label_len,
        )
        scores, lp = scores.cpu().numpy(), lp.cpu().numpy()
        for i in range(len(lp)):
            units = [inv.units[batch.labels[i][p]] if p >= 0 else "-"
                     for p in lp[i][np.asarray(batch.t_masks[i])]]
            print(json.dumps({"score": float(scores[i]), "frames": units},
                             ensure_ascii=False))


def cmd_decode(args):
    if args.decoder != "device":
        _not_ported(f"--decoder {args.decoder} (the host decoder tiers)", "7")
    _check_unported(args)
    dev = _device(args)
    cfg = _load_config(args)
    inv = _load_inventory(cfg, args)
    dec = _device_decoder(args, cfg, inv, dev)
    features = _features_fn(cfg, dev)
    packs = [features(path) for path in args.wavs]
    # one batched decode
    t_max = max(len(p) for p in packs)
    feats_b = np.zeros((len(packs), t_max, packs[0].shape[1]), np.float32)
    nf = np.zeros(len(packs), np.int32)
    for i, p in enumerate(packs):
        feats_b[i, : len(p)] = p
        nf[i] = len(p)
    outs = dec.decode_batch(feats_b, nf, return_nbest=5)
    if args.rescore_lm:
        # two-pass higher-order LM: bigram decode, n-best rescore
        from poccala_tpu_torch.lm.ngram import Ngram
        from poccala_tpu_torch.decoder.rescore import rescore_nbest

        rlm = Ngram(args.rescore_order, smoothing="wb")
        rlm.init_gram(args.rescore_lm)
        outs = rescore_nbest(outs, dec.lm, rlm, dec.lm_weight,
                             dec.word_penalty)
    for path, hyps in zip(args.wavs, outs):
        _print_nbest(path, hyps)


def cmd_cd_expand(args):
    _not_ported("cd-expand (context-dependent units)", "5")


def cmd_listen(args):
    """Online serving: capture a window from the microphone (or take a
    WAV via ``--wav``), run frontend + utterance-global VAD like the
    reference's serving loop (``Decoder.py:190-218``), then stream-decode
    the features chunk by chunk, printing a partial 1-best per chunk."""
    _check_unported(args)
    dev = _device(args)
    cfg = _load_config(args)
    inv = _load_inventory(cfg, args)
    dec = _device_decoder(args, cfg, inv, dev)

    path = args.wav
    if not path:
        import tempfile

        from poccala_tpu_torch.io import audio_device

        path = os.path.join(tempfile.gettempdir(), "poccala_listen.wav")
        print(f"recording {args.seconds:.1f}s ...", file=sys.stderr)
        audio_device.record(args.seconds, path,
                            rate=cfg.frontend.sample_rate)
    packed = _features_fn(cfg, dev)(path)

    chunk = max(int(args.chunk_frames), 1)
    st = dec.stream_init(batch=1, max_frames=len(packed))
    for lo in range(0, len(packed), chunk):
        st = dec.stream_feed(st, packed[lo: lo + chunk])
        partial = dec.stream_result(st)[0]
        print(json.dumps({
            "frames": st.t_offset,
            "partial": list(partial[0].words) if partial else [],
        }, ensure_ascii=False), flush=True)
    hyps = dec.stream_result(st, return_nbest=5)[0]
    print(json.dumps({
        "final": [{"words": list(h.words), "score": h.score}
                  for h in hyps],
    }, ensure_ascii=False))


def cmd_serve(args):
    """Batch serving: read WAV paths (one per line) from stdin or
    ``--list``, decode them through the double-buffered
    :class:`~poccala_tpu_torch.serve.DecodeService`, and print one JSON line
    per WAV in input order."""
    from poccala_tpu_torch.serve import DecodeService

    _check_unported(args)
    dev = _device(args)
    cfg = _load_config(args)
    inv = _load_inventory(cfg, args)
    dec = _device_decoder(args, cfg, inv, dev)
    features = _features_fn(cfg, dev)

    if args.list:
        with open(args.list) as f:
            paths = [line.strip() for line in f if line.strip()]
    else:
        paths = [line.strip() for line in sys.stdin if line.strip()]

    with DecodeService(dec, batch_size=args.batch_size,
                       frame_bucket=args.frame_bucket,
                       max_wait_s=args.max_wait_ms / 1e3,
                       return_nbest=args.nbest) as svc:
        # featurize one micro-batch of WAVs at a time, then submit them
        # back to back so batches fill, while the frontend of chunk k+1
        # still overlaps the device decode of chunk k
        futs = []
        for lo in range(0, len(paths), args.batch_size):
            chunk = paths[lo: lo + args.batch_size]
            feats = [features(p) for p in chunk]
            futs.extend(
                (p, svc.submit(f)) for p, f in zip(chunk, feats))
        for path, fut in futs:
            _print_nbest(path, fut.result(), flush=True)
    st = svc.stats
    print(json.dumps({
        "requests": st.requests, "batches": st.batches,
        "padded_slots": st.padded_slots, "frames": st.frames,
        "compiled_shapes": sorted(st.shapes),
        "latency": st.latency_summary(),
    }), file=sys.stderr)


def cmd_export_ref(args):
    from poccala_tpu_torch.train import checkpoint as ckpt

    cfg = _load_config(args)
    inv = _load_inventory(cfg, args)
    bank, _ = ckpt.load_checkpoint(args.checkpoint, device=_device(args))
    ckpt.export_reference_layout(args.out, bank, inv, cfg.model.unit_type)
    print(f"exported to {args.out}/{cfg.model.unit_type}", file=sys.stderr)


def cmd_import_ref(args):
    from poccala_tpu_torch.train import checkpoint as ckpt

    cfg = _load_config(args)
    inv = _load_inventory(cfg, args)
    bank = ckpt.import_reference_layout(
        args.src, inv, cfg.model.unit_type, cfg.model.state_num,
        cfg.model.max_mix_level, device=_device(args),
    )
    ckpt.save_checkpoint(args.checkpoint, bank, {"imported": args.src},
                         units=inv.units)
    print(f"imported into {args.checkpoint}", file=sys.stderr)


def cmd_synth_corpus(args):
    from poccala_tpu_torch.io.corpus import generate_synthetic_corpus

    cfg = _load_config(args)
    inv = _load_inventory(cfg, args)
    audio, label = generate_synthetic_corpus(
        args.out, inv, num_utts=args.num_utts, seed=cfg.train.seed)
    print(json.dumps({"audio_dir": audio, "label_dir": label}))


def cmd_build_lexicon(args):
    from poccala_tpu_torch.lexicon import PinYin, PronunciationLexicon

    pinyin = PinYin(args.mandarin_dat) if args.mandarin_dat else PinYin()
    with open(args.words) as f:
        words = [w.strip() for w in f if w.strip()]
    lex = PronunciationLexicon()
    lex.generate(words, pinyin)
    lex.save(args.out)
    print(f"lexicon: {lex.size} words -> {args.out}", file=sys.stderr)


def cmd_train_lm(args):
    from poccala_tpu_torch.lm.ngram import Ngram

    lm = Ngram(args.order, smoothing=args.smoothing)
    with open(args.text) as f:
        sentences = [line.split() for line in f if line.strip()]
    lm.train(sentences)
    lm.save(args.out)
    print(f"lm: {len(sentences)} sentences -> {args.out}", file=sys.stderr)


COMMANDS = {
    "train": cmd_train, "align": cmd_align, "decode": cmd_decode,
    "cd-expand": cmd_cd_expand, "listen": cmd_listen, "serve": cmd_serve,
    "export-ref": cmd_export_ref, "import-ref": cmd_import_ref,
    "synth-corpus": cmd_synth_corpus, "build-lexicon": cmd_build_lexicon,
    "train-lm": cmd_train_lm,
}


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flag set (``poccala_tpu/cli.py:build_parser``, copied;
    ``tests/test_torch_cli.py`` pins the two together) with the port's
    handlers, the global ``--device`` and ``decode``'s default tier set to
    ``device``."""
    p = argparse.ArgumentParser(prog="poccala-tpu-torch")
    p.add_argument("--device", default="cuda",
                   help="torch device of the bank, frontend and trainer "
                        "(default cuda; cpu runs the plain PyTorch "
                        "versions of the kernels)")
    p.add_argument("--config", help="INI config (reference layout)")
    p.add_argument("--set", action="append", metavar="KEY=VALUE",
                   help="config override (repeatable)")
    p.add_argument("--units", help="unit file path or inventory kind "
                                   "(IF/XIF/XIF_tone)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_dist_flags(sp):
        sp.add_argument("--distributed", action="store_true",
                        help="run over the (data, state) device mesh from "
                             "the config (--set mesh.data_axis=4 "
                             "mesh.state_axis=2)")
        sp.add_argument("--coordinator",
                        help="multi-host coordinator address "
                             "(host:port)")
        sp.add_argument("--num-processes", type=int)
        sp.add_argument("--process-id", type=int)

    t = sub.add_parser("train")
    t.add_argument("--mode", type=int, default=2, choices=(1, 2))
    t.add_argument("--epochs", type=int, default=1)
    t.add_argument("--init", action="store_true", default=True)
    t.add_argument("--no-init", dest="init", action="store_false")
    t.add_argument("--add-mix", action="store_true")
    t.add_argument("--checkpoint")
    t.add_argument("--resume", action="store_true")
    t.add_argument("--history")
    add_dist_flags(t)
    t.set_defaults(fn=cmd_train)

    a = sub.add_parser("align")
    a.add_argument("--checkpoint", required=True)
    a.set_defaults(fn=cmd_align)

    d = sub.add_parser("decode")
    d.add_argument("--checkpoint", required=True)
    d.add_argument("--lexicon", required=True)
    d.add_argument("--cd", help="CD sidecar from cd-expand: decode "
                                "with the context-dependent graph")
    d.add_argument("--lm")
    d.add_argument("--lm-order", type=int, default=2)
    d.add_argument("--rescore-lm",
                   help="rescore the n-best with this (higher-order) "
                        "LM after decoding")
    d.add_argument("--rescore-order", type=int, default=3)
    d.add_argument("--beam", type=float, default=0.85)
    d.add_argument("--decoder", choices=("vector", "device", "simple"),
                   default="device",
                   help="decoder tier: the on-device search (default); "
                        "the host tiers vector and simple are not "
                        "ported yet and raise")
    d.add_argument("wavs", nargs="+")
    add_dist_flags(d)
    d.set_defaults(fn=cmd_decode)

    cdx = sub.add_parser("cd-expand")
    cdx.add_argument("--checkpoint", required=True,
                     help="trained CI checkpoint to expand")
    cdx.add_argument("--vocab", required=True,
                     help="word list (one word per line)")
    cdx.add_argument("--table", help="Mandarin.dat-format G2P table "
                                     "(default: built-in subset)")
    cdx.add_argument("--out-checkpoint", required=True)
    cdx.add_argument("--out-cd", required=True,
                     help="CD sidecar (triples + routing trees)")
    cdx.add_argument("--target-senones", type=int, default=0,
                     help="tied-senone budget (0 = 3x the CI count)")
    cdx.add_argument("--retrain-epochs", type=int, default=3)
    cdx.add_argument("--word-line", type=int, default=0,
                     help=".trn line carrying the word sequence "
                          "(word boundaries reset context)")
    cdx.add_argument("--min-occ", type=float, default=16.0)
    cdx.add_argument("--map-tau", type=float, default=0.0,
                     help="MAP-smooth retrained leaves toward their CI "
                          "parents, prior strength in frames "
                          "(w = n/(n+tau)); 0 = off")
    cdx.set_defaults(fn=cmd_cd_expand)

    li = sub.add_parser("listen")
    li.add_argument("--checkpoint", required=True)
    li.add_argument("--lexicon", required=True)
    li.add_argument("--cd", help="CD sidecar: stream-decode with the "
                                 "context-dependent graph")
    li.add_argument("--lm")
    li.add_argument("--lm-order", type=int, default=2)
    li.add_argument("--beam", type=float, default=0.85)
    li.add_argument("--wav",
                    help="decode this WAV instead of recording (no "
                         "microphone needed)")
    li.add_argument("--seconds", type=float, default=5.0,
                    help="microphone capture window (Decoder.py:190)")
    li.add_argument("--chunk-frames", type=int, default=25,
                    help="stream-decode chunk size in frames")
    li.set_defaults(fn=cmd_listen)

    sv = sub.add_parser("serve")
    sv.add_argument("--checkpoint", required=True)
    sv.add_argument("--lexicon", required=True)
    sv.add_argument("--cd", help="CD sidecar: serve with the "
                                 "context-dependent graph")
    sv.add_argument("--lm")
    sv.add_argument("--lm-order", type=int, default=2)
    sv.add_argument("--beam", type=float, default=0.85)
    sv.add_argument("--list", help="file of WAV paths (default: stdin)")
    sv.add_argument("--batch-size", type=int, default=8)
    sv.add_argument("--frame-bucket", type=int, default=128)
    sv.add_argument("--nbest", type=int, default=1)
    sv.add_argument("--max-wait-ms", type=float, default=20.0,
                    help="batch-fill wait after the first request "
                         "(DecodeService max_wait_s)")
    add_dist_flags(sv)
    sv.set_defaults(fn=cmd_serve)

    e = sub.add_parser("export-ref")
    e.add_argument("--checkpoint", required=True)
    e.add_argument("--out", required=True)
    e.set_defaults(fn=cmd_export_ref)

    i = sub.add_parser("import-ref")
    i.add_argument("--src", required=True)
    i.add_argument("--checkpoint", required=True)
    i.set_defaults(fn=cmd_import_ref)

    s = sub.add_parser("synth-corpus")
    s.add_argument("--out", required=True)
    s.add_argument("--num-utts", type=int, default=32)
    s.set_defaults(fn=cmd_synth_corpus)

    b = sub.add_parser("build-lexicon")
    b.add_argument("--words", required=True)
    b.add_argument("--mandarin-dat")
    b.add_argument("--out", required=True)
    b.set_defaults(fn=cmd_build_lexicon)

    lm = sub.add_parser("train-lm")
    lm.add_argument("--text", required=True)
    lm.add_argument("--order", type=int, default=2)
    lm.add_argument("--smoothing", choices=("jm", "wb"), default="jm",
                    help="jm: fixed-weight interpolation; wb: Witten-"
                         "Bell (persists into the file; a WB bigram "
                         "attaches to the first-pass decoder via per-"
                         "row backoff tables)")
    lm.add_argument("--out", required=True)
    lm.set_defaults(fn=cmd_train_lm)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
