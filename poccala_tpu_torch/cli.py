"""Command-line driver of the PyTorch port (port of ``poccala_tpu/cli.py``).

    python -m poccala_tpu_torch.cli [--device cuda|cpu] [--config INI]
        [--set KEY=VALUE ...] [--units FILE|KIND] <command> ...

The subcommands, flags and JSON output lines are the JAX CLI's (the
port keeps its own copy of ``build_parser``, with its own handlers):

* ``train``      — ``Trainer.auto`` (schemes 1/2, mixture growth,
                   round-granular checkpoint/resume)
* ``align``      — Viterbi forced alignment over a corpus
* ``decode``     — WAV(s) → word hypotheses via one of three decoder
                   tiers: ``--decoder vector`` (the default: batched host
                   token passing), ``simple`` (the dict-based host
                   reference, one utterance at a time) or ``device`` (the
                   on-device search, exact or block-pruned: ``--set
                   decoder.active_blocks=K decoder.block_size=N``); the
                   GMM scores run on ``--device`` for every tier; with an
                   optional n-best rescore by a higher-order LM
* ``cd-expand``  — a trained context-independent checkpoint → tied-state
                   context-dependent units (triples, context trees, cloned
                   bank, retrain) as a checkpoint and a sidecar;
                   ``decode`` / ``listen`` / ``serve --cd SIDECAR`` then
                   search the context-dependent graph
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

``--distributed`` (``train``, ``decode``, ``serve``) runs over the
``(data, state)`` mesh of ``--set mesh.data_axis=… mesh.state_axis=…``:
one process per rank, joined by ``--coordinator HOST:PORT --num-processes
N --process-id I`` or by ``torchrun``'s environment, else a one-rank group
in the process (:mod:`poccala_tpu_torch.parallel.mesh`).  Every rank runs
the command on the same inputs; only rank 0 prints and writes the
checkpoint, the others wait at a barrier.  In ``serve`` rank 0 owns the
request loop and the other ranks follow it
(:func:`poccala_tpu_torch.parallel.decode.follow`).
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


def _maybe_mesh(cfg, args, dev):
    """The (data, state) mesh when ``--distributed`` asks for it, from
    ``--set mesh.data_axis/state_axis`` (the reference's operator story:
    run the tool, get multi-machine training, ``Controller.py:108-151``).
    ``--coordinator/--num-processes/--process-id`` join a multi-process
    group first (``ENV_ID`` machine identity, config.ini:26), as does
    ``torchrun``'s environment."""
    if not getattr(args, "distributed", False):
        return None
    import torch.distributed as dist

    from poccala_tpu_torch.parallel import mesh as pmesh

    if getattr(args, "coordinator", None) or (
            "WORLD_SIZE" in os.environ and not dist.is_initialized()):
        pmesh.init_multihost(coordinator=args.coordinator,
                             num_processes=args.num_processes,
                             process_id=args.process_id, device=dev)
        _say(f"joined process group: process {dist.get_rank()}/"
             f"{dist.get_world_size()}")
    mesh = pmesh.make_mesh(data_axis=cfg.mesh.data_axis,
                           state_axis=cfg.mesh.state_axis, device=dev)
    _say(f"mesh: {pmesh.mesh_shape(mesh)}")
    return mesh


def _lead() -> bool:
    """True on rank 0, and without a process group."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _say(msg: str) -> None:
    if _lead():
        print(msg, file=sys.stderr)


def _barrier(mesh) -> None:
    if mesh is not None:
        torch.distributed.barrier()


def _load_decode_graph(args, inv, bank):
    """Lexicon pickle -> FlatLexicon; with ``--cd`` the same pickle
    compiles into the context-dependent graph (arcs keyed on
    (left, unit, right)) with out-of-expansion triples registered via
    tree back-off.  Returns (flat, bank)."""
    from poccala_tpu_torch.lexicon import FlatLexicon, PronunciationLexicon

    lex = PronunciationLexicon()
    lex.load(args.lexicon)
    flat = FlatLexicon.from_tree(lex.lexicon, inv)
    if getattr(args, "cd", None):
        from poccala_tpu_torch.models import context as ctx_mod

        cd, trees = ctx_mod.load_cd(args.cd)
        if cd.base.units != inv.units:
            raise SystemExit(
                "--cd sidecar base inventory does not match --units")
        entries = ctx_mod.cd_entries_from_flat(flat)
        entries, skipped = ctx_mod.filter_routable_entries(cd, trees,
                                                           entries)
        if skipped:
            print(f"cd: {len(set(skipped))} lexicon words use base "
                  f"units absent from the expansion vocabulary — "
                  f"dropped (no tying tree to route them)",
                  file=sys.stderr)
        cd, trees, bank = ctx_mod.extend_for_lexicon(cd, trees, bank,
                                                     entries)
        flat = ctx_mod.build_cd_lexicon(entries, cd)
        print(f"cd decode graph: {flat.n_nodes} nodes / {len(cd)} "
              f"triples", file=sys.stderr)
    return flat, bank


def _load_lm(args):
    if not args.lm:
        return None
    from poccala_tpu_torch.lm.ngram import Ngram

    lm = Ngram(args.lm_order)
    lm.init_gram(args.lm)
    return lm


def _load_decoder(args, cfg, inv, dev, tier: str = "device"):
    """Checkpoint + lexicon + LM -> the decoder of ``tier`` (``device``,
    ``vector`` or ``simple``) with its bank on ``dev``, built as the JAX
    CLI builds it (``cmd_decode``): the block-pruning knobs of
    ``cfg.decoder`` and ``score_dtype`` go to the device tier only."""
    from poccala_tpu_torch.decoder import BeamDecoder, DeviceBeamDecoder
    from poccala_tpu_torch.decoder.vector import VectorBeamDecoder
    from poccala_tpu_torch.train import checkpoint as ckpt

    bank, _ = ckpt.load_checkpoint(args.checkpoint, device=dev)
    flat, bank = _load_decode_graph(args, inv, bank)
    kw = {}
    if tier == "device":
        kw.update(block_size=cfg.decoder.block_size,
                  active_blocks=cfg.decoder.active_blocks or None,
                  prune_hysteresis=cfg.decoder.prune_hysteresis,
                  score_dtype=cfg.model.score_dtype)
    cls = {"device": DeviceBeamDecoder, "vector": VectorBeamDecoder,
           "simple": BeamDecoder}[tier]
    return cls(bank, flat, beam=args.beam, lm=_load_lm(args),
               normalizer=cfg.model.gaussian_normalizer, **kw)


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

    dev = _device(args)
    cfg = _load_config(args)
    inv = _load_inventory(cfg, args)
    mesh = _maybe_mesh(cfg, args, dev)
    corpus = Corpus(cfg, inv, device=dev)
    _say(f"corpus: {len(corpus.pairs)} utterances, {len(inv)} units")
    batches = list(corpus.batches())
    tr = Trainer(cfg, inv, device=dev, mesh=mesh)

    start_round = 0
    if args.resume and args.checkpoint and os.path.isdir(args.checkpoint):
        bank, manifest = ckpt.load_checkpoint(args.checkpoint, device=dev)
        tr.use_bank(bank)
        tr.mix_level = manifest.get("mix_level", tr.mix_level)
        start_round = manifest.get("round", 0)
        _say(f"resumed at round {start_round}")

    init = args.init and start_round == 0
    for r in range(start_round, args.epochs):
        lls = tr.auto(batches, t=1, mode=args.mode, init=init,
                      add_mix=args.add_mix)
        init = False
        _say(f"round {r}: loglik={lls[0]:.2f}")
        if args.checkpoint:
            bank = tr.export_bank()   # every rank: gathers the state shards
            if _lead():
                ckpt.save_checkpoint(
                    args.checkpoint, bank,
                    {"round": r + 1, "mode": args.mode,
                     "mix_level": tr.mix_level},
                    units=inv.units,
                )
            _barrier(mesh)
    if args.history and _lead():
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
    if args.distributed and args.decoder != "device":
        # before any process group or mesh is made
        raise SystemExit("--distributed requires --decoder device")
    dev = _device(args)
    cfg = _load_config(args)
    inv = _load_inventory(cfg, args)
    dec = _load_decoder(args, cfg, inv, dev, args.decoder)
    mesh = _maybe_mesh(cfg, args, dev)
    features = _features_fn(cfg, dev)
    packs = [features(path) for path in args.wavs]
    if args.decoder == "simple":
        outs = [dec.decode(p) for p in packs]
    else:
        # one batched decode (sharded over the mesh's data axis when
        # --distributed: every rank decodes its rows, all return every
        # row)
        t_max = max(len(p) for p in packs)
        feats_b = np.zeros((len(packs), t_max, packs[0].shape[1]),
                           np.float32)
        nf = np.zeros(len(packs), np.int32)
        for i, p in enumerate(packs):
            feats_b[i, : len(p)] = p
            nf[i] = len(p)
        kwargs = {"mesh": mesh} if mesh is not None else {}
        outs = dec.decode_batch(feats_b, nf, return_nbest=5, **kwargs)
    if not _lead():
        _barrier(mesh)
        return
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
    _barrier(mesh)


def cmd_cd_expand(args):
    """Expand a trained CI checkpoint to context-dependent tied-state
    units: enumerate within-word triples over the vocabulary, collect
    alignment-driven context statistics, grow the phonetic-context
    decision trees, clone the CD bank from the CI senones, retrain, and
    write the CD checkpoint + routing sidecar.  Decode with
    ``decode --cd <sidecar>``."""
    import dataclasses

    from poccala_tpu_torch.io.corpus import Corpus, UnitInventory, read_label
    from poccala_tpu_torch.lexicon.pinyin import PinYin
    from poccala_tpu_torch.models import context as ctx
    from poccala_tpu_torch.train import alignment as align
    from poccala_tpu_torch.train import checkpoint as ckpt
    from poccala_tpu_torch.train.trainer import Trainer

    dev = _device(args)
    cfg = _load_config(args)
    inv = _load_inventory(cfg, args)
    bank, manifest = ckpt.load_checkpoint(args.checkpoint, device=dev)

    with open(args.vocab) as f:
        words = [w.strip() for w in f if w.strip()]
    py = PinYin(args.table) if args.table else PinYin()

    combos_of: dict[str, list[list[int]]] = {}
    seqs = []
    for w in words:
        combos = ctx.reading_combos(py, w, inv.id_of)
        if not combos:
            continue
        flat_combos = [[u for s in c for u in s] for c in combos]
        combos_of[w] = flat_combos
        seqs.extend(flat_combos)
    cf = [inv.id_of[u] for u in ("sil",) if u in inv.id_of]
    cd = ctx.CDInventory.from_words(seqs, inv, context_free=cf)
    print(f"cd: {len(cd)} triples over {len(inv)} base units, "
          f"{len(combos_of)} vocabulary words", file=sys.stderr)

    corpus = Corpus(cfg, inv, device=dev)
    emit = cfg.model.emit_states
    acc = ctx.TripleStatsAccumulator(len(cd), emit, cfg.frontend.feat_dim)
    cd_batches = []
    bs = cfg.train.batch_size
    buf, lines = [], []

    def flush():
        if not buf:
            return
        batch = Corpus._pack(buf, bs, cfg.train.max_frames,
                             cfg.train.max_label_len,
                             cfg.frontend.feat_dim)
        cd_labels, ok = ctx.expand_labels_by_matching(
            batch.labels, batch.label_lens, list(lines), combos_of, cd)
        _, lp = align.align_batch(
            bank, batch.labels, batch.label_lens, batch.feats,
            batch.t_masks, cfg.model.state_num, cfg.train.max_label_len,
            normalizer=cfg.model.gaussian_normalizer)
        lp = lp.cpu().numpy()
        ok &= align.check_alignment(lp, batch.labels, batch.label_lens)
        acc.add(batch.feats, cd_labels, lp, utt_ok=ok)
        if ok.any():
            keep = np.nonzero(ok)[0]
            cd_batches.append(dataclasses.replace(
                batch,
                feats=batch.feats[keep], t_masks=batch.t_masks[keep],
                labels=cd_labels[keep],
                label_lens=batch.label_lens[keep]))
        if not ok.all():
            print(f"cd-expand: {int((~ok).sum())} utterances "
                  f"unmatched/unaligned (discarded)", file=sys.stderr)
        buf.clear()
        lines.clear()

    for wav_path, label_path in corpus.pairs:
        try:
            # read the word line FIRST: if it is missing the utterance
            # must be skipped atomically (a partial append would shift
            # every later utterance's transcript in the batch)
            wl = read_label(label_path, args.word_line)
            utt = corpus.load_utterance(wav_path, label_path)
        except (KeyError, FileNotFoundError, IndexError):
            continue
        buf.append(utt)
        lines.append(wl)
        if len(buf) == bs:
            flush()
    flush()

    target = args.target_senones or 3 * bank.num_states
    trees = ctx.grow_context_trees(
        cd, acc.occ, acc.mean, acc.ex2, target_senones=target,
        min_occ=args.min_occ)
    cd_bank = ctx.build_cd_bank(bank, cd, trees)
    print(f"cd: tied to {trees.n_senones} senones (target {target}, "
          f"{len(trees.splits_log)} splits)", file=sys.stderr)

    tr = Trainer(cfg, UnitInventory(ctx.cd_unit_names(cd)), device=dev)
    tr.bank = cd_bank
    tr.mix_level = manifest.get("mix_level", tr.mix_level)
    # reinit=False: EM refit FROM the clones — preserves component
    # correspondence with the CI parents (map_smooth_bank premise)
    tr.scheme1_round(cd_batches, init=False, smem=False, reinit=False)
    if args.retrain_epochs > 1:
        tr.auto(cd_batches, t=args.retrain_epochs - 1, mode=2, init=False)
    if args.map_tau > 0:
        tr.bank = ctx.map_smooth_bank(
            tr.export_bank(), bank, cd, trees, acc.occ,
            tau=args.map_tau)
        print(f"cd: MAP-smoothed toward CI parents "
              f"(tau={args.map_tau:g} frames)", file=sys.stderr)
    ckpt.save_checkpoint(
        args.out_checkpoint, tr.export_bank(),
        {"mix_level": tr.mix_level, "cd": True,
         "cd_sidecar": os.path.abspath(args.out_cd)},
        units=ctx.cd_unit_names(cd))
    ctx.save_cd(args.out_cd, cd, trees)
    print(f"cd system -> {args.out_checkpoint} + {args.out_cd}",
          file=sys.stderr)


def cmd_listen(args):
    """Online serving: capture a window from the microphone (or take a
    WAV via ``--wav``), run frontend + utterance-global VAD like the
    reference's serving loop (``Decoder.py:190-218``), then stream-decode
    the features chunk by chunk, printing a partial 1-best per chunk."""
    dev = _device(args)
    cfg = _load_config(args)
    inv = _load_inventory(cfg, args)
    dec = _load_decoder(args, cfg, inv, dev)

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
    per WAV in input order.  With ``--distributed`` rank 0 serves through
    a :class:`~poccala_tpu_torch.parallel.decode.DecodeLeader` and the
    other ranks follow it."""
    dev = _device(args)
    cfg = _load_config(args)
    inv = _load_inventory(cfg, args)
    dec = _load_decoder(args, cfg, inv, dev)
    mesh = _maybe_mesh(cfg, args, dev)
    if mesh is not None:
        from poccala_tpu_torch.parallel import decode as pdecode

        if not _lead():
            # rank 0 owns the request loop; run each batch it announces
            pdecode.follow(dec, mesh)
            return
        dec = pdecode.DecodeLeader(dec, mesh)
        try:
            _serve(args, cfg, dev, dec, mesh)
        finally:
            dec.stop()
        return
    _serve(args, cfg, dev, dec, None)


def _serve(args, cfg, dev, dec, mesh):
    from poccala_tpu_torch.serve import DecodeService

    features = _features_fn(cfg, dev)

    if args.list:
        with open(args.list) as f:
            paths = [line.strip() for line in f if line.strip()]
    else:
        paths = [line.strip() for line in sys.stdin if line.strip()]

    with DecodeService(dec, batch_size=args.batch_size,
                       frame_bucket=args.frame_bucket,
                       max_wait_s=args.max_wait_ms / 1e3,
                       return_nbest=args.nbest, mesh=mesh) as svc:
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
    handlers and the global ``--device``."""
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
                   default="vector",
                   help="decoder tier: vectorized host (default), "
                        "on-device scan, or the simple reference path")
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
    started = torch.distributed.is_initialized()
    try:
        args.fn(args)
    finally:
        # a process group this command started ends with it
        if getattr(args, "distributed", False) and not started \
                and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
