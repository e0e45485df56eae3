"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the hand-written CUDA kernels from ``poccala_tpu_torch/csrc`` (the
GMM scorer in float32 and bfloat16 and the banded HMM forward / backward /
Viterbi), holds each against its plain PyTorch version, computes each one's
bound (bytes over the memory rate or operations over the peak rate), and
drives both halves of the port's main path at full model width with random
weights from a seeded ``torch.Generator``:

* decode serving (WAV -> MFCC -> VAD -> DecodeService ->
  DeviceBeamDecoder): the XIF_tone inventory (202 units, 606 senones),
  8 mixtures, 39-dim features, the built-in lexicon;
* training (bench.py's ``one_epoch``: MFCC -> embedded Baum-Welch E-step
  -> M-step -> Viterbi forced alignment) at the XIF inventory (62 units,
  186 senones), 8 mixtures, 39 dims, 256 x 4 s utterances, and
  ``Trainer.auto(mode=2)`` on a synthetic corpus, GPU against CPU, whose
  trained bank is checkpointed, reloaded and decoded;
* scheme-1 training: ``Trainer.auto(t=2, mode=1, add_mix=True)`` on the
  same 256 x 4 s batch at 7 -> 8 mixtures (uniform segmentation, k-means,
  EM, SMEM, then realignment and re-clustering, each round ending with
  the transmat epoch), timed phase by phase, and on the synthetic corpus
  on the GPU against the CPU;
* streaming decode at the decode width: eight live ``ServiceStream``
  sessions fed 25-frame chunks at the rate audio arrives, one lockstep
  session of eight streams, each held to the one-shot decode, and the GMM
  kernel against its plain version at a chunk's shapes;
* block-pruned decode over a synthetic 21.6k-node lexicon at the decode
  batch (256 x 4 s), exact against ``active_blocks`` 8 and 4;
* the command line (``python -m poccala_tpu_torch.cli --device cuda``):
  synth-corpus, train, align, decode, listen and serve on a small corpus,
  train, align and decode held against ``--device cpu``;
* recognition by a model trained on the card: 20 WAVs of separable
  units -> ``Trainer.auto(mode=2)`` -> ``DeviceBeamDecoder`` over
  ``export_bank()`` -> word error rate 0.0, the words equal to a
  ``device="cpu"`` run.

``--only PHASE --repeat N`` builds the kernels and runs one timed phase N
times in one process (no result line): host-bound figures vary between
machines and between minutes, so two checkouts are compared by
alternating such runs on one machine.

Each phase prints one line; any failure raises, so the script exits
non-zero and prints no result.  The last lines are the kernels' JSON
record, the card's name and power limit, and ``{"ok": true, "device": ...}``.

It needs a CUDA device (there is no CPU fallback) and imports neither jax
nor anything of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from poccala_tpu_torch.config import Config, ModelConfig
from poccala_tpu_torch.io import wav as wav_io
from poccala_tpu_torch.decoder.device import DeviceBeamDecoder
from poccala_tpu_torch.eval import evaluate_decoder
from poccala_tpu_torch.io import corpus as corpus_io
from poccala_tpu_torch.io.corpus import UnitInventory
from poccala_tpu_torch.lexicon import FlatLexicon, PinYin, PronunciationLexicon
from poccala_tpu_torch.lexicon.build import synthetic_lexicon
from poccala_tpu_torch.lexicon.builtin_table import BUILTIN_PINYIN
from poccala_tpu_torch.models import senone_bank as sb
from poccala_tpu_torch.models.topology import build_embedded_batch
from poccala_tpu_torch.ops import hmm as hmm_ops
from poccala_tpu_torch.ops import vad as vad_ops
from poccala_tpu_torch.ops.cuda import build
from poccala_tpu_torch.ops.cuda import gmm_score_cuda as gk
from poccala_tpu_torch.ops.cuda import hmm_banded_cuda as hk
from poccala_tpu_torch.ops.frontend import Frontend
from poccala_tpu_torch.ops.gmm_score import gmm_log_scores
from poccala_tpu_torch.serve import DecodeService
from poccala_tpu_torch.train import accumulators as acc
from poccala_tpu_torch.train import alignment as align
from poccala_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from poccala_tpu_torch.train.trainer import Trainer

S, M, D = 606, 8, 39          # XIF_tone senones, mixtures, feature dim
SLICE_T = 256 * 319           # bench_decode's 256 x 4 s batch, in frames
F32_TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_pallas_kernels.py:37
BF16_TOL = dict(rtol=1e-3, atol=5e-2)  # tests/test_bf16_scoring.py:115
DP_TOL = dict(rtol=1e-5, atol=1e-5)    # tests/test_gmm_hmm_kernels.py:102
# bench.py's training shape: XIF units, 5-state HMMs, 8 mixtures, 39 dims,
# 256 utterances of 4 s (319 frames), labels of 8-16 units
TRAIN_B, TRAIN_T, TRAIN_L, TRAIN_W = 256, 319, 16, 5
# scheme 1 (BASELINE config 2, bench.py:112-136): 7 mixtures growing to 8
S1_MIX, S1_MAX_MIX = 7, M
# GPU vs CPU scheme-1 logliks: float32 perturbations of 3e-7 move them by
# ~1e-5 relative through k-means, EM and SMEM; 1e-4 leaves 10x room
S1_E2E_RTOL = 1e-4
# GPU vs CPU logliks of the CLI's two scheme-2 rounds: they differed by
# 1.6e-6 relative on an H100; 1e-4 leaves 60x room
CLI_TRAIN_RTOL = 1e-4
KERNEL_NAMES = ("gmm_score", "hmm_banded")
CHUNK = 25                    # stream chunk in frames (ServiceStream default)
STREAMS = 8                   # live sessions, and the lockstep batch


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, ensure_ascii=False),
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def median_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def loop_ms(fn, n: int = 100) -> float:
    """Mean CUDA-event time of ``fn`` over ``n`` back-to-back calls after
    a warm-up: for calls too short for one event pair to resolve."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def pct(values, q) -> float:
    return float(np.percentile(np.asarray(values), q))


# ----------------------------------------------------------------------
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 disabled")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def kernel_name(mangled: str) -> str:
    """``forward_warp_kernel<2,5>`` from its Itanium-mangled name: the last
    ``<length><identifier>`` component and its integer template arguments."""
    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    pos, name = m.end(), mangled
    while (n := re.match(r"\d+", mangled[pos:])):
        start = pos + n.end()
        name, pos = mangled[start:start + int(n.group())], \
            start + int(n.group())
    args = re.match(r"I((?:Li\d+E)+)E", mangled[pos:])
    if args:
        name += "<" + ",".join(re.findall(r"Li(\d+)E", args.group(1))) + ">"
    return name


def ptxas_summary(log: str) -> dict:
    """``nvcc -Xptxas -v``'s output as {kernel: [registers, spill-store
    bytes, spill-load bytes]}."""
    out, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = [int(m.group(1)), *spills]
            name = None
    return out


def phase_build() -> None:
    """Every kernel source compiled at once, one nvcc each.  The banded
    DP's warp kernels must not spill in the instantiations in use."""
    def one(name):
        t0 = time.perf_counter()
        built = build.build(name)
        return name, built, time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNEL_NAMES)) as pool:
        results = list(pool.map(one, KERNEL_NAMES))
    for name, built, secs in results:
        ptxas = ptxas_summary(built.log)
        say("build", kernel=name, seconds=round(secs, 3),
            compiled=built.compiled, library=str(built.path.name),
            ptxas_registers_spill_stores_loads=ptxas)
        if name == "hmm_banded" and built.compiled:
            warp = {k: v for k, v in ptxas.items() if "warp_kernel" in k}
            check(len(warp) == 40, f"40 warp instantiations ({len(warp)})")
            # ptxas trades a few bytes of spill for a register step in some
            # instantiations; none in those of the training shape (K = 2)
            # and of the default config's sentence width (K = 4), W = 5
            used = {k: v for k, v in warp.items()
                    if k.endswith(("<2,5>", "<4,5>"))}
            check(len(used) == 4 and all(v[1:] == [0, 0]
                                         for v in used.values()),
                  f"no spills in the warp kernels in use: {used}")
            say("build_spills", warp_kernels_with_spills={
                k: v for k, v in warp.items() if v[1:] != [0, 0]})


def scoring_inputs(t: int, gen: torch.Generator, floor: bool = False):
    """MFCC-scale inputs (a c0-style offset plus per-senone structure, as
    in tests/test_bf16_scoring.py).

    ``floor``: the last 4 dims are degenerate, as a collapsed dimension
    is in training: half the mixtures sit at the 1e-6 covariance floor
    there (1/σ² = 1e6), and frames and means carry values at the floor's
    scale.  (With |x| of order 1 or more on a floored dim, x²p is 1e6 or
    more, one f32 ulp of it is a fraction of a nat to hundreds of nats,
    and no two f32 summation orders agree to 1e-4 — the absolute floor
    is ill-conditioned in any precision, poccala_tpu/config.py:138-148.
    TF32 still fails this case, on the healthy dims.)"""
    offset = torch.zeros(D)
    offset[0] = 60.0
    centers = torch.randn(S, 1, D, generator=gen) * 3
    means = offset + centers + torch.randn(S, M, D, generator=gen)
    log_var = torch.rand(S, M, D, generator=gen) * 2.0 + 0.5
    which = torch.randint(0, S, (t,), generator=gen)
    x = offset + centers[which, 0] + torch.randn(t, D, generator=gen) * 2
    if floor:
        deg = slice(D - 4, D)
        hit = torch.rand(S, M, 1, generator=gen) < 0.5
        log_var[..., deg] = torch.where(
            hit, torch.log(torch.tensor(1e-6)), log_var[..., deg])
        means[..., deg] = torch.randn(S, M, 4, generator=gen) * 1e-3
        x[:, deg] = torch.randn(t, 4, generator=gen) * 1e-3
    log_w = torch.log_softmax(torch.randn(S, M, generator=gen), dim=-1)
    return [a.cuda() for a in (x, means, log_var, log_w)]


# NVIDIA's data-sheet peaks of one H100 SXM (dense), for the bounds
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def bound_ms(n_bytes: float, flops: float, op_type: str) -> dict:
    """The least time the card could take: every input read once and every
    output written once at the memory rate, or the operations at the peak
    rate of their type, whichever is larger."""
    by_bytes = n_bytes / PEAK_BYTES_S * 1e3
    by_ops = flops / PEAK_FLOPS[op_type] * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def gmm_bound(t: int, s: int, m: int, d: int, dtype: str) -> dict:
    """x, means, log_var, log_w in and [T, S] out, all float32 in device
    memory; 2·T·2D·S·M operations of the [x², x] product."""
    n_bytes = 4 * (t * d + 2 * s * m * d + s * m + t * s)
    return bound_ms(n_bytes, 2 * t * 2 * d * s * m, dtype)


def scoring_case(gen, t, s, m, d, dead_slot=False):
    """Small-scale random inputs at an arbitrary shape, for the ragged
    cases; ``dead_slot`` gives the last mixture slot the weight -1e30 of a
    padded slot."""
    means = torch.randn(s, m, d, generator=gen) * 2
    log_var = torch.rand(s, m, d, generator=gen) * 2.0 - 0.5
    x = torch.randn(t, d, generator=gen) * 2
    log_w = torch.log_softmax(torch.randn(s, m, generator=gen), dim=-1)
    if dead_slot:
        log_w[:, -1] = -1e30
    return [a.cuda() for a in (x, means, log_var, log_w)]


def compare_gmm(args, dtype, norm="textbook") -> tuple[float, bool, dict]:
    kw = dict(normalizer=norm, score_dtype=dtype)
    got = gk.gmm_log_scores_cuda(*args, **kw)
    want = gmm_log_scores(*args, **kw)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and got.shape == want.shape \
        and bool(torch.allclose(got, want, **tol))
    return err, ok, tol


def clocks_under_load(fn, launches: int = 300) -> str:
    """``clocks.sm, power.draw`` as nvidia-smi reads them while ``launches``
    calls of ``fn`` are queued on the card (the published peaks assume the
    full boost clock)."""
    for _ in range(launches):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    torch.cuda.synchronize()
    return out


def phase_kernel(seed: int) -> dict:
    """Both GMM kernels against the plain version at T = 1000 and the
    slice's T (both normalizers, the floor-variance case), then at ragged
    shapes; times, the bound and the product's library time at the slice's
    T.  Returns the two kernels' records."""
    gen = torch.Generator().manual_seed(seed)
    records = {}
    cases = [("float32", "textbook", False), ("float32", "reference", False),
             ("float32", "textbook", True), ("bfloat16", "textbook", False),
             ("bfloat16", "reference", False)]
    for t in (1000, SLICE_T):
        for dtype, norm, floor in cases:
            args = scoring_inputs(t, gen, floor)
            err, ok, tol = compare_gmm(args, dtype, norm)
            kw = dict(normalizer=norm, score_dtype=dtype)
            line = dict(t=t, s=S, m=M, d=D, score_dtype=dtype,
                        normalizer=norm, floor_variances=floor,
                        max_abs_err=err, tol=tol, ok=ok)
            if t == SLICE_T and not floor and norm == "textbook":
                line["ms"] = median_ms(lambda: gk.gmm_log_scores_cuda(
                    *args, **kw))
                line["plain_ms"] = median_ms(lambda: gmm_log_scores(
                    *args, **kw))
                # the one library call nearest to the kernel: the product
                # alone, [T, 2D] x [2D, S·M], without packing, bias or
                # logsumexp; the port never calls it
                op = torch.float32 if dtype == "float32" else torch.bfloat16
                xa = torch.randn(t, 2 * D, device="cuda").to(op)
                w = torch.randn(2 * D, S * M, device="cuda").to(op)
                line["library_ms"] = median_ms(lambda: torch.matmul(xa, w))
                line["library_call"] = "torch.matmul, the product alone"
                del xa, w
                line.update(gmm_bound(t, S, M, D, dtype))
                line["clocks_under_load"] = clocks_under_load(
                    lambda: gk.gmm_log_scores_cuda(*args, **kw))
                records[dtype] = {k: line[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}
            say("kernel_vs_plain", **line)
            check(ok, f"kernel vs plain at {line}")
            del args
    # ragged shapes: T and S off the tiles, one mixture, a padded slot,
    # other feature widths (run-time K), S odd / even / a multiple of 4
    ragged = [dict(t=1, s=1, m=1, d=39), dict(t=130, s=65, m=1, d=39),
              dict(t=333, s=607, m=3, d=39, dead_slot=True),
              dict(t=200, s=606, m=8, d=13), dict(t=5000, s=100, m=2, d=7),
              dict(t=40000, s=130, m=4, d=40), dict(t=77, s=64, m=5, d=26)]
    for shape in ragged:
        for dtype in ("float32", "bfloat16"):
            err, ok, tol = compare_gmm(scoring_case(gen, **shape), dtype)
            say("kernel_vs_plain_ragged", **shape, score_dtype=dtype,
                max_abs_err=err, tol=tol, ok=ok)
            check(ok, f"kernel vs plain at ragged {shape} {dtype}")
    torch.cuda.empty_cache()
    return records


def phase_known_answer(seed: int) -> None:
    """The separable bank and lexicon of tests/test_streaming_decode.py:
    frames drawn around the units' means must decode to their words."""
    rng = np.random.default_rng(seed)
    d = 8
    units = ["n", "i3", "h", "ao3", "m", "a1"]
    inv = UnitInventory(units)
    cfg = ModelConfig(state_num=5, mix_level=1, max_mix_level=1)
    emb = rng.normal(size=(len(units), d)).astype(np.float32) * 4
    arrays = sb.bank_to_numpy(
        sb.create_bank(len(units), cfg, d, differentiation=False))
    arrays["means"] = np.repeat(emb, cfg.state_num - 2, axis=0)[:, None, :]
    bank = sb.bank_from_numpy(arrays, device="cuda")
    lex = PronunciationLexicon()
    lex.generate(["你好", "你", "马"],
                 PinYin({"你": ["ni3"], "好": ["hao3"], "马": ["ma1"]}))
    dec = DeviceBeamDecoder(bank, FlatLexicon.from_tree(lex.lexicon, inv))

    def utt(ids):
        return np.concatenate([emb[u] + rng.normal(size=(12, d)) * 0.3
                               for u in ids]).astype(np.float32)

    before = gk.gmm_log_scores_cuda.launches
    for ids, want in (([0, 1, 2, 3], "你好"), ([4, 5], "马")):
        x = utt(ids)
        hyps = dec.decode_batch(x[None], np.array([len(x)]))[0]
        got = "".join(hyps[0].words) if hyps else None
        say("known_answer", want=want, got=got)
        check(got == want, f"known-answer decode {got!r} != {want!r}")
    check(gk.gmm_log_scores_cuda.launches > before, "known answer used the kernel")


def full_width_decoder(seed: int, device) -> tuple[DeviceBeamDecoder, Config]:
    cfg = Config()
    cfg.model.mix_level = cfg.model.max_mix_level = M
    inv = UnitInventory.standard("XIF_tone")
    bank = sb.create_bank(len(inv), cfg.model, cfg.frontend.feat_dim,
                          generator=torch.Generator().manual_seed(seed),
                          device=device)
    lex = PronunciationLexicon()
    lex.generate(list(BUILTIN_PINYIN), PinYin())
    flat = FlatLexicon.from_tree(lex.lexicon, inv)
    return DeviceBeamDecoder(bank, flat), cfg


def synthetic_speech(rng, rate: int, seconds: float) -> np.ndarray:
    """A quiet lead-in (the VAD's noise window) followed by voiced bursts
    of harmonics at varying pitch, separated by short pauses."""
    n_lead = int(0.3 * rate)
    out = [rng.normal(size=n_lead) * 30.0]
    total = n_lead
    while total < seconds * rate:
        n = int(rng.uniform(0.15, 0.35) * rate)
        t = np.arange(n) / rate
        f0 = rng.uniform(100, 250)
        burst = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6)) / h
                    for h in range(1, 8)) * 3000.0 * np.hanning(n)
        gap = rng.normal(size=int(0.05 * rate)) * 30.0
        out += [burst + rng.normal(size=n) * 30.0, gap]
        total += n + len(gap)
    return np.concatenate(out)[: int(seconds * rate)]


def phase_serve(seed: int, n_req: int = 16) -> tuple[int, DeviceBeamDecoder]:
    """cli.py:cmd_serve's composition: WAV -> frontend -> VAD -> packed
    features -> DecodeService(batch 8) -> the port's decoder on the GPU.
    Returns the kernel launches of this run."""
    rng = np.random.default_rng(seed)
    dec, cfg = full_width_decoder(seed, "cuda")
    fe = Frontend(cfg.frontend, device="cuda")
    rate = cfg.frontend.sample_rate
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i in range(n_req):
            p = os.path.join(tmp, f"req{i:02d}.wav")
            wav_io.write_wav(p, synthetic_speech(
                rng, rate, rng.uniform(1.0, 2.5)), rate)
            paths.append(p)

        def features(path):
            data, _ = wav_io.load_wav(path)
            sig = wav_io.preprocess_signal(
                data, drop_zeros=cfg.frontend.reference_quirks)
            feats, mask = fe.mfcc(sig)
            keep = vad_ops.vad_mask(feats, mask) if cfg.frontend.vad else mask
            packed, n = vad_ops.apply_mask(feats, keep)
            return packed[: int(n)]

        gk.gmm_log_scores_cuda.launches = 0
        with DecodeService(dec, batch_size=8) as svc:
            feats, futs = [], []
            for lo in range(0, n_req, 8):
                chunk = [features(p) for p in paths[lo: lo + 8]]
                feats += chunk
                futs += [svc.submit(f) for f in chunk]
            results = [f.result(timeout=600) for f in futs]
        launches = gk.gmm_log_scores_cuda.launches
    stats = svc.stats
    for i, hyps in enumerate(results):
        check(len(hyps) >= 1 and np.isfinite(hyps[0].score),
              f"request {i} answered with a finite 1-best")
    check(launches > 0, "the served decodes launched the CUDA kernel")
    say("serve", requests=stats.requests, batches=stats.batches,
        frames=stats.frames, kept_frames=[len(f) for f in feats],
        kernel_launches=launches,
        one_best=["".join(r[0].words) for r in results],
        latency=stats.latency_summary())

    # the same four requests through the port on the CPU (plain scoring)
    cpu_dec, _ = full_width_decoder(seed, "cpu")
    compared = 0
    for i in range(4):
        cpu = cpu_dec.decode_batch(feats[i][None], np.array([len(feats[i])]),
                                   return_nbest=2)[0]
        gpu = results[i][0]
        check(np.isclose(gpu.score, cpu[0].score, rtol=1e-4, atol=0.0),
              f"request {i}: GPU score {gpu.score} vs CPU {cpu[0].score}")
        margin = cpu[0].score - cpu[1].score if len(cpu) > 1 else np.inf
        if margin > 0.01:
            check(gpu.words == cpu[0].words,
                  f"request {i}: GPU words {gpu.words} vs CPU {cpu[0].words}")
            compared += 1
        say("serve_vs_cpu", request=i, gpu_score=gpu.score,
            cpu_score=cpu[0].score, margin=margin,
            words_equal=gpu.words == cpu[0].words)
    say("serve_vs_cpu_summary", compared_words=compared, compared_scores=4)
    return launches, dec


def device_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall time, summed
    kernel time, the device's busy share of the wall time, the kernel
    count and the costliest kernels.  The device numbers read "not
    measured" when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if kernel_ms <= 0:
        return dict(wall_ms=wall_ms, busy_share="not measured")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(wall_ms=wall_ms, kernel_ms=kernel_ms,
                busy_share=kernel_ms / wall_ms,
                kernels=sum(e.count for e in kernels),
                top=[(e.key[:60], e.count, e.self_device_time_total / 1e3)
                     for e in top])


def phase_throughput(seed: int, dec: DeviceBeamDecoder, smi: str,
                     batch: int = 256, utt_seconds: float = 4.0,
                     calls: int = 3) -> int:
    """bench.py:bench_decode's shape: frontend + scoring + frame loop +
    n-best per call, double-buffered dispatch/collect, host work inside
    the timed region.  Then one call of the same batch through a decoder
    with ``score_dtype="bfloat16"``; returns the bfloat16 kernel's launches
    in it."""
    cfg = Config()
    fe = Frontend(cfg.frontend, device="cuda")
    rate = cfg.frontend.sample_rate
    n_samples = int(utt_seconds * rate)
    rng = np.random.default_rng(seed)
    signals = torch.as_tensor(
        (rng.normal(size=(batch, n_samples)) * 2000).astype(np.float32),
        device="cuda")
    n_samp = torch.full((batch,), n_samples, dtype=torch.int64,
                        device="cuda")

    def features():
        feats, masks = fe.mfcc_batch(signals, n_samp)
        return feats, masks.sum(dim=1).cpu().numpy()

    t0 = time.perf_counter()
    feats, n_frames = features()
    hyps = dec.decode_batch(feats, n_frames)
    warm_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = None
    for _ in range(calls):
        feats, n_frames = features()
        handle = dec.decode_dispatch(feats, n_frames)
        if pending is not None:
            hyps = dec.decode_collect(pending)
        pending = handle
    hyps = dec.decode_collect(pending)
    elapsed = time.perf_counter() - t0
    check(all(len(h) >= 1 for h in hyps), "every utterance decoded")

    busy = device_profile(
        lambda: dec.decode_collect(dec.decode_dispatch(feats, n_frames)))

    # where one call's device time goes (CUDA events, separate run)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    feats, masks = fe.mfcc_batch(signals, n_samp)
    ev[1].record()
    dec._scores(feats)
    ev[2].record()
    dec.decode_collect(dec.decode_dispatch(feats, n_frames))
    ev[3].record()
    torch.cuda.synchronize()

    # the same batch with bfloat16 scoring (cfg.model.score_dtype)
    dec16 = DeviceBeamDecoder(dec.bank, dec.lexicon, score_dtype="bfloat16")
    dec16.decode_batch(feats, n_frames)                       # warm-up
    gk.gmm_log_scores_cuda.launches_bf16 = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hyps16 = dec16.decode_batch(feats, n_frames)
    bf16_ms = (time.perf_counter() - t0) * 1e3
    bf16_launches = gk.gmm_log_scores_cuda.launches_bf16
    check(all(len(h) >= 1 and np.isfinite(h[0].score) for h in hyps16),
          "every utterance decoded with bfloat16 scoring")
    check(bf16_launches == 1, "one bfloat16 kernel launch per decode call")
    drift = max(abs(a[0].score - b[0].score) / abs(b[0].score)
                for a, b in zip(hyps16, hyps))

    audio_s = batch * utt_seconds * calls
    say("throughput", metric="decode_audio_throughput",
        value=audio_s / elapsed, unit="audio-s/s", batch=batch,
        utt_seconds=utt_seconds, calls=calls, frames=int(feats.shape[1]),
        lexicon_nodes=int(dec.lexicon.n_nodes), seconds=elapsed,
        warmup_seconds=warm_s,
        breakdown_ms=dict(frontend=ev[0].elapsed_time(ev[1]),
                          scoring=ev[1].elapsed_time(ev[2]),
                          decode_call_with_scoring=ev[2].elapsed_time(ev[3])),
        decode_call_profile=busy,
        bf16_call=dict(wall_ms=bf16_ms, kernel_launches=bf16_launches,
                       max_rel_score_drift_vs_f32=drift),
        device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    return bf16_launches


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------

def train_config() -> Config:
    cfg = Config()
    cfg.model.state_num = 5
    cfg.model.mix_level = cfg.model.max_mix_level = M
    return cfg


def dp_inputs(gen: torch.Generator, b: int, t: int, max_l: int):
    """Sentence HMMs of random labels (8..max_l units, one batch-padding
    utterance), log_b from scoring random frames against a random XIF
    bank, ragged frame masks (one full, one single-frame) — the DP
    kernels' operands as the training path builds them."""
    cfg = train_config()
    inv = UnitInventory.standard("XIF")
    bank = sb.create_bank(len(inv), cfg.model, D, generator=gen,
                          device="cuda")
    labels = torch.randint(0, len(inv), (b, max_l), generator=gen)
    lens = torch.randint(min(8, max_l), max_l + 1, (b,), generator=gen)
    lens[1] = 0
    n_true = torch.randint(1, t + 1, (b,), generator=gen)
    n_true[0], n_true[-1] = t, 1
    masks = (torch.arange(t)[None] < n_true[:, None]).cuda()
    feats = (torch.randn(b, t, D, generator=gen) * 2).cuda()
    ehmm = build_embedded_batch(bank, labels.cuda(), lens.cuda(), 5, max_l)
    _, _, log_b = acc.sentence_scores(bank, ehmm, feats)
    return ehmm.band, ehmm.log_pi, log_b, masks


def hmm_bound(name: str, b: int, t: int, n: int, w: int) -> dict:
    """band [B, N, W], log_b [B, T, N] (float32) and the uint8 frame mask
    in, plus log_pi [B, N] for forward and Viterbi; out: forward alpha
    [B, T, N] and loglik [B], backward beta [B, T, N], Viterbi score [B],
    path [B, T] int32 and delta [B, N].  About 4·W float32 operations per
    (b, t, n) for the log-sum recursions, 2·W for the max."""
    n_in = 4 * (b * n * w + b * t * n) + b * t
    if name == "backward":
        n_out, ops = 4 * b * t * n, 4 * w
    else:
        n_in += 4 * b * n
        n_out, ops = ((4 * (b * t * n + b), 4 * w) if name == "forward"
                      else (4 * (b + b * t + b * n), 2 * w))
    return bound_ms(n_in + n_out, b * t * n * ops, "float32")


def kernel_device_ms(fn, name: str, reps: int = 20):
    """Mean device time of the ``name`` DP kernel (``forward_*``,
    ``backward_*`` or ``viterbi_*`` in ``hmm_banded.cu``) over the launches
    that ``torch.profiler`` records in ``reps`` calls of ``fn``: the kernel
    alone, no launch gaps, no host time; "not measured" when the profiler
    records none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and f"{name}_" in e.key and "kernel" in e.key]
    launches = sum(e.count for e in events)
    total_us = sum(e.self_device_time_total for e in events)
    return total_us / 1e3 / launches if launches else "not measured"


def compare_dp(name: str, got, want) -> tuple[float, bool, dict]:
    """A DP kernel's outputs against the plain version's: forward and
    backward at DP_TOL, Viterbi's paths equal and scores at rtol 1e-6."""
    if name == "viterbi":
        tol = dict(rtol=1e-6, atol=0.0, paths="equal")
        ok = (torch.equal(got[1], want[1])
              and torch.allclose(got[0], want[0], rtol=1e-6, atol=0)
              and torch.allclose(got[2], want[2], rtol=1e-6, atol=0))
        return float((got[0] - want[0]).abs().max()), ok, tol
    pairs = list(zip(got, want)) if name == "forward" else [(got, want)]
    err = max(float((g - w).abs().max()) for g, w in pairs)
    return err, all(torch.allclose(g, w, **DP_TOL) for g, w in pairs), DP_TOL


def phase_hmm_kernels(seed: int) -> dict:
    """Each DP kernel against its plain version at a small ragged shape, a
    shape with four registers a lane (N = 98, the default config's sentence
    width) and bench.py's training shape.  Forward and backward are also
    held bit for bit against the block kernels, which were the only kernels
    before the warp kernels came and still take the shapes these do not.
    Times at the last two shapes: ``ms`` one event pair around a wrapper
    call, ``device_ms`` the kernel alone under the profiler, ``ms_b1`` /
    ``device_ms_b1`` the same for the first utterance alone (the length of
    the dependent chain), ``parent_ms`` / ``parent_device_ms`` the block
    kernel on the same inputs."""
    gen = torch.Generator().manual_seed(seed)
    record = {}
    w = TRAIN_W
    for b, t, max_l in ((6, 23, 4), (64, TRAIN_T, 32),
                        (TRAIN_B, TRAIN_T, TRAIN_L)):
        band, log_pi, log_b, masks = dp_inputs(gen, b, t, max_l)
        n = int(band.shape[1])

        def calls(lo, hi, **kw):
            """name -> (kernel call, plain call) on utterances lo..hi."""
            bd, pi, lb, mk = (a[lo:hi] for a in (band, log_pi, log_b, masks))
            return {
                "forward": (
                    lambda: hk.forward_banded_cuda(bd, pi, lb, mk, w, **kw),
                    lambda: hmm_ops.forward_log_banded_plain(bd, pi, lb, mk,
                                                             w)),
                "backward": (
                    lambda: hk.backward_banded_cuda(bd, lb, mk, w, **kw),
                    lambda: hmm_ops.backward_log_banded_plain(bd, lb, mk, w)),
                "viterbi": (
                    lambda: hk.viterbi_banded_cuda(bd, pi, lb, mk, w),
                    lambda: hmm_ops.viterbi_log_banded_plain(bd, pi, lb, mk,
                                                             w)),
            }

        timed = t == TRAIN_T
        block = calls(0, b, block=True)
        first = calls(0, 1)
        for name, (kernel, plain) in calls(0, b).items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err, ok, tol = compare_dp(name, got, want)
            line = dict(kernel=name, b=b, t=t, n_s=n, w=w,
                        warp_kernel=name != "viterbi" and hk.takes_warp(n, w),
                        max_abs_err=err, tol=tol, ok=bool(ok))
            if name != "viterbi":
                old = block[name][0]()
                torch.cuda.synchronize()
                if name == "forward":
                    line["alpha_equals_block_kernel"] = torch.equal(got[0],
                                                                    old[0])
                    line["loglik_max_rel_diff_vs_block_kernel"] = float(
                        ((got[1] - old[1]).abs() / old[1].abs()).max())
                    check(torch.allclose(got[1], old[1], **DP_TOL),
                          "warp forward loglik vs the block kernel's")
                else:
                    line["beta_equals_block_kernel"] = torch.equal(got, old)
                err1, ok1, _ = compare_dp(name, first[name][0](),
                                          first[name][1]())
                check(ok1, f"hmm {name} kernel vs plain at B = 1 ({err1})")
            if timed:
                line["ms"] = median_ms(kernel, reps=21)
                line["device_ms"] = kernel_device_ms(kernel, name)
                line["ms_b1"] = median_ms(first[name][0], reps=21)
                line["device_ms_b1"] = kernel_device_ms(first[name][0],
                                                        name)
                if name != "viterbi":
                    line["parent_ms"] = median_ms(block[name][0], reps=21)
                    line["parent_device_ms"] = kernel_device_ms(
                        block[name][0], name)
                line["plain_ms"] = median_ms(plain, reps=3)
                line.update(hmm_bound(name, b, t, n, w))
            if b == TRAIN_B:
                record[name] = dict(
                    max_abs_err=err, ms=line["ms"], plain_ms=line["plain_ms"],
                    bound_ms=line["bound_ms"], bound_by=line["bound_by"],
                    library_ms=None)
            say("hmm_kernel_vs_plain", **line)
            check(ok, f"hmm kernel vs plain at {line}")
            check(line.get("alpha_equals_block_kernel", True)
                  and line.get("beta_equals_block_kernel", True),
                  f"warp and block kernels bit-equal at {line}")
    torch.cuda.empty_cache()
    return record


def train_batch(seed: int, cfg: Config, n_units: int):
    """bench.py's synthetic training batch on the card: 256 utterances of
    4 s Gaussian noise (σ = 2000) with random labels of 8-16 units."""
    n_samples = int(4.0 * cfg.frontend.sample_rate)
    rng = np.random.default_rng(seed)
    signals = torch.as_tensor(
        (rng.normal(size=(TRAIN_B, n_samples)) * 2000).astype(np.float32),
        device="cuda")
    n_samp = torch.full((TRAIN_B,), n_samples, dtype=torch.int64,
                        device="cuda")
    labels = torch.as_tensor(rng.integers(0, n_units, size=(
        TRAIN_B, TRAIN_L)).astype(np.int32), device="cuda")
    lens = torch.as_tensor(rng.integers(TRAIN_L // 2, TRAIN_L + 1, size=(
        TRAIN_B,)).astype(np.int32), device="cuda")
    return signals, n_samp, labels, lens


def phase_train_throughput(seed: int, smi: str, epochs: int = 8) -> dict:
    """bench.py:143-154's one_epoch on the port: MFCC -> batch_stats ->
    apply_update -> align_batch at 256 x 4 s, one warm-up epoch, then
    ``epochs`` timed epochs synchronised by one probe scalar.  Returns the
    DP kernels' launches in the timed run."""
    cfg = train_config()
    inv = UnitInventory.standard("XIF")
    signals, n_samp, labels, lens = train_batch(seed, cfg, len(inv))
    fe = Frontend(cfg.frontend, device="cuda")
    bank0 = sb.create_bank(len(inv), cfg.model, cfg.frontend.feat_dim,
                           generator=torch.Generator().manual_seed(seed),
                           device="cuda")

    def one_epoch(bank, mark=None):
        mark = mark or (lambda _: None)
        feats, masks = fe.mfcc_batch(signals, n_samp)
        mark("frontend")
        stats, _ = acc.batch_stats(bank, labels, lens, feats, masks, 5,
                                   TRAIN_L, mark=mark)
        new_bank = acc.apply_update(bank, stats)
        mark("m_step")
        scores, label_pos = align.align_batch(new_bank, labels, lens, feats,
                                              masks, 5, TRAIN_L)
        mark("alignment")
        probe = stats.loglik + scores.sum() + label_pos.sum()
        return new_bank, probe

    t0 = time.perf_counter()
    float(one_epoch(bank0)[1])
    warm_s = time.perf_counter() - t0

    for kernel in hk.KERNELS.values():
        kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank, total = bank0, 0.0
    for _ in range(epochs):
        bank, probe = one_epoch(bank)
        total = total + probe
    total = float(total)  # synchronises every epoch's work
    elapsed = time.perf_counter() - t0
    launches = {k: f.launches for k, f in hk.KERNELS.items()}
    check(np.isfinite(total), f"finite probe ({total})")
    for k, n in launches.items():
        check(n >= epochs, f"the training path launched the {k} kernel "
              f"({n} times in {epochs} epochs)")

    # where one epoch's device time goes (CUDA events, separate run)
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    mark("start")
    one_epoch(bank0, mark)
    torch.cuda.synchronize()
    breakdown = {name: marks[i - 1][1].elapsed_time(ev)
                 for i, (name, ev) in enumerate(marks) if i}
    busy = device_profile(lambda: one_epoch(bank0))

    audio_s = TRAIN_B * 4.0 * epochs
    say("train_throughput",
        metric="train_em_plus_viterbi_audio_throughput",
        value=audio_s / elapsed, unit="audio-s/s", batch=TRAIN_B,
        utt_seconds=4.0, epochs=epochs, frames=TRAIN_T, units=len(inv),
        senones=int(bank0.num_states), mixtures=M, dim=D,
        max_label_len=TRAIN_L, seconds=elapsed, warmup_seconds=warm_s,
        probe=total, dp_kernel_launches=launches, breakdown_ms=breakdown,
        epoch_profile=busy, device=torch.cuda.get_device_name(0),
        nvidia_smi=smi)
    return launches


def xif_lexicon(inv: UnitInventory) -> FlatLexicon:
    """The built-in words with toneless readings, so their syllables spell
    XIF units."""
    table = {c: sorted({r.rstrip("012345") for r in rs})
             for c, rs in BUILTIN_PINYIN.items()}
    lex = PronunciationLexicon()
    lex.generate(list(table), PinYin(table))
    return FlatLexicon.from_tree(lex.lexicon, inv)


def e2e_corpus(tmp: str, seed: int, inv: UnitInventory):
    """The synthetic corpus of the end-to-end phases: 64 utterances of
    2-5 of the first 12 XIF units (each of their senones sees ~150
    frames), CMVN-normalised features, batches of 32.  Both keep float32
    EM well conditioned, so the GPU and the CPU can agree.
    :returns: (cfg, batches, load seconds)"""
    audio, label = corpus_io.generate_synthetic_corpus(
        tmp, UnitInventory(inv.units[:12]), num_utts=64,
        units_per_utt=(2, 5), unit_seconds=0.25, seed=seed)
    cfg = train_config()
    cfg.paths.audio_file_path, cfg.paths.label_file_path = audio, label
    cfg.frontend.vad = False
    cfg.frontend.cmvn = cfg.frontend.cmvn_var = True
    cfg.train.batch_size, cfg.train.max_frames = 32, 160
    cfg.train.max_label_len, cfg.train.proportion = 5, 1.0
    cfg.train.step = 2
    t0 = time.perf_counter()
    batches = list(corpus_io.Corpus(cfg, inv).batches())
    return cfg, batches, time.perf_counter() - t0


def phase_train_e2e(seed: int) -> None:
    """Trainer.auto(mode=2, t=3) at full width (XIF, 8 mixtures, 39 dims)
    on :func:`e2e_corpus`, on the GPU and on the CPU from the same
    flat-started bank; the GPU's bank is checkpointed, reloaded and
    decodes an utterance."""
    inv = UnitInventory.standard("XIF")
    with tempfile.TemporaryDirectory() as tmp:
        cfg, batches, load_s = e2e_corpus(tmp, seed, inv)

        gpu = Trainer(cfg, inv, generator=torch.Generator().manual_seed(seed),
                      device="cuda")
        gpu.flat_start(batches)
        cpu = Trainer(cfg, inv, device="cpu")
        cpu.bank = sb.bank_from_numpy(sb.bank_to_numpy(gpu.bank),
                                      device="cpu")
        before = hk.forward_banded_cuda.launches
        t0 = time.perf_counter()
        g_ll = gpu.auto(batches, t=3, mode=2, init=False)
        gpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        c_ll = cpu.auto(batches, t=3, mode=2, init=False)
        cpu_s = time.perf_counter() - t0
        rel = float(np.max(np.abs(np.array(g_ll) / np.array(c_ll) - 1)))
        check(hk.forward_banded_cuda.launches > before,
              "GPU training ran the DP kernels")
        check(all(np.isfinite(g_ll)) and g_ll[1] > g_ll[0]
              and g_ll[2] >= g_ll[1] - 1e-2, f"GPU logliks rise: {g_ll}")
        # three EM epochs of float32 sums in another order (cuBLAS,
        # atomics) compound through the updates
        check(rel < 1e-3, f"GPU vs CPU logliks {g_ll} vs {c_ll}")

        path = os.path.join(tmp, "ckpt")
        save_checkpoint(path, gpu.bank, manifest={"mode": 2, "round": 3},
                        units=inv.units)
        bank, man = load_checkpoint(path, device="cuda")
        check(all(torch.equal(getattr(bank, f), getattr(gpu.bank, f))
                  for f in sb.FIELDS), "checkpoint round trip")
        flat = xif_lexicon(inv)
        b = batches[0]
        n = int(b.t_masks[0].sum())
        hyps = DeviceBeamDecoder(bank, flat).decode_batch(b.feats[:1, :n],
                                                          [n])[0]
        check(len(hyps) >= 1 and np.isfinite(hyps[0].score),
              "the trained bank decodes to a finite 1-best")
    say("train_e2e", utterances=sum(int(x.label_lens.size) for x in batches),
        batches=len(batches), gpu_logliks=g_ll, cpu_logliks=c_ll,
        max_rel_diff=rel, tol_rel=1e-3, gpu_seconds=gpu_s, cpu_seconds=cpu_s,
        corpus_load_seconds=load_s, lexicon_nodes=int(flat.n_nodes),
        decoded_words=list(hyps[0].words), decoded_score=hyps[0].score)


def scheme1_config() -> Config:
    """BASELINE config 2 for scheme 1: 7 mixtures, growing to 8."""
    cfg = train_config()
    cfg.model.mix_level = S1_MIX
    cfg.train.max_label_len = TRAIN_L
    return cfg


def phase_train_scheme1(seed: int, smi: str) -> None:
    """Trainer.auto(t=2, mode=1, add_mix=True) at full width on
    train_throughput's 256 x 4 s batch: round 1 = uniform segmentation,
    k-means, EM and batched SMEM at 7 mixtures; round 2 = Viterbi
    realignment, k-means re-clustering for growth and EM at 8; both end
    with the transmat epoch.  Every phase is timed on the host clock after
    a CUDA synchronise (the trainer's ``mark`` hook), the DP kernels'
    launches are counted per round, and the bank must stay on the GPU."""
    cfg = scheme1_config()
    inv = UnitInventory.standard("XIF")
    signals, n_samp, labels, lens = train_batch(seed, cfg, len(inv))
    feats, masks = Frontend(cfg.frontend, device="cuda").mfcc_batch(signals,
                                                                   n_samp)
    batches = [corpus_io.Batch(feats.cpu().numpy(), masks.cpu().numpy(),
                               labels.cpu().numpy(), lens.cpu().numpy())]
    del signals, feats
    marks = []
    tr = None

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter(),
                       {k: f.launches for k, f in hk.KERNELS.items()}))
        check(all(getattr(tr.bank, f).is_cuda for f in sb.FIELDS),
              f"the bank stayed on the GPU through {name}")

    tr = Trainer(cfg, inv, generator=torch.Generator().manual_seed(seed),
                 device="cuda", mark=mark)
    for kernel in hk.KERNELS.values():
        kernel.launches = 0
    torch.cuda.synchronize()
    marks.append(("start", time.perf_counter(),
                  {k: 0 for k in hk.KERNELS}))
    lls = tr.auto(batches, t=2, mode=1, add_mix=True)

    rounds, lo = [], 0
    for h in tr.history:
        hi = next(i for i in range(lo + 1, len(marks))
                  if marks[i][0] == "transmat")
        split = {marks[i][0]: marks[i][1] - marks[i - 1][1]
                 for i in range(lo + 1, hi + 1)}
        launches = {k: marks[hi][2][k] - marks[lo][2][k] for k in hk.KERNELS}
        rounds.append(dict(
            round=h["round"], mix_level=h["mix_level"], loglik=h["loglik"],
            seconds=marks[hi][1] - marks[lo][1], split_seconds=split,
            em_iters_max=h["em_iters"],
            smem_accepted=h.get("smem_accepted"), cap=h["cap"],
            frames_dropped=h["dropped"], dp_kernel_launches=launches))
        lo = hi
    check(all(np.isfinite(lls)), f"finite scheme-1 logliks {lls}")
    check(rounds[1]["dp_kernel_launches"]["viterbi"] > 0,
          "round 2's realignment launched the Viterbi kernel")
    for r in rounds:
        check(r["dp_kernel_launches"]["forward"] > 0
              and r["dp_kernel_launches"]["backward"] > 0,
              f"round {r['round']}'s transmat epoch launched the "
              "forward/backward kernels")

    # a third (realignment) round under the profiler, without the marks'
    # synchronisations
    tr.mark = lambda _: None
    profile = device_profile(lambda: tr.scheme1_round(batches, init=False))
    check(all(getattr(tr.bank, f).is_cuda for f in sb.FIELDS),
          "the bank stayed on the GPU")
    say("train_scheme1", units=len(inv), senones=int(tr.bank.num_states),
        mixtures=[S1_MIX, S1_MAX_MIX], dim=D, batch=TRAIN_B, utt_seconds=4.0,
        frames=int(masks.shape[1]), max_label_len=TRAIN_L, logliks=lls,
        rounds=rounds, round3_profile=profile,
        device=torch.cuda.get_device_name(0), nvidia_smi=smi)


def phase_scheme1_e2e(seed: int) -> None:
    """Trainer.auto(t=2, mode=1, add_mix=True) on :func:`e2e_corpus`
    (7 mixtures growing to 8) on the GPU and on the CPU from the same
    generator seed: the round logliks agree within S1_E2E_RTOL, the SMEM
    acceptance counts are equal, and the realignment round's loglik is
    above the first round's."""
    inv = UnitInventory.standard("XIF")
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg, batches, _ = e2e_corpus(tmp, seed, inv)
        cfg.model.mix_level = S1_MIX
        for dev in ("cuda", "cpu"):
            tr = Trainer(cfg, inv, generator=torch.Generator().manual_seed(
                seed), device=dev)
            t0 = time.perf_counter()
            lls = tr.auto(batches, t=2, mode=1, add_mix=True)
            runs[dev] = dict(
                logliks=lls, seconds=time.perf_counter() - t0,
                smem_accepted=[h.get("smem_accepted") for h in tr.history],
                em_iters_max=[h["em_iters"] for h in tr.history])
    g, c = runs["cuda"], runs["cpu"]
    rel = float(np.max(np.abs(np.array(g["logliks"])
                              / np.array(c["logliks"]) - 1)))
    check(all(np.isfinite(g["logliks"])) and g["logliks"][1] > g["logliks"][0],
          f"GPU scheme-1 logliks rise: {g['logliks']}")
    check(g["smem_accepted"] == c["smem_accepted"],
          f"SMEM moves GPU {g['smem_accepted']} vs CPU {c['smem_accepted']}")
    check(rel < S1_E2E_RTOL, f"GPU vs CPU logliks {g} vs {c}")
    say("scheme1_e2e", utterances=sum(int(x.label_lens.size)
                                      for x in batches),
        gpu=g, cpu=c, max_rel_diff=rel, tol_rel=S1_E2E_RTOL)


# ----------------------------------------------------------------------
# streaming, block-pruned search, command line
# ----------------------------------------------------------------------

def speech_features(seed: int, cfg: Config, n: int, seconds: float):
    """``n`` utterances of :func:`synthetic_speech` through the frontend
    and VAD on the card (cmd_listen's composition): packed ``[T, D]``
    host arrays."""
    rng = np.random.default_rng(seed)
    fe = Frontend(cfg.frontend, device="cuda")
    rate = cfg.frontend.sample_rate
    out = []
    for _ in range(n):
        feats, mask = fe.mfcc(synthetic_speech(rng, rate, seconds))
        keep = vad_ops.vad_mask(feats, mask) if cfg.frontend.vad else mask
        packed, kept = vad_ops.apply_mask(feats, keep)
        out.append(packed[: int(kept)])
    return out


def same_nbest(got, want, what: str) -> None:
    check(bool(got) and [h.words for h in got] == [h.words for h in want],
          f"{what}: words {[h.words for h in got]} vs "
          f"{[h.words for h in want]}")
    check(np.allclose([h.score for h in got], [h.score for h in want],
                      rtol=1e-4, atol=0.0),
          f"{what}: scores {[h.score for h in got]} vs "
          f"{[h.score for h in want]}")


def phase_stream(seed: int, smi: str) -> None:
    """Streaming decode at the decode width (XIF_tone, 606 senones, 8
    mixtures, 39 dims, built-in lexicon): eight ``ServiceStream`` sessions
    of one 4 s utterance each, fed 25-frame chunks at the rate the audio
    arrives, then one lockstep session of all eight; every final n-best
    against the one-shot decode on the card.  Then the chunk advance alone
    (host clock after a synchronise), its device profile, and the GMM
    kernel against its plain version at one chunk (T = 25) and a lockstep
    chunk (T = 200)."""
    phase_t0 = time.perf_counter()
    dec, cfg = full_width_decoder(seed, "cuda")
    feats = speech_features(seed, cfg, STREAMS, 4.0)
    chunk_s = CHUNK * cfg.frontend.frame_step / cfg.frontend.sample_rate
    cap = [-(-len(f) // CHUNK) * CHUNK for f in feats]
    n_min = min(len(f) for f in feats)
    lock = np.stack([f[:n_min] for f in feats])

    gk.gmm_log_scores_cuda.launches = 0
    done_at = {}
    with DecodeService(dec, batch_size=8) as svc:
        sessions = [svc.open_stream(chunk_frames=CHUNK, max_frames=c)
                    for c in cap]
        futs, last_feed = {}, {}
        t0 = time.monotonic()
        for k in range(max(cap) // CHUNK):
            time.sleep(max(0.0, t0 + k * chunk_s - time.monotonic()))
            for i, s in enumerate(sessions):
                part = feats[i][k * CHUNK:(k + 1) * CHUNK]
                if len(part):
                    s.feed(part)
                if i not in futs and (k + 1) * CHUNK >= len(feats[i]):
                    last_feed[i] = time.monotonic()
                    futs[i] = s.result(return_nbest=2)
                    futs[i].add_done_callback(
                        lambda _, i=i: done_at.setdefault(
                            i, time.monotonic()))
        finals = [futs[i].result(timeout=600) for i in range(STREAMS)]
        live_chunks = svc.stats.stream_chunks
        lockstep = svc.open_stream(chunk_frames=CHUNK,
                                   max_frames=-(-n_min // CHUNK) * CHUNK,
                                   batch=STREAMS)
        for lo in range(0, n_min, CHUNK):
            lockstep.feed(lock[:, lo:lo + CHUNK])
        lock_finals = lockstep.result(return_nbest=2).result(timeout=600)
        stats = svc.stats
    launches = gk.gmm_log_scores_cuda.launches
    latency = [done_at[i] - last_feed[i] for i in range(STREAMS)]
    check(launches > 0, "the stream path launched the GMM kernel")

    for i, f in enumerate(feats):
        same_nbest(finals[i], dec.decode_batch(f[None], [len(f)], 2)[0],
                   f"stream {i} vs one-shot")
    for i, want in enumerate(dec.decode_batch(lock, [n_min] * STREAMS, 2)):
        same_nbest(lock_finals[i], want, f"lockstep stream {i} vs one-shot")

    def advance_ms(x, n_chunks):
        """Host ms per chunk advance of one session, after a synchronise."""
        st = dec.stream_init(batch=x.shape[0], max_frames=n_chunks * CHUNK)
        times = []
        for k in range(n_chunks):
            torch.cuda.synchronize()
            t = time.perf_counter()
            dec.stream_feed(st, x[:, k * CHUNK:(k + 1) * CHUNK])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return times, st

    one = feats[0][None, : len(feats[0]) // CHUNK * CHUNK]
    one_ms, _ = advance_ms(one, one.shape[1] // CHUNK)
    lock_ms, st = advance_ms(lock[:, : n_min // CHUNK * CHUNK], n_min // CHUNK)
    st1 = dec.stream_init(batch=1, max_frames=CHUNK)
    chunk_profile = device_profile(lambda: dec.stream_feed(st1, one[:, :CHUNK]))
    result_ms = median_ms(lambda: dec.stream_result(st))

    gen = torch.Generator().manual_seed(seed)
    for t in (CHUNK, STREAMS * CHUNK):
        x, means, log_var, log_w = scoring_inputs(t, gen)
        got = gk.gmm_log_scores_cuda(x, means, log_var, log_w)
        want = gmm_log_scores(x, means, log_var, log_w)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all())
              and bool(torch.allclose(got, want, **F32_TOL)),
              f"kernel vs plain at T = {t}: max abs err {err}")
        err16, ok16, _ = compare_gmm([x, means, log_var, log_w], "bfloat16")
        check(ok16, f"bf16 kernel vs plain at T = {t}: max abs err {err16}")

        def cold():
            gk._packs.clear()   # what every call cost before the pack cache
            gk.gmm_log_scores_cuda(x, means, log_var, log_w)

        say("kernel_vs_plain", t=t, s=S, m=M, d=D, score_dtype="float32",
            normalizer="textbook", max_abs_err=err, tol=F32_TOL, ok=True,
            ms=loop_ms(lambda: gk.gmm_log_scores_cuda(x, means, log_var,
                                                      log_w)),
            uncached_pack_ms=loop_ms(cold),
            bf16_ms=loop_ms(lambda: gk.gmm_log_scores_cuda(
                x, means, log_var, log_w, score_dtype="bfloat16")),
            bf16_max_abs_err=err16,
            plain_ms=loop_ms(lambda: gmm_log_scores(x, means, log_var,
                                                    log_w)),
            **gmm_bound(t, S, M, D, "float32"))
    say("stream", sessions=STREAMS, chunk_frames=CHUNK,
        chunk_audio_seconds=chunk_s, utt_seconds=4.0,
        kept_frames=[len(f) for f in feats], lexicon_nodes=int(
            dec.lexicon.n_nodes),
        live_chunks=live_chunks, all_chunks=stats.stream_chunks,
        lockstep_frames=n_min,
        kernel_launches=launches,
        gmm_launches_per_chunk=launches / stats.stream_chunks,
        chunk_advance_ms=dict(p50=pct(one_ms, 50), p90=pct(one_ms, 90)),
        lockstep_chunk_advance_ms=dict(p50=pct(lock_ms, 50),
                                       p90=pct(lock_ms, 90)),
        real_time_factor=pct(one_ms, 50) / 1e3 / chunk_s,
        lockstep_real_time_factor=pct(lock_ms, 50) / 1e3 / chunk_s / STREAMS,
        final_result_latency_ms=dict(p50=pct(latency, 50) * 1e3,
                                     p90=pct(latency, 90) * 1e3),
        stream_result_ms=result_ms, chunk_profile=chunk_profile,
        one_best=["".join(f[0].words) for f in finals],
        phase_seconds=time.perf_counter() - phase_t0,
        device=torch.cuda.get_device_name(0), nvidia_smi=smi)


def phase_pruned(seed: int, smi: str, batch: int = 256,
                 utt_seconds: float = 4.0) -> None:
    """Block-pruned search at the decode batch (bench.py's 256 x 4 s of
    noise through the frontend) over the synthetic ~21.6k-node lexicon
    standing in for Mandarin.dat: exact, then block_size 256 with 8 and 4
    active blocks, each timed after a warm-up call and a synchronise, with
    its peak device memory; then one pruned stream session against the
    one-shot pruned decode."""
    phase_t0 = time.perf_counter()
    cfg = Config()
    cfg.model.mix_level = cfg.model.max_mix_level = M
    inv = UnitInventory.standard("XIF_tone")
    flat, words, _ = synthetic_lexicon(inv)
    lex_s = time.perf_counter() - phase_t0
    bank = sb.create_bank(len(inv), cfg.model, cfg.frontend.feat_dim,
                          generator=torch.Generator().manual_seed(seed),
                          device="cuda")
    rng = np.random.default_rng(seed)
    n_samples = int(utt_seconds * cfg.frontend.sample_rate)
    signals = torch.as_tensor(
        (rng.normal(size=(batch, n_samples)) * 2000).astype(np.float32),
        device="cuda")
    feats, masks = Frontend(cfg.frontend, device="cuda").mfcc_batch(
        signals, torch.full((batch,), n_samples, device="cuda"))
    n_frames = masks.sum(dim=1).cpu().numpy()
    del signals

    runs, outs = {}, {}
    for name, kw in (("exact", {}),
                     ("k8", dict(block_size=256, active_blocks=8)),
                     ("k4", dict(block_size=256, active_blocks=4))):
        dec = DeviceBeamDecoder(bank, flat, **kw)
        t0 = time.perf_counter()
        dec._prep_device()
        prep_s = time.perf_counter() - t0
        check(dec._prune_on == bool(kw), f"{name}: pruning engaged as set")
        dec.decode_batch(feats, n_frames)                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gk.gmm_log_scores_cuda.launches = 0
        t0 = time.perf_counter()
        outs[name] = dec.decode_batch(feats, n_frames)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        check(gk.gmm_log_scores_cuda.launches == 1,
              f"{name}: one GMM kernel launch per decode call")
        check(all(len(h) >= 1 for h in outs[name]),
              f"{name}: every utterance decoded")
        runs[name] = dict(wall_ms=wall_ms, table_prep_seconds=prep_s,
                          peak_mem_bytes=torch.cuda.max_memory_allocated(),
                          blocks=getattr(dec, "_n_blocks", None))
        del dec
    for name in ("k8", "k4"):
        agree, worst = 0, 0.0
        for he, hp in zip(outs["exact"], outs[name]):
            agree += he[0].words == hp[0].words
            worst = max(worst, (hp[0].score - he[0].score) / abs(he[0].score))
        check(worst <= 1e-4, f"{name}: a pruned 1-best beat the exact one by "
              f"{worst} relative")
        runs[name].update(one_best_agreement=agree / batch,
                          max_rel_excess_over_exact=worst)

    # a pruned stream session of one utterance equals the pruned one-shot
    dec = DeviceBeamDecoder(bank, flat, block_size=256, active_blocks=8)
    x = feats[0, : int(n_frames[0])]
    st = dec.stream_init(batch=1, max_frames=len(x))
    for lo in range(0, len(x), CHUNK):
        dec.stream_feed(st, x[lo:lo + CHUNK])
    same_nbest(dec.stream_result(st, 2)[0], dec.decode_batch(
        x[None], [len(x)], 2)[0], "pruned stream vs pruned one-shot")
    say("pruned", lexicon_nodes=int(flat.n_nodes), words=len(words),
        lexicon_build_seconds=lex_s, batch=batch, utt_seconds=utt_seconds,
        frames=int(feats.shape[1]), block_size=256, runs=runs,
        stream_equals_one_shot=True, phase_seconds=time.perf_counter()
        - phase_t0, device=torch.cuda.get_device_name(0), nvidia_smi=smi)


def phase_cli(seed: int) -> None:
    """``python -m poccala_tpu_torch.cli``, in process, on a 12-utterance
    synthetic corpus (6 units, 18 senones, 1 of 2 mixtures): with
    ``--device cuda`` synth-corpus, train (scheme 2, two rounds, CMVN),
    align, decode --decoder device, listen --wav and serve over three
    WAVs, where listen's and serve's 1-best must equal decode's.  Then
    train, align and decode again with ``--device cpu``, the kernels'
    plain versions: the CPU's logliks from its own flat start within
    CLI_TRAIN_RTOL of the GPU's and, on the GPU's checkpoint, align's
    frames equal and decode's n-best equal at 1e-4 relative.  Last the
    GMM kernel against its plain version on the trained bank at the
    decode's frames."""
    import contextlib
    import io

    from poccala_tpu_torch import cli

    def run(device, *argv) -> list[dict]:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["--device", device, *argv])
        return [json.loads(line) for line in buf.getvalue().splitlines()]

    gk.gmm_log_scores_cuda.launches = 0
    for kernel in hk.KERNELS.values():
        kernel.launches = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        units = os.path.join(tmp, "units")
        with open(units, "w") as f:
            f.write("units\nn,i3,h,ao3,m,a1\n")
        words = os.path.join(tmp, "words.txt")
        with open(words, "w") as f:
            f.write("你好\n你\n马\n")
        dirs = run("cuda", "--units", units, "--set", f"train.seed={seed}",
                   "synth-corpus", "--out", tmp, "--num-utts", "12")[0]
        common = ["--units", units,
                  "--set", f"paths.audio_file_path={dirs['audio_dir']}",
                  "--set", f"paths.label_file_path={dirs['label_dir']}",
                  "--set", "train.load_line=0", "--set", "frontend.vad=false",
                  "--set", "frontend.cmvn=true", "--set", "model.mix_level=1",
                  "--set", "model.max_mix_level=2",
                  "--set", "train.max_frames=256",
                  "--set", "train.batch_size=6", "--set", "train.step=4",
                  "--set", "train.proportion=1.0"]
        lex = os.path.join(tmp, "lex.pkl")
        run("cuda", *common, "build-lexicon", "--words", words, "--out", lex)
        wavs = [os.path.join(dirs["audio_dir"], f"utt{i:05d}.wav")
                for i in range(3)]
        ckpt, logliks, aligned, decoded = {}, {}, {}, {}
        for dev in ("cuda", "cpu"):
            ckpt[dev] = os.path.join(tmp, f"ckpt_{dev}")
            hist = os.path.join(tmp, f"hist_{dev}.json")
            run(dev, *common, "train", "--mode", "2", "--epochs", "2",
                "--checkpoint", ckpt[dev], "--history", hist)
            with open(hist) as f:
                logliks[dev] = [h["loglik"] for h in json.load(f)]
            # both devices align and decode with the GPU's bank
            aligned[dev] = run(dev, *common, "align", "--checkpoint",
                               ckpt["cuda"])
            decoded[dev] = run(dev, *common, "decode", "--decoder", "device",
                               "--checkpoint", ckpt["cuda"], "--lexicon",
                               lex, *wavs)
            if dev == "cuda":
                model = ["--checkpoint", ckpt["cuda"], "--lexicon", lex]
                listened = run("cuda", *common, "listen", *model, "--wav",
                               wavs[0], "--chunk-frames", str(CHUNK))
                wav_list = os.path.join(tmp, "wavs.txt")
                with open(wav_list, "w") as f:
                    f.write("\n".join(wavs) + "\n")
                served = run("cuda", *common, "serve", *model, "--list",
                             wav_list, "--batch-size", "2",
                             "--frame-bucket", "32")
                dp = {k: f.launches for k, f in hk.KERNELS.items()}
                gmm = gk.gmm_log_scores_cuda.launches

        # the GMM kernel at the CLI's S, M, D on the trained bank
        cfg = Config()
        cfg.frontend.vad, cfg.frontend.cmvn = False, True
        fe = Frontend(cfg.frontend, device="cuda")
        x = []
        for w in wavs:
            feats, mask = fe.mfcc(wav_io.preprocess_signal(
                wav_io.load_wav(w)[0]))
            x.append(feats[: int(mask.sum())])
        x = torch.cat(x)
        bank, _ = load_checkpoint(ckpt["cuda"], device="cuda")
    launches = gk.gmm_log_scores_cuda.launches
    got = gk.gmm_log_scores_cuda(x, bank.means, bank.log_var, bank.log_w)
    want = gmm_log_scores(x, bank.means, bank.log_var, bank.log_w)
    gk.gmm_log_scores_cuda.launches = launches
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all())
          and bool(torch.allclose(got, want, **F32_TOL)),
          f"kernel vs plain on the CLI's bank: max abs err {err}")

    g_ll, c_ll = logliks["cuda"], logliks["cpu"]
    rel = float(np.max(np.abs(np.array(g_ll) / np.array(c_ll) - 1)))
    check(all(np.isfinite(g_ll)) and g_ll[1] > g_ll[0],
          f"CLI training logliks rise: {g_ll}")
    check(rel < CLI_TRAIN_RTOL, f"CLI GPU vs CPU logliks {g_ll} vs {c_ll}")
    check(len(aligned["cuda"]) == len(aligned["cpu"]) == 12
          and all(np.isfinite(a["score"]) for a in aligned["cuda"]),
          "align answered every utterance with a finite score")
    for i, (g, c) in enumerate(zip(aligned["cuda"], aligned["cpu"])):
        check(g["frames"] == c["frames"], f"align {i}: GPU frames vs CPU")
        check(np.isclose(g["score"], c["score"], rtol=1e-4, atol=0.0),
              f"align {i}: GPU score {g['score']} vs CPU {c['score']}")
    check(all(d["nbest"] for d in decoded["cuda"]), "decode answered every WAV")
    for g, c in zip(decoded["cuda"], decoded["cpu"]):
        got, want = g["nbest"], c["nbest"]
        check([h["words"] for h in got] == [h["words"] for h in want],
              f"decode {g['wav']}: GPU n-best {got} vs CPU {want}")
        check(np.allclose([h["score"] for h in got],
                          [h["score"] for h in want], rtol=1e-4, atol=0.0),
              f"decode {g['wav']}: GPU scores {got} vs CPU {want}")
    final = listened[-1]["final"]
    dec0 = decoded["cuda"][0]["nbest"]
    check(bool(final) and final[0]["words"] == dec0[0]["words"],
          f"listen's final {final[:1]} vs decode's {dec0[:1]}")
    check([s["wav"] for s in served] == wavs, "serve kept the input order")
    for s, d in zip(served, decoded["cuda"]):
        check(s["nbest"][0]["words"] == d["nbest"][0]["words"],
              f"serve's 1-best {s['nbest'][0]} vs decode's {d['nbest'][0]}")
    check(gmm > 0 and dp["forward"] > 0 and dp["backward"] > 0
          and dp["viterbi"] > 0, f"the CLI launched the kernels: gmm {gmm}, "
          f"dp {dp}")
    say("cli", commands=["synth-corpus", "build-lexicon", "train", "align",
                         "decode", "listen", "serve"],
        senones=int(bank.num_states), mixtures=int(bank.means.shape[1]),
        gpu_logliks=g_ll, cpu_logliks=c_ll, max_rel_diff=rel,
        tol_rel=CLI_TRAIN_RTOL, align_frames_equal=True,
        decode_equal_rtol=1e-4, kernel_frames=int(x.shape[0]),
        kernel_max_abs_err=err, kernel_tol=F32_TOL,
        one_best=[d["nbest"][0]["words"] for d in decoded["cuda"]],
        listen_partials=len(listened) - 1, gmm_launches=gmm,
        dp_kernel_launches=dp, phase_seconds=time.perf_counter() - t0)


WER_TABLE = {"你": ["ni3"], "好": ["hao3"], "马": ["ma1"]}
WER_WORDS = {"你好": ["ni3", "hao3"], "你": ["ni3"], "马": ["ma1"]}
WER_UNITS = ["n", "i3", "h", "ao3", "m", "a1"]


def phase_wer_e2e(seed: int) -> None:
    """Recognition by a model trained through the DP kernels: the corpus
    of tests/test_full_loop_wer.py (20 WAVs of one or two of three words,
    each unit a separable two-harmonic signature) -> Corpus ->
    ``Trainer.auto(t=4, mode=2, init=True)`` -> ``DeviceBeamDecoder`` over
    ``export_bank()`` -> ``evaluate_decoder``, on the card and on the CPU:
    WER 0.0 on the card, the same words from both."""
    t0 = time.perf_counter()
    inv = UnitInventory(WER_UNITS)
    pinyin = PinYin(WER_TABLE)
    rng = np.random.default_rng(seed + 11)
    names = list(WER_WORDS)
    with tempfile.TemporaryDirectory() as tmp:
        audio, label = os.path.join(tmp, "record"), os.path.join(tmp, "label")
        os.makedirs(audio)
        os.makedirs(label)
        refs = []
        for i in range(20):
            words = [names[k] for k in rng.integers(
                0, 3, size=rng.integers(1, 3))]
            syllables = [s for wd in words for s in WER_WORDS[wd]]
            ids = inv.encode([u for s in syllables
                              for u in pinyin.syllable_to_units(s)])
            sig = np.concatenate([corpus_io.synth_unit_signal(
                u, 4800, 16000, rng) for u in ids])
            wav_io.write_wav(os.path.join(audio, f"utt{i:04d}.wav"), sig,
                             16000)
            with open(os.path.join(label, f"utt{i:04d}.wav.trn"), "w") as f:
                f.write(" ".join(syllables) + "\n")
            refs.append(words)
        cfg = Config()
        cfg.paths.audio_file_path, cfg.paths.label_file_path = audio, label
        cfg.train.load_line, cfg.train.label_format = 0, "pinyin"
        cfg.frontend.vad = False
        cfg.model.mix_level = cfg.model.max_mix_level = 2
        cfg.train.batch_size, cfg.train.max_frames = 10, 256
        cfg.train.max_label_len, cfg.train.proportion = 8, 1.0
        cfg.train.step = 4
        lex = PronunciationLexicon()
        lex.generate(names, pinyin)
        flat = FlatLexicon.from_tree(lex.lexicon, inv)

        runs = {}
        for dev in ("cuda", "cpu"):
            for kernel in hk.KERNELS.values():
                kernel.launches = 0
            batches = list(corpus_io.Corpus(cfg, inv, device=dev).batches())
            tr = Trainer(cfg, inv, device=dev,
                         generator=torch.Generator().manual_seed(seed))
            lls = tr.auto(batches, t=4, mode=2, init=True)
            dec = DeviceBeamDecoder(tr.export_bank(), flat)
            utts = [(b.feats[i], refs[k * 10 + i])
                    for k, b in enumerate(batches)
                    for i in range(len(b.feats))]
            n_frames = [int(m.sum()) for b in batches for m in b.t_masks]
            result = evaluate_decoder(dec, utts, n_frames)
            words = [list(dec.decode(f, n_frames=n, return_nbest=1)[0].words)
                     for (f, _), n in zip(utts, n_frames)]
            runs[dev] = dict(
                wer=result.wer, substitutions=result.substitutions,
                deletions=result.deletions, insertions=result.insertions,
                ref_tokens=result.ref_tokens, logliks=lls, words=words,
                dp_kernel_launches={k: f.launches
                                    for k, f in hk.KERNELS.items()})
    g, c = runs["cuda"], runs["cpu"]
    check(len(g["words"]) == 20 and g["ref_tokens"] == sum(map(len, refs)),
          "every utterance was scored")
    check(g["dp_kernel_launches"]["forward"] >= 4
          and g["dp_kernel_launches"]["backward"] >= 4,
          f"training on the card launched the forward and backward kernels "
          f"every epoch: {g['dp_kernel_launches']}")
    check(not any(c["dp_kernel_launches"].values()),
          "the CPU run launched no kernel")
    check(g["wer"] == 0.0, f"WER of the model trained on the card: {g}")
    check(g["words"] == c["words"], f"words on the card {g['words']} vs on "
          f"the CPU {c['words']}")
    say("wer_e2e", utterances=20, units=len(inv), mixtures=2,
        gpu={k: v for k, v in g.items() if k != "words"},
        cpu={k: v for k, v in c.items() if k != "words"},
        words_equal=True, one_best=["".join(w) for w in g["words"][:5]],
        phase_seconds=time.perf_counter() - t0)


# phases that --only can run by themselves, each as f(seed, smi)
SOLO = {
    "hmm_kernels": lambda seed, smi: phase_hmm_kernels(seed),
    "train_throughput": phase_train_throughput,
    "train_scheme1": phase_train_scheme1,
    "stream": phase_stream,
    "pruned": phase_pruned,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=sorted(SOLO), help="after the build "
                    "run this phase alone, --repeat times, and print no "
                    "result line: for holding two checkouts against each "
                    "other on one machine, alternating between them")
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args(argv)

    smi = phase_device()
    phase_build()
    if args.only:
        for _ in range(args.repeat):
            SOLO[args.only](args.seed, smi)
        return 0
    records = phase_kernel(args.seed)
    records.update(phase_hmm_kernels(args.seed))
    phase_known_answer(args.seed)
    launches, dec = phase_serve(args.seed)
    bf16_launches = phase_throughput(args.seed, dec, smi)
    del dec
    torch.cuda.empty_cache()
    train_launches = phase_train_throughput(args.seed, smi)
    phase_train_e2e(args.seed)
    phase_train_scheme1(args.seed, smi)
    phase_scheme1_e2e(args.seed)
    phase_stream(args.seed, smi)
    phase_pruned(args.seed, smi)
    phase_cli(args.seed)
    phase_wer_e2e(args.seed)
    check("jax" not in sys.modules, "jax was never imported")
    check(not [m for m in sys.modules if m.split(".")[0] == "poccala_tpu"],
          "nothing of the JAX package was imported")

    kernels = [dict(name="gmm_log_scores", route="cuda", source=gk.SOURCE,
                    replaces=gk.REPLACES, launches=launches,
                    **records["float32"]),
               dict(name="gmm_log_scores_bf16", route="cuda",
                    source=gk.SOURCE, replaces=gk.REPLACES,
                    launches=bf16_launches, **records["bfloat16"])]
    kernels += [dict(name=f"hmm_{k}_banded", route="cuda", source=hk.SOURCE,
                     replaces=hk.REPLACES[k], launches=train_launches[k],
                     **records[k]) for k in hk.KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
