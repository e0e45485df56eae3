"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the hand-written CUDA kernels from ``poccala_tpu_torch/csrc`` (the
GMM scorer in float32 and bfloat16, the banded HMM forward / backward /
Viterbi, the device decoder's frame scan, its block-pruned frame scan and
its n-best), holds each against its plain PyTorch version (the frame scan
bit for bit at the decode cell's size with no LM, a flat and a sparse
bigram LM, at a stream chunk's, the CD graph's and the 21,589-node
lexicon's; the pruned scan bit for bit at 256 x 4 s over 21,589 nodes with
8 and 4 active blocks of 256; the n-best bit for bit at the
decode cell with each LM form at ``return_nbest`` 1 and 5, and at 21,589
nodes; the shapes the kernels' first designs refused: 18 token states a
node, a bank of 29,500 senones, 1,100 sentence states), computes each
one's bound (bytes over the memory rate or operations over the peak rate),
and drives both halves of the port's main path at full model width with
random weights from a seeded ``torch.Generator``:

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
* the host decoder tiers, the JAX command line's default decode, at the
  decode width: one ``VectorBeamDecoder.decode_batch`` of 16 x 4 s (one
  GMM launch, the rest host NumPy) and one ``BeamDecoder.decode``, each
  held to a CPU copy of the bank;
* block-pruned decode over a synthetic 21.6k-node lexicon at the decode
  batch (256 x 4 s), exact against ``active_blocks`` 8 and 4 (one pruned
  scan launch a call), and a pruned stream session (one a chunk);
* the command line (``python -m poccala_tpu_torch.cli --device cuda``):
  synth-corpus, train, align, decode (every tier), listen and serve on a
  small corpus, train, align and decode held against ``--device cpu``;
* recognition by a model trained on the card: 20 WAVs of separable
  units -> ``Trainer.auto(mode=2)`` -> ``DeviceBeamDecoder``,
  ``VectorBeamDecoder`` and ``BeamDecoder`` over ``export_bank()`` ->
  word error rate 0.0, the words equal to a ``device="cpu"`` run;
* context-dependent units: through the command line on a
  formant-synthesised corpus (``train`` -> ``cd-expand`` -> ``decode
  --cd``, ``--device cuda`` held to ``--device cpu``), and at full width a
  seeded system of the size of the JAX package's best artifact (about
  1,091 within-word triples over XIF_tone + ``sil``, trees grown to 2,049
  senones, 6 mixtures, 39 dims): one training epoch and one decode call
  at 256 x 4 s, tree growing and lexicon compilation in host seconds.

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
import hashlib
import inspect
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
from poccala_tpu_torch.decoder import BeamDecoder
from poccala_tpu_torch.decoder.device import DeviceBeamDecoder
from poccala_tpu_torch.decoder.vector import VectorBeamDecoder
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
from poccala_tpu_torch.ops.cuda import decoder_scan_cuda as dk
from poccala_tpu_torch.ops.cuda import gmm_score_cuda as gk
from poccala_tpu_torch.ops.cuda import hmm_assoc_cuda as ak
from poccala_tpu_torch.ops.cuda import hmm_banded_cuda as hk
from poccala_tpu_torch.ops.frontend import Frontend
from poccala_tpu_torch.ops.gmm_score import (gmm_component_logpdf,
                                             gmm_log_scores)
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
KERNEL_NAMES = ("gmm_score", "hmm_banded", "decoder_scan", "hmm_assoc")
# the context-dependent system: triples, tied senones and mixtures of the
# JAX package's best artifact (WER_r05_cd2k_map.json)
CD_TRIPLES, CD_S, CD_M = 1091, 2049, 6
# GPU vs CPU CD banks of cd-expand's retrain (grouped EM from the clones, a
# transition epoch, a Baum-Welch epoch, the MAP blend) from one CI
# checkpoint: tests/test_torch_cli.py's tolerance
CD_BANK_TOL = dict(rtol=1e-3, atol=1e-3)
# GPU vs CPU gains of the context trees' splits (see phase_cd_e2e)
CD_GAIN_RTOL = 1e-4
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


def synced_ms(fn, reps: int = 1):
    """``fn()``'s first result and the median host ms of ``reps`` calls,
    each synchronised before and after."""
    outs, times = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return outs[0], float(np.median(times))


def kernel_counts() -> dict:
    return dict(gmm=gk.gmm_log_scores_cuda.launches,
                **{k: f.launches for k, f in hk.KERNELS.items()},
                scan=dk.decoder_scan_cuda.launches,
                pruned=dk.decoder_scan_pruned_cuda.launches,
                fin=dk.decoder_finalize_cuda.launches,
                product=ak.lse_product_cuda.launches,
                rows=ak.lse_rows_cuda.launches)


# the counters of kernels that the exact search's paths (decode, stream,
# CD, sharded) do not launch: the pruned scan, and forward_log_assoc's two
# (no path of the system calls it)
OFF_EXACT_PATHS = ("pruned", "product", "rows")


def reset_kernel_counts() -> None:
    gk.gmm_log_scores_cuda.launches = 0
    for kernel in hk.KERNELS.values():
        kernel.launches = 0
    dk.decoder_scan_cuda.launches = 0
    dk.decoder_scan_pruned_cuda.launches = 0
    dk.decoder_finalize_cuda.launches = 0
    ak.lse_product_cuda.launches = 0
    ak.lse_rows_cuda.launches = 0


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
    ``<length><identifier>`` component and its integer (or bool) template
    arguments."""
    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    pos, name = m.end(), mangled
    while (n := re.match(r"\d+", mangled[pos:])):
        start = pos + n.end()
        name, pos = mangled[start:start + int(n.group())], \
            start + int(n.group())
    args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[pos:])
    if args:
        name += "<" + ",".join(re.findall(r"L[ib](\d+)E", args.group(1))) + ">"
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


PTXAS: dict = {}    # kernel source -> ptxas_summary of this run's build


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
        PTXAS[name] = ptxas
        say("build", kernel=name, seconds=round(secs, 3),
            compiled=built.compiled, library=str(built.path.name),
            ptxas_registers_spill_stores_loads=ptxas)
        if name == "hmm_banded" and built.compiled:
            warp = {k: v for k, v in ptxas.items() if "warp_kernel" in k}
            check(len(warp) == 60, f"60 warp instantiations ({len(warp)})")
            # ptxas trades a few bytes of spill for a register step in some
            # instantiations; none in those of the training shape (K = 2)
            # and of the default config's sentence width (K = 4), W = 5
            used = {k: v for k, v in warp.items()
                    if k.endswith(("<2,5>", "<4,5>"))}
            check(len(used) == 6 and all(v[1:] == [0, 0]
                                         for v in used.values()),
                  f"no spills in the warp kernels in use: {used}")
            say("build_spills", warp_kernels_with_spills={
                k: v for k, v in warp.items() if v[1:] != [0, 0]})


def scoring_inputs(t: int, gen: torch.Generator, floor: bool = False,
                   S: int = S, M: int = M):
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
    rate of their type, whichever is larger.  Each add, multiply, max or
    compare counts as one operation, as in the published rates, which count
    an FMA as two: a kernel of adds and compares (the scans) issues at most
    half of the float32 rate, so its bound is a floor it cannot reach."""
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
    cases; ``dead_slot`` gives the last mixture slot (or the last
    ``dead_slot`` slots) the weight -1e30 of a padded slot."""
    means = torch.randn(s, m, d, generator=gen) * 2
    log_var = torch.rand(s, m, d, generator=gen) * 2.0 - 0.5
    x = torch.randn(t, d, generator=gen) * 2
    log_w = torch.log_softmax(torch.randn(s, m, generator=gen), dim=-1)
    if dead_slot:
        log_w[:, -int(dead_slot):] = -1e30
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
    # the context-dependent bank's shape: S odd, 6 mixtures
    for dtype in ("float32", "bfloat16"):
        args = scoring_inputs(SLICE_T, gen, S=CD_S, M=CD_M)
        err, ok, tol = compare_gmm(args, dtype)
        kw = dict(score_dtype=dtype)
        op = torch.float32 if dtype == "float32" else torch.bfloat16
        xa = torch.randn(SLICE_T, 2 * D, device="cuda").to(op)
        w = torch.randn(2 * D, CD_S * CD_M, device="cuda").to(op)
        line = dict(
            t=SLICE_T, s=CD_S, m=CD_M, d=D, score_dtype=dtype,
            normalizer="textbook", max_abs_err=err, tol=tol, ok=ok,
            ms=median_ms(lambda: gk.gmm_log_scores_cuda(*args, **kw)),
            plain_ms=median_ms(lambda: gmm_log_scores(*args, **kw), reps=3),
            library_ms=median_ms(lambda: torch.matmul(xa, w)),
            library_call="torch.matmul, the product alone",
            **gmm_bound(SLICE_T, CD_S, CD_M, D, dtype))
        del xa, w, args
        records[f"{dtype}_cd"] = {k: line[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
        say("kernel_vs_plain", **line)
        check(ok, f"kernel vs plain at the CD shape: {line}")
        torch.cuda.empty_cache()
    # ragged shapes: T and S off the tiles, one mixture, a padded slot,
    # other feature widths (run-time K), S odd / even / a multiple of 4
    ragged = [dict(t=1, s=1, m=1, d=39), dict(t=130, s=65, m=1, d=39),
              dict(t=333, s=607, m=3, d=39, dead_slot=True),
              dict(t=200, s=606, m=8, d=13), dict(t=5000, s=100, m=2, d=7),
              dict(t=40000, s=130, m=4, d=40), dict(t=77, s=64, m=5, d=26),
              dict(t=333, s=CD_S, m=8, d=39, dead_slot=2)]
    for shape in ragged:
        for dtype in ("float32", "bfloat16"):
            err, ok, tol = compare_gmm(scoring_case(gen, **shape), dtype)
            say("kernel_vs_plain_ragged", **shape, score_dtype=dtype,
                max_abs_err=err, tol=tol, ok=ok)
            check(ok, f"kernel vs plain at ragged {shape} {dtype}")
    torch.cuda.empty_cache()
    return records


# the long-sentence training cell's scoring: 256 utterances of 960 frames,
# sentences of 266 states, the tied bank of 2,049 senones x 16 mixtures
SENT_B, SENT_T, SENT_N, SENT_S, SENT_M = 256, 960, 266, 2049, 16
SENTENCE_REPLACES = ("no Pallas kernel: plain jnp, "
                     "poccala_tpu/train/accumulators.py:152-166")


def sentence_bound(b: int, t: int, n: int, m: int, d: int,
                   components: bool) -> dict:
    """x, the rows and the packed bank's rows the sentences name in, the
    scores [B, T, N] (and the components [B, T, N, M]) out, float32;
    2·B·T·N·M·2D operations of the product."""
    n_bytes = 4 * (b * t * d + b * n * (m * (2 * d + 1) + 2) + b * t * n
                   + (b * t * n * m if components else 0))
    return bound_ms(n_bytes, 2 * b * t * n * m * 2 * d, "float32")


def phase_sentence(seed: int, smi: str) -> dict:
    """The sentence kernel (the E-step's and the alignment's scoring)
    against the plain scoring at the training cell's shape and at B = 1:
    with the components, without them, and the plain version, each time
    beside its bound.  Returns the records by case."""
    gen = torch.Generator().manual_seed(seed)
    x, means, log_var, log_w = scoring_inputs(SENT_T, gen, S=SENT_S,
                                              M=SENT_M)
    records = {}
    for b in (SENT_B, 1):
        xs = (x[None] + torch.randn(b, SENT_T, D, generator=gen).cuda())
        sen = torch.randint(0, SENT_S, (b, SENT_N), generator=gen).cuda()

        def plain(xs=xs, sen=sen):
            comp = gmm_component_logpdf(xs, means[sen], log_var[sen]) \
                + log_w[sen][:, None]
            return torch.logsumexp(comp, dim=-1), comp

        # held to the plain version on the first 4 utterances
        scores, comp = gk.sentence_scores_cuda(xs, sen, means, log_var,
                                               log_w)
        want_scores, want_comp = plain(xs[:4].contiguous(), sen[:4])
        err = max(float((scores[:4] - want_scores).abs().max()),
                  float((comp[:4] - want_comp).abs().max()))
        ok = bool(torch.allclose(scores[:4], want_scores, **F32_TOL)
                  and torch.allclose(comp[:4], want_comp, **F32_TOL))
        del comp, want_scores, want_comp
        line = dict(b=b, t=SENT_T, n=SENT_N, s=SENT_S, m=SENT_M, d=D,
                    max_abs_err=err, tol=F32_TOL, ok=ok)
        for components in (True, False):
            key = "comp" if components else "scores"

            def call(components=components):
                return gk.sentence_scores_cuda(xs, sen, means, log_var,
                                               log_w, components=components)

            line[key] = dict(
                ms=median_ms(call),
                kernel_ms=kernel_device_ms(call, "sentence_score_f32"),
                **sentence_bound(b, SENT_T, SENT_N, SENT_M, D, components))
            torch.cuda.empty_cache()
        line["plain_ms"] = median_ms(plain, reps=3)
        torch.cuda.empty_cache()
        line["clocks_under_load"] = clocks_under_load(
            lambda: gk.sentence_scores_cuda(xs, sen, means, log_var, log_w,
                                            components=False), 30)
        line["nvidia_smi"] = smi
        say("sentence_vs_plain", **line)
        check(ok, f"sentence kernel vs plain at B = {b}: {line}")
        records[f"b{b}"] = line
        del xs, sen
    return records


STATS_REPLACES = ("no Pallas kernel: plain jnp, "
                  "poccala_tpu/train/accumulators.py:231-238")


def cell_lattice(seed: int, n_utts: int | None = None):
    """One batch of the long-sentence training cell, drawn by the
    benchmark's own generator (``asrbench``: configuration
    ``cd_tied2k_m16``, traffic ``train_long_b256``) on the card, its first
    ``n_utts`` utterances if given, scored by the start bank, and the
    forward-backward's posteriors: ``(bank, (labels, label_lens, xs,
    t_masks, max_label_len), (comp, scores, gamma, emitting, xs))``, the
    last the statistics kernel's operands."""
    from asrbench.harness import spec
    from asrbench.harness.model import build_model, make_bank, start_bank
    from asrbench.harness.traffic import make_batches

    cfg = spec.config("cd_tied2k_m16")
    model = build_model(cfg, seed)
    gen_bank = make_bank(model, seed, "cuda")
    batch = make_batches(model, gen_bank, spec.traffic("train_long_b256"),
                         seed, n_batches=1)[0]
    start = start_bank(model, gen_bank, seed)
    bank = sb.SenoneBank(**{k: start[k] for k in (
        "means", "log_var", "log_w", "log_A", "log_pi", "mix_counts",
        "senone_map")})
    b = n_utts or batch.feats.shape[0]
    n_states, max_l = cfg["state_num"], cfg["train"]["max_label_len"]
    labels = torch.zeros((b, max_l), dtype=torch.int64, device="cuda")
    labels[:, :batch.labels.shape[1]] = torch.as_tensor(batch.labels[:b])
    lens = torch.as_tensor(batch.label_lens[:b], device="cuda")
    xs, masks = batch.feats[:b].contiguous(), batch.t_masks()[:b]
    ehmm = build_embedded_batch(bank, labels, lens, n_states, max_l)
    comp, scores, log_b = acc.sentence_scores(bank, ehmm, xs)
    la, lb, ll = acc._forward_backward(ehmm, log_b, masks, n_states, 1,
                                       0.64)
    gamma = acc._posterior(la + lb - ll[:, None, None],
                           masks[:, :, None] & ehmm.state_mask[:, None, :])
    return bank, (labels, lens, xs, masks, max_l), (
        comp, scores, gamma, ehmm.senone_idx >= 0, xs)


def stats_bound(gamma, emitting, m: int, d: int) -> dict:
    """gamma, the emitting mask and x read once; of comp and scores the
    rows of the live tiles (32 frames x 8 states); c, cx, cxx written once;
    float32.  Operations: the 2·M·(2D + 1) of a live (frame, state) pair's
    moments."""
    b, t, n = gamma.shape
    tiles = gk.stats_tiles_plain(gamma, emitting).sum(dim=0).tolist()
    pairs = int(((gamma != 0) & emitting[:, None, :]).sum())
    n_bytes = (4 * b * t * n + b * n + 4 * b * t * d
               + 4 * tiles[0] * 32 * 8 * (m + 1)
               + 4 * b * n * m * (2 * d + 1))
    return dict(live_tiles=tiles[0], tiles=tiles[1], live_pairs=pairs,
                **bound_ms(n_bytes, 2 * pairs * m * (2 * d + 1), "float32"))


def phase_stats(seed: int, smi: str) -> dict:
    """The statistics kernel (the E-step's GMM moments over the live
    posteriors) at the training cell's shape, on a batch drawn by the
    benchmark's own generator and its forward-backward's posteriors:
    against the plain lines, its tally of live tiles against a count over
    the posteriors, and the kernel alone, the wrapper and the plain lines
    beside the bound.  Returns the record."""
    _, _, lattice = cell_lattice(seed)
    comp, scores, gamma, emitting, xs = lattice
    b, t, n, m = comp.shape
    d = xs.shape[2]
    before = gk.stats_tile_tally()
    got = gk.sentence_stats_cuda(*lattice)
    after = gk.stats_tile_tally()
    want = acc._mixture_moments(*lattice)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    ok = all(bool(torch.allclose(g, w, **F32_TOL))
             for g, w in zip(got, want))
    del got, want
    torch.cuda.empty_cache()
    bound = stats_bound(gamma, emitting, m, d)
    tally = dict(live=after[0] - before[0], all=after[1] - before[1])

    def call():
        return gk.sentence_stats_cuda(*lattice)

    line = dict(b=b, t=t, n=n, m=m, d=d, max_abs_err=err, tol=F32_TOL,
                ok=ok, tally=tally,
                live_tile_share=tally["live"] / max(tally["all"], 1),
                nonzero_gamma_share=bound["live_pairs"] / gamma.numel(),
                ms=median_ms(call),
                kernel_ms=kernel_device_ms(call, "sentence_stats_f32"),
                **bound)
    torch.cuda.empty_cache()
    line["plain_ms"] = median_ms(lambda: acc._mixture_moments(*lattice),
                                 reps=3)
    torch.cuda.empty_cache()
    line["ptxas_registers_spill_stores_loads"] = PTXAS.get(
        "gmm_score", {}).get("sentence_stats_f32_kernel", "not rebuilt")
    line["clocks_under_load"] = clocks_under_load(call, 30)
    line["nvidia_smi"] = smi
    say("stats_vs_plain", **line)
    check(ok, f"statistics kernel vs plain: {line}")
    check((tally["live"], tally["all"]) == (bound["live_tiles"],
                                            bound["tiles"]),
          f"the tally reads the live tiles: {tally}, {bound}")
    return line


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


def phase_serve(seed: int, n_req: int = 16) -> tuple[dict, DeviceBeamDecoder]:
    """cli.py:cmd_serve's composition: WAV -> frontend -> VAD -> packed
    features -> DecodeService(batch 8) -> the port's decoder on the GPU.
    Returns the GMM, frame-scan and n-best kernels' launches of this
    run."""
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

        reset_kernel_counts()
        with DecodeService(dec, batch_size=8) as svc:
            feats, futs = [], []
            for lo in range(0, n_req, 8):
                chunk = [features(p) for p in paths[lo: lo + 8]]
                feats += chunk
                futs += [svc.submit(f) for f in chunk]
            results = [f.result(timeout=600) for f in futs]
        launches = dict(gmm=gk.gmm_log_scores_cuda.launches,
                        scan=dk.decoder_scan_cuda.launches,
                        fin=dk.decoder_finalize_cuda.launches)
    stats = svc.stats
    for i, hyps in enumerate(results):
        check(len(hyps) >= 1 and np.isfinite(hyps[0].score),
              f"request {i} answered with a finite 1-best")
    check(launches["gmm"] > 0, "the served decodes launched the CUDA kernel")
    check(launches["scan"] == stats.batches == launches["fin"],
          f"one frame-scan and one n-best launch per served batch: "
          f"{launches}")
    n_min = min(len(f) for f in feats[:8])
    busy = device_profile(lambda: dec.decode_batch(
        np.stack([f[:n_min] for f in feats[:8]]), [n_min] * 8))
    say("serve", requests=stats.requests, batches=stats.batches,
        frames=stats.frames, kept_frames=[len(f) for f in feats],
        kernel_launches=launches["gmm"], scan_kernel_launches=launches["scan"],
        finalize_kernel_launches=launches["fin"],
        batch_of_8_decode_call_profile=busy,
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


def device_profile(fn, events: bool = False):
    """One call of ``fn`` under ``torch.profiler``: wall time, summed
    kernel time, the device's busy share of the wall time, the kernel
    count and the costliest kernels.  The device numbers read "not
    measured" when the profiler records no device time.  With ``events``
    also every device event's name and count, as a second result."""
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
    names = [(e.key[:60], e.count) for e in kernels]
    if kernel_ms <= 0:
        out = dict(wall_ms=wall_ms, busy_share="not measured")
        return (out, names) if events else out
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    out = dict(wall_ms=wall_ms, kernel_ms=kernel_ms,
               busy_share=kernel_ms / wall_ms,
               kernels=sum(e.count for e in kernels),
               top=[(e.key[:60], e.count, e.self_device_time_total / 1e3)
                    for e in top])
    return (out, names) if events else out


def profiled(fn):
    """``fn()``'s result and the :func:`device_profile` of that call."""
    out = []
    profile = device_profile(lambda: out.append(fn()))
    return out[0], profile


def phase_throughput(seed: int, dec: DeviceBeamDecoder, smi: str,
                     batch: int = 256, utt_seconds: float = 4.0,
                     calls: int = 3) -> int:
    """bench.py:bench_decode's shape: frontend + scoring + frame loop +
    n-best per call, double-buffered dispatch/collect, host work inside
    the timed region.  Then one call of the same batch through a decoder
    with ``score_dtype="bfloat16"``.  Returns the n-best kernel's launches
    in the timed calls and the bfloat16 kernel's in its call."""
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
    dk.decoder_scan_cuda.launches = 0
    dk.decoder_scan_pruned_cuda.launches = 0
    dk.decoder_finalize_cuda.launches = 0
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
    scan_launches = dk.decoder_scan_cuda.launches
    fin_launches = dk.decoder_finalize_cuda.launches
    check(all(len(h) >= 1 for h in hyps), "every utterance decoded")
    check(scan_launches == calls == fin_launches, f"one frame-scan and one "
          f"n-best launch per decode call ({scan_launches}, {fin_launches} "
          f"in {calls})")

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
        decode_call_launches=busy.get("kernels", "not measured"),
        scan_kernel_launches=scan_launches,
        finalize_kernel_launches=fin_launches,
        bf16_call=dict(wall_ms=bf16_ms, kernel_launches=bf16_launches,
                       max_rel_score_drift_vs_f32=drift),
        device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    return dict(fin=fin_launches, bf16=bf16_launches)


def phase_host_decode(seed: int, smi: str, batch: int = 16,
                      utt_seconds: float = 4.0) -> int:
    """The JAX command line's default decode on the card: the host tiers
    (``VectorBeamDecoder.decode_batch``, ``BeamDecoder.decode``) at the
    decode cell's width (XIF_tone, 606 senones, 8 mixtures, 39 dims,
    the built-in lexicon), scoring on the card, token passing on the host.
    The batch is ``batch`` x ``utt_seconds`` of noise (the throughput
    phase's 256 cut to 16: the host pool grows to ~2,000 rows an utterance
    a frame before pruning).  One vector call: its wall ms, the GMM
    kernel's launches (exactly one) and ms, the host's share; the same
    batch through a CPU copy of the bank (the plain scorer): every n-best
    equal, scores at 1e-4.  One simple-tier decode of the first utterance
    on the card and on the CPU: the same n-best.  Printed, not required:
    how many 1-bests the device tier shares with the vector tier on this
    noise.  Returns the GMM kernel's launches on the two host paths."""
    t_phase = time.perf_counter()
    dev_dec, cfg = full_width_decoder(seed, "cuda")
    bank, flat = dev_dec.bank, dev_dec.lexicon
    cpu_bank = sb.bank_from_numpy(sb.bank_to_numpy(bank), device="cpu")
    fe = Frontend(cfg.frontend, device="cuda")
    n_samples = int(utt_seconds * cfg.frontend.sample_rate)
    rng = np.random.default_rng(seed + 1)
    signals = torch.as_tensor(
        (rng.normal(size=(batch, n_samples)) * 2000).astype(np.float32),
        device="cuda")
    feats, masks = fe.mfcc_batch(
        signals, torch.full((batch,), n_samples, device="cuda"))
    n_frames = masks.sum(dim=1).cpu().numpy()
    x = feats.reshape(-1, feats.shape[-1])

    # the kernel against its plain version at this call's shape
    got = gk.gmm_log_scores_cuda(x, bank.means, bank.log_var, bank.log_w)
    want = gmm_log_scores(x.cpu(), cpu_bank.means, cpu_bank.log_var,
                          cpu_bank.log_w)
    err = float((got.cpu() - want).abs().max())
    check(bool(torch.allclose(got.cpu(), want, **F32_TOL)),
          f"kernel vs plain at T = {x.shape[0]}: max abs err {err}")
    kernel_ms = median_ms(lambda: gk.gmm_log_scores_cuda(
        x, bank.means, bank.log_var, bank.log_w))
    plain_ms = median_ms(lambda: gmm_log_scores(
        x, bank.means, bank.log_var, bank.log_w))
    # the product alone in one library call, as phase_kernel times it
    xa = torch.randn(x.shape[0], 2 * D, device="cuda")
    w = torch.randn(2 * D, S * M, device="cuda")
    library_ms = median_ms(lambda: torch.matmul(xa, w))
    del xa, w

    vec = VectorBeamDecoder(bank, flat)
    vec.decode_batch(feats[:2, :20], n_frames[:2].clip(max=20))  # tables
    reset_kernel_counts()
    hyps, wall_ms = synced_ms(lambda: vec.decode_batch(feats, n_frames))
    vec_launches = gk.gmm_log_scores_cuda.launches
    check(vec_launches == 1, f"one GMM launch per decode_batch: "
          f"{vec_launches}")
    check(all(h and np.isfinite(h[0].score) for h in hyps),
          "every utterance has a finite 1-best")
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    vec._frame_scores(x)
    e1.record()
    torch.cuda.synchronize()
    frame_scores_ms = e0.elapsed_time(e1)

    cpu_vec = VectorBeamDecoder(cpu_bank, flat)
    cpu_hyps, cpu_ms = synced_ms(
        lambda: cpu_vec.decode_batch(feats.cpu(), n_frames))
    for i, (g, c) in enumerate(zip(hyps, cpu_hyps)):
        same_nbest(g, c, f"vector tier, utterance {i}, card vs CPU")

    x0 = feats[0, : int(n_frames[0])].cpu().numpy()
    simple = BeamDecoder(bank, flat)
    reset_kernel_counts()
    s_hyps, simple_ms = synced_ms(lambda: simple.decode(x0))
    simple_launches = gk.gmm_log_scores_cuda.launches
    check(simple_launches == 1, f"one GMM launch per simple decode: "
          f"{simple_launches}")
    c_hyps, simple_cpu_ms = synced_ms(
        lambda: BeamDecoder(cpu_bank, flat).decode(x0))
    same_nbest(s_hyps, c_hyps, "simple tier, card vs CPU")

    device_best = dev_dec.decode_batch(feats, n_frames)
    agree = sum(bool(d) and d[0].words == v[0].words
                for d, v in zip(device_best, hyps))
    say("host_decode", batch=batch, utt_seconds=utt_seconds,
        frames=int(feats.shape[1]), lexicon_nodes=int(flat.n_nodes),
        senones=int(bank.num_states), mixtures=int(bank.means.shape[1]),
        vector_call_ms=wall_ms, vector_audio_s_per_s=batch * utt_seconds
        / (wall_ms / 1e3), kernel_launches=vec_launches,
        kernel_ms=kernel_ms, frame_scores_ms=frame_scores_ms,
        host_share=(wall_ms - kernel_ms) / wall_ms,
        kernel_max_abs_err=err, kernel_plain_ms=plain_ms,
        kernel_library_ms=library_ms,
        kernel_bound=gmm_bound(x.shape[0], S, M, D, "float32"),
        cpu_vector_call_ms=cpu_ms,
        nbest_equal_card_vs_cpu=batch, simple_decode_ms=simple_ms,
        simple_cpu_decode_ms=simple_cpu_ms,
        simple_kernel_launches=simple_launches,
        one_best_vector_vs_device=f"{agree}/{batch}",
        one_best=["".join(h[0].words) for h in hyps[:4]],
        phase_seconds=time.perf_counter() - t_phase,
        device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    return vec_launches + simple_launches


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
    """Mean device time of the ``name`` kernel (``forward_*``,
    ``backward_*`` or ``viterbi_*`` in ``hmm_banded.cu``, ``decoder_scan_*``
    or ``decoder_finalize_*`` in ``decoder_scan.cu``) over the launches
    that ``torch.profiler`` records in ``reps`` calls of ``fn``: the kernel
    alone, no launch gaps, no host time.  A profile that kept no device
    event is taken once more; "not measured" when neither did."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and f"{name}_" in e.key and "kernel" in e.key]
        launches = sum(e.count for e in events)
        if launches:
            total_us = sum(e.self_device_time_total for e in events)
            return total_us / 1e3 / launches
    return "not measured"


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


def same_as_block(name: str, got, old) -> dict:
    """A warp kernel's outputs against the block route's on the same
    inputs: alpha, beta and all of Viterbi's (score, path, final delta) bit
    for bit; forward's loglik, which the warp sums in another order, at
    DP_TOL."""
    if name == "forward":
        check(torch.allclose(got[1], old[1], **DP_TOL),
              "warp forward loglik vs the block route's")
        return dict(
            alpha_equals_block_kernel=torch.equal(got[0], old[0]),
            loglik_max_rel_diff_vs_block_kernel=float(
                ((got[1] - old[1]).abs() / old[1].abs()).max()))
    if name == "backward":
        return dict(beta_equals_block_kernel=torch.equal(got, old))
    return dict(viterbi_equals_block_kernel=all(
        torch.equal(g, o) for g, o in zip(got, old)))


def viterbi_routes(gen: torch.Generator, w: int) -> None:
    """Viterbi where the first maximum and the dispatch decide: quantised
    scores (ties in every step and at the end), a degenerate utterance (all
    deltas at the sentinel), ``end_states`` 0 / 1 / N, one frame, and an
    utterance whose backpointers do not fit shared memory, which the
    dispatch sends to the block route.  Each against the plain version
    (paths equal) and warp against block bit for bit."""
    band, log_pi, log_b, masks = dp_inputs(gen, 8, 64, TRAIN_L)
    n = int(band.shape[1])
    tied = torch.round(log_b / 16) * 16
    degenerate_pi, degenerate_b = log_pi.clone(), log_b.clone()
    degenerate_pi[2], degenerate_b[2] = -1e30, -1e30
    long_ops = dp_inputs(gen, 4, 2000, TRAIN_L)
    cases = [("ties", (band, log_pi, tied, masks), 0),
             ("ties_end_1", (band, log_pi, tied, masks), 1),
             ("ties_end_n", (band, log_pi, tied, masks), n),
             ("degenerate", (band, degenerate_pi, degenerate_b, masks), 0),
             ("one_frame", (band, log_pi, log_b[:, :1].contiguous(),
                            masks[:, :1].contiguous()), 0),
             ("long_block_route", long_ops, 0)]
    for label, (bd, pi, lb, mk), end in cases:
        t = int(lb.shape[1])
        warp = hk.viterbi_takes_warp(t, int(bd.shape[1]), w)
        check(warp == (label != "long_block_route"),
              f"viterbi {label}: the dispatch chose warp={warp}")
        got = hk.viterbi_banded_cuda(bd, pi, lb, mk, w, end)
        old = hk.viterbi_banded_cuda(bd, pi, lb, mk, w, end, block=True)
        want = hmm_ops.viterbi_log_banded_plain(bd, pi, lb, mk, w, end)
        torch.cuda.synchronize()
        err, ok, tol = compare_dp("viterbi", got, want)
        equal = same_as_block("viterbi", got, old)
        say("hmm_kernel_vs_plain", kernel="viterbi", case=label,
            b=int(lb.shape[0]), t=t, n_s=int(bd.shape[1]), w=w,
            end_states=end, warp_kernel=warp, max_abs_err=err, tol=tol,
            ok=bool(ok), negative_states=int((want[1] < 0).sum()), **equal)
        check(ok and all(equal.values()), f"viterbi {label}: kernel vs plain "
              f"{ok}, vs block {equal}")


def phase_hmm_kernels(seed: int) -> dict:
    """Each DP kernel against its plain version at a small ragged shape, a
    shape with four registers a lane (N = 98, the default config's sentence
    width) and bench.py's training shape, and bit for bit against the block
    route (``block=True``), which takes the shapes these do not; then
    Viterbi's special cases
    (:func:`viterbi_routes`).  Times at the last two shapes: ``ms`` one
    event pair around a wrapper call, ``device_ms`` the kernel alone under
    the profiler, ``ms_b1`` / ``device_ms_b1`` the same for the first
    utterance alone (the length of the dependent chain), ``block_ms`` /
    ``block_device_ms`` the block route on the same inputs.  Then the block
    route at the shapes it serves (:func:`block_route_shapes`) and its
    launches on the training path at L = 88 (:func:`training_path_launches`).
    Returns the ``kernels`` records."""
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
                    lambda: hk.viterbi_banded_cuda(bd, pi, lb, mk, w, **kw),
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
            warp = (hk.viterbi_takes_warp(t, n, w) if name == "viterbi"
                    else hk.takes_warp(n, w))
            line = dict(kernel=name, b=b, t=t, n_s=n, w=w, warp_kernel=warp,
                        max_abs_err=err, tol=tol, ok=bool(ok))
            check(warp, f"hmm {name} at N = {n}, W = {w} takes the warp kernel")
            old = block[name][0]()
            torch.cuda.synchronize()
            equal = same_as_block(name, got, old)
            line.update(equal)
            err1, ok1, _ = compare_dp(name, first[name][0](),
                                      first[name][1]())
            check(ok1, f"hmm {name} kernel vs plain at B = 1 ({err1})")
            if timed:
                line["ms"] = median_ms(kernel, reps=21)
                line["device_ms"] = kernel_device_ms(kernel, name)
                line["ms_b1"] = median_ms(first[name][0], reps=21)
                line["device_ms_b1"] = kernel_device_ms(first[name][0],
                                                        name)
                line["block_ms"] = median_ms(block[name][0], reps=21)
                line["block_device_ms"] = kernel_device_ms(
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
            check(all(v for k, v in equal.items() if "equals" in k),
                  f"warp and block kernels bit-equal at {line}")
    viterbi_routes(gen, w)
    torch.cuda.empty_cache()
    shapes = block_route_shapes(gen)
    launches = training_path_launches(gen, BLOCK_SHAPES[0][1])
    for name in ("forward", "backward", "viterbi"):
        first = shapes[name][0]
        extra = ("scratch_bytes",) if name == "viterbi" else ()
        record[f"{name}_block"] = dict(
            launches=launches[name],
            **{f: first[f] for f in ("max_abs_err", "ms", "device_ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "plan") + extra},
            library_ms=None,
            shapes=[{f: v[f] for f in ("b", "t", "n_s", "ms", "device_ms",
                                       "ms_b1", "device_ms_b1", "plain_ms",
                                       "bound_ms", "plan") + extra}
                    for v in shapes[name]])
    say("hmm_block_route_summary", launches_training_path_l88=launches,
        ptxas_registers_spill_stores_loads={
            k: v for k, v in PTXAS.get("hmm_banded", {}).items()
            if "block_kernel" in k})
    return record


# The block route's timed shapes (T = 319, W = 5): (B, L), a label budget
# of L units giving N = 2 + 3 L sentence states at state_num = 5 (two XIF
# units a character): sentences of 44 characters, of 100, the existing
# shapes case, and a carry spread over a cluster.
BLOCK_SHAPES = ((256, 88), (256, 200), (64, 366), (8, 2800))
# Viterbi's long utterance at the default label budget: (B, T, L), 20 s of
# frames at N = 98, whose backpointers the warp kernel cannot hold.
VITERBI_LONG = (64, 1600, 32)


def digest(x: torch.Tensor) -> str:
    """The first 16 hex digits of the tensor's bytes' SHA-256: two
    checkouts' runs on the same inputs agree bit for bit when these do."""
    return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def viterbi_scratch(b: int, t: int, n: int) -> tuple:
    """Viterbi's block-route scratch in bytes as this checkout allocates
    it, and the one-byte-a-state ``[B, T-1, N]`` scratch of the kernel the
    route replaced."""
    old = b * (t - 1) * n
    if not hasattr(hk, "viterbi_scratch_bytes"):   # a parent checkout
        return old, old
    return hk.viterbi_scratch_bytes(b, t, n, TRAIN_W, block=True), old


def block_route_shapes(gen: torch.Generator) -> dict:
    """Forward, backward and Viterbi on the block route at BLOCK_SHAPES,
    and Viterbi at VITERBI_LONG, each against its plain version (Viterbi:
    paths equal): wrapper ``ms``, ``device_ms`` (kernel alone), the same at
    B = 1, ``plain_ms``, bound, the launch plan
    (:func:`hmm_banded_cuda.block_plan`, :func:`~hmm_banded_cuda.
    viterbi_block_plan`), Viterbi's scratch bytes, digests of alpha / beta
    (and loglik) and of Viterbi's score, path and final delta to hold two
    checkouts' runs against each other."""
    out = {"forward": [], "backward": [], "viterbi": []}
    shapes = [(b, TRAIN_T, max_l) for b, max_l in BLOCK_SHAPES]
    for b, t, max_l in shapes + [VITERBI_LONG]:
        band, log_pi, log_b, masks = dp_inputs(gen, b, t, max_l)
        n = int(band.shape[1])
        check(n == 2 + 3 * max_l and not hk.viterbi_takes_warp(t, n, TRAIN_W),
              f"N = {n}, T = {t} takes the block route")

        def calls(lo, hi):
            bd, pi, lb, mk = (a[lo:hi] for a in (band, log_pi, log_b, masks))
            return {
                "forward": (
                    lambda: hk.forward_banded_cuda(bd, pi, lb, mk, TRAIN_W),
                    lambda: hmm_ops.forward_log_banded_plain(bd, pi, lb, mk,
                                                             TRAIN_W)),
                "backward": (
                    lambda: hk.backward_banded_cuda(bd, lb, mk, TRAIN_W),
                    lambda: hmm_ops.backward_log_banded_plain(bd, lb, mk,
                                                              TRAIN_W)),
                "viterbi": (
                    lambda: hk.viterbi_banded_cuda(bd, pi, lb, mk, TRAIN_W),
                    lambda: hmm_ops.viterbi_log_banded_plain(bd, pi, lb, mk,
                                                             TRAIN_W)),
            }

        names = ["viterbi"] if t != TRAIN_T else list(out)
        full, first = calls(0, b), calls(0, 1)
        for name in names:
            kernel, plain = full[name]
            kernel1, plain1 = first[name]
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err, ok, tol = compare_dp(name, got, want)
            check(ok, f"{name} block route vs plain at N = {n}: {err}")
            err1, ok1, _ = compare_dp(name, kernel1(), plain1())
            check(ok1, f"{name} block route vs plain at N = {n}, B = 1")
            # the parent checkout, run with this script copied in to hold
            # its times and digests against these, has no plan to report
            line = dict(kernel=name, route="block", b=b, t=t, n_s=n,
                        w=TRAIN_W, max_abs_err=err, tol=tol, ok=bool(ok))
            if name == "viterbi":
                scratch, old = viterbi_scratch(b, t, n)
                line.update(
                    plan=(hk.viterbi_block_plan(b, t, n, TRAIN_W)
                          if hasattr(hk, "viterbi_block_plan")
                          else "not in this checkout"),
                    scratch_bytes=scratch, uint8_scratch_bytes=old,
                    bit_equal_to_plain=all(torch.equal(g, w_)
                                           for g, w_ in zip(got, want)),
                    digest={f: digest(v) for f, v in
                            zip(("score", "path", "delta"), got)})
            else:
                lattice = got[0] if name == "forward" else got
                line.update(
                    plan=(hk.block_plan(b, n, TRAIN_W, name == "forward")
                          if hasattr(hk, "block_plan")
                          else "not in this checkout"),
                    digest=digest(lattice),
                    loglik_digest=(digest(got[1]) if name == "forward"
                                   else None))
                del lattice
            line.update(ms=median_ms(kernel, reps=11),
                        device_ms=kernel_device_ms(kernel, name, reps=10),
                        ms_b1=median_ms(kernel1, reps=11),
                        device_ms_b1=kernel_device_ms(kernel1, name,
                                                      reps=10),
                        plain_ms=median_ms(plain, reps=3),
                        **hmm_bound(name, b, t, n, TRAIN_W))
            del got, want
            say("hmm_block_route", **line)
            out[name].append(line)
        del band, log_pi, log_b, masks, full, first
        torch.cuda.empty_cache()
    return out


# The cluster-size sweep's shapes: BLOCK_SHAPES, N = 8,402 at B = 64 and
# 16, N = 3,002 at B = 32, N = 1,100 at B = 128, and B = 1 at 266, 1,100
# and 8,402 (T = 319); Viterbi also at VITERBI_LONG.
SWEEP_SHAPES = BLOCK_SHAPES + ((64, 2800), (16, 2800), (32, 1000),
                               (128, 366), (1, 88), (1, 366), (1, 2800))

# The sweep's library also reports every cluster size's shape.
SWEEP_SIZES = """
extern "C" int hmm_sweep_sizes(int N, int W, int dir, int* out) {
  BlockShapes s;
  const cudaError_t rc =
      dir == VITERBI  ? block_shapes_for(VITERBI_BLOCK, VITERBI, N, W, &s)
      : dir == FORWARD ? block_shapes_for(FORWARD_BLOCK, FORWARD, N, W, &s)
                       : block_shapes_for(BACKWARD_BLOCK, BACKWARD, N, W, &s);
  for (int i = 0; i < MAX_CLUSTER; ++i) {
    const BlockShape& p = s.by_size[i];
    int* o = out + 6 * i;
    o[0] = p.cs;
    o[1] = p.cs ? BLOCK_K[p.kidx] : 0;
    o[2] = p.warps;
    o[3] = (int)p.smem;
    o[4] = p.active;
    o[5] = p.spread;
  }
  return (int)rc;
}
"""


def sweep_library():
    """``hmm_banded.cu`` built once more with three globals that override
    the block route's choices (a cluster size; the runtime band width's
    instantiations at every W; Viterbi without its backtrace walk), for
    :func:`phase_block_sweep` alone: the library the port loads has
    none."""
    import ctypes

    src = (build.CSRC / "hmm_banded.cu").read_text()
    swaps = [("  *out = block_choose(s, B, N);",
              "  *out = hmm_force_cluster ? s.by_size[hmm_force_cluster - 1]"
              " : block_choose(s, B, N);"),
             ("int block_w_index(int W) {\n",
              "int block_w_index(int W) {\n  if (hmm_force_runtime_w) "
              "return 0;\n"),
             # the walk's switch rides on end_states' bit 30 (a host global
             # is not seen by the device; the skipped walk's outputs are
             # not compared)
             ("  if (!walker) return;",
              "  if (!walker || (end_states >> 30)) return;"),
             ("                      delta_last, T, N, W, end_states);",
              "                      delta_last, T, N, W,\n"
              "                      end_states | (hmm_skip_walk << 30));")]
    for old, new in swaps:
        check(src.count(old) == 1, f"sweep swap applies once: {old!r}")
        src = src.replace(old, new)
    src = ('extern "C" { int hmm_force_cluster = 0; '
           'int hmm_force_runtime_w = 0; int hmm_skip_walk = 0; }\n' + src
           + SWEEP_SIZES)
    out_dir = build.BUILD_DIR / "block_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "hmm_banded_sweep.cu", out_dir / "libhmm_sweep.so"
    cu.write_text(src)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    check(proc.returncode == 0, f"sweep build: {proc.stderr[-2000:]}")
    lib = hk.bind(ctypes.CDLL(str(so)))
    return lib, {name: ctypes.c_int.in_dll(lib, f"hmm_{name}")
                 for name in ("force_cluster", "force_runtime_w",
                              "skip_walk")}


def phase_block_sweep(seed: int, smi: str) -> None:
    """The block route at SWEEP_SHAPES (forward, backward and Viterbi) and
    VITERBI_LONG (Viterbi) on every cluster size it takes there, forced
    (sizes in ascending order, then in descending), kernel alone, beside
    the size the plan picks; at the planned size, the runtime band width's
    instantiation against W = 5's (template, runtime, runtime, template),
    and Viterbi with its backtrace walk and without (with, without,
    without, with: the walk's share of the kernel).  Every forced launch
    gives outputs equal bit for bit to the planned launch's."""
    import ctypes

    gen = torch.Generator().manual_seed(seed)
    lib, force = sweep_library()
    lib.hmm_sweep_sizes.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    port_lib = hk._lib
    hk._lib = lambda: lib
    shapes = [(b, TRAIN_T, max_l) for b, max_l in SWEEP_SHAPES]
    try:
        for b, t, max_l in shapes + [VITERBI_LONG]:
            # B = 1: the first of two (its frames all valid)
            band, log_pi, log_b, masks = (
                a[:b].contiguous()
                for a in dp_inputs(gen, max(b, 2), t, max_l))
            n = int(band.shape[1])
            calls = {
                "forward": lambda: hk.forward_banded_cuda(
                    band, log_pi, log_b, masks, TRAIN_W)[:1],
                "backward": lambda: (hk.backward_banded_cuda(
                    band, log_b, masks, TRAIN_W),),
                "viterbi": lambda: hk.viterbi_banded_cuda(
                    band, log_pi, log_b, masks, TRAIN_W)}
            dirs = {"forward": 1, "backward": 0, "viterbi": 2}
            names = ["viterbi"] if t != TRAIN_T else list(calls)
            for name in names:
                fn = calls[name]
                for v in force.values():
                    v.value = 0
                plan = (hk.viterbi_block_plan(b, t, n, TRAIN_W)
                        if name == "viterbi"
                        else hk.block_plan(b, n, TRAIN_W, name == "forward"))
                by_size = (ctypes.c_int * 96)()
                check(lib.hmm_sweep_sizes(n, TRAIN_W, dirs[name],
                                          by_size) == 0, "sweep sizes")
                sizes_shapes = {
                    by_size[6 * i]: dict(zip(hk.BLOCK_PLAN_FIELDS[1:],
                                             by_size[6 * i + 1:6 * i + 6]))
                    for i in range(16) if by_size[6 * i]}
                ref = fn()
                sizes = range(1, min(16, (n + 31) // 32) + 1)
                forced = {}

                def timed(cs, w0=0, skip=0):
                    force["force_cluster"].value = cs
                    force["force_runtime_w"].value = w0
                    force["skip_walk"].value = skip
                    try:
                        got = fn()
                    except RuntimeError as e:  # not taken at this size
                        return str(e).splitlines()[0][:60]
                    check(skip or all(torch.equal(g, r)
                                      for g, r in zip(got, ref)),
                          f"{name} at N = {n}, cluster {cs}, runtime W "
                          f"{w0}: equal bit for bit")
                    return kernel_device_ms(fn, name, reps=5)

                for order in (list(sizes), list(sizes)[::-1]):
                    for cs in order:
                        forced.setdefault(cs, []).append(timed(cs))
                ok = {cs: v for cs, v in forced.items()
                      if all(isinstance(x, float) for x in v)}
                best = min(ok, key=lambda cs: sum(ok[cs]))
                widths = {w0: [] for w0 in (0, 1)}
                for w0 in (0, 1, 1, 0):
                    widths[w0].append(timed(plan["cluster"], w0))
                walk = {}
                if name == "viterbi":
                    for skip in (0, 1, 1, 0):
                        walk.setdefault(skip, []).append(
                            timed(plan["cluster"], skip=skip))
                for v in force.values():
                    v.value = 0
                say("hmm_block_sweep", kernel=name, b=b, t=t, n_s=n,
                    w=TRAIN_W, plan=plan, sizes=sizes_shapes,
                    forced_ms=forced,
                    best_cluster=best, best_ms=ok[best],
                    planned_ms=ok.get(plan["cluster"]),
                    template_w_ms=widths[0], runtime_w_ms=widths[1],
                    **({"with_walk_ms": walk[0], "without_walk_ms": walk[1]}
                       if walk else {}),
                    nvidia_smi=smi)
                del ref
            del band, log_pi, log_b, masks
            torch.cuda.empty_cache()
    finally:
        hk._lib = port_lib


def training_path_launches(gen: torch.Generator, max_l: int) -> dict:
    """One E-step and one alignment of 16 x 4 s at labels of ``max_l``
    units on a random XIF bank, each DP kernel's launches counted from zero
    before them; finite logliks and alignment scores."""
    tcfg = train_config()
    tbank = sb.create_bank(len(UnitInventory.standard("XIF")), tcfg.model, D,
                           generator=gen, device="cuda")
    labels = torch.randint(0, tbank.num_units, (16, max_l),
                           generator=gen).cuda()
    lens = torch.full((16,), max_l, dtype=torch.int32).cuda()
    xs = (torch.randn(16, TRAIN_T, D, generator=gen) * 2).cuda()
    tm = torch.ones(16, TRAIN_T, dtype=torch.bool, device="cuda")
    reset_kernel_counts()
    stats, _ = acc.batch_stats(tbank, labels, lens, xs, tm, 5, max_l)
    sc, _ = align.align_batch(tbank, labels, lens, xs, tm, 5, max_l)
    check(bool(torch.isfinite(stats.loglik).all())
          and bool(torch.isfinite(sc).all()),
          f"finite logliks and alignment scores at L = {max_l}")
    launches = {k: f.launches for k, f in hk.KERNELS.items()}
    check(all(v > 0 for v in launches.values()),
          f"the training path at L = {max_l} ran every DP kernel: "
          f"{launches}")
    return launches


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
    DP kernels', the sentence kernel's and the statistics kernel's
    launches in the timed run."""
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
    gk.sentence_scores_cuda.launches = 0
    gk.sentence_stats_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank, total = bank0, 0.0
    for _ in range(epochs):
        bank, probe = one_epoch(bank)
        total = total + probe
    total = float(total)  # synchronises every epoch's work
    elapsed = time.perf_counter() - t0
    launches = {k: f.launches for k, f in hk.KERNELS.items()}
    launches["sentence"] = gk.sentence_scores_cuda.launches
    launches["stats"] = gk.sentence_stats_cuda.launches
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


def phase_stream(seed: int, smi: str) -> int:
    """Streaming decode at the decode width (XIF_tone, 606 senones, 8
    mixtures, 39 dims, built-in lexicon): eight ``ServiceStream`` sessions
    of one 4 s utterance each, fed 25-frame chunks at the rate the audio
    arrives, then one lockstep session of all eight; every final n-best
    against the one-shot decode on the card.  Then the chunk advance alone
    (host clock after a synchronise), its device profile, and the GMM
    kernel against its plain version at one chunk (T = 25) and a lockstep
    chunk (T = 200); then the first ``stream_result`` of a fresh process
    (:func:`first_stream_result`, a subprocess) beside its warm ones.
    Returns the frame-scan and n-best kernels' launches of the sessions."""
    phase_t0 = time.perf_counter()
    dec, cfg = full_width_decoder(seed, "cuda")
    feats = speech_features(seed, cfg, STREAMS, 4.0)
    chunk_s = CHUNK * cfg.frontend.frame_step / cfg.frontend.sample_rate
    cap = [-(-len(f) // CHUNK) * CHUNK for f in feats]
    n_min = min(len(f) for f in feats)
    lock = np.stack([f[:n_min] for f in feats])

    reset_kernel_counts()
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
    scan_launches = dk.decoder_scan_cuda.launches
    fin_launches = dk.decoder_finalize_cuda.launches
    latency = [done_at[i] - last_feed[i] for i in range(STREAMS)]
    check(launches > 0, "the stream path launched the GMM kernel")
    check(scan_launches == stats.stream_chunks,
          f"one frame-scan launch per chunk ({scan_launches} for "
          f"{stats.stream_chunks} chunks)")
    check(fin_launches == STREAMS + 1, f"one n-best launch per stream "
          f"result ({fin_launches} for {STREAMS + 1} results)")

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
    _, result_host_ms = synced_ms(lambda: dec.stream_result(st), reps=5)
    result_profile = device_profile(lambda: dec.stream_result(st))
    fresh = json.loads(subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--first-result",
         "--seed", str(seed)], capture_output=True, text=True, check=True,
        timeout=300).stdout.strip().splitlines()[-1])

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

        # the product alone, [T, 2D] x [2D, S·M] in f32 (as phase_kernel)
        xa = torch.randn(t, 2 * D, device="cuda")
        w = torch.randn(2 * D, S * M, device="cuda")

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
            library_ms=loop_ms(lambda: torch.matmul(xa, w)),
            library_call="torch.matmul, the product alone",
            **gmm_bound(t, S, M, D, "float32"))
    say("stream", sessions=STREAMS, chunk_frames=CHUNK,
        chunk_audio_seconds=chunk_s, utt_seconds=4.0,
        kept_frames=[len(f) for f in feats], lexicon_nodes=int(
            dec.lexicon.n_nodes),
        live_chunks=live_chunks, all_chunks=stats.stream_chunks,
        lockstep_frames=n_min,
        kernel_launches=launches, scan_kernel_launches=scan_launches,
        gmm_launches_per_chunk=launches / stats.stream_chunks,
        chunk_advance_ms=dict(p50=pct(one_ms, 50), p90=pct(one_ms, 90)),
        lockstep_chunk_advance_ms=dict(p50=pct(lock_ms, 50),
                                       p90=pct(lock_ms, 90)),
        real_time_factor=pct(one_ms, 50) / 1e3 / chunk_s,
        lockstep_real_time_factor=pct(lock_ms, 50) / 1e3 / chunk_s / STREAMS,
        final_result_latency_ms=dict(p50=pct(latency, 50) * 1e3,
                                     p90=pct(latency, 90) * 1e3),
        finalize_kernel_launches=fin_launches,
        stream_result_ms=result_ms, stream_result_host_ms=result_host_ms,
        stream_result_profile=result_profile,
        fresh_process_stream_result=fresh, chunk_profile=chunk_profile,
        one_best=["".join(f[0].words) for f in finals],
        phase_seconds=time.perf_counter() - phase_t0,
        device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    return dict(scan=scan_launches, fin=fin_launches)


def first_stream_result(seed: int) -> None:
    """Run in a fresh process by ``phase_stream``: one 4 s utterance
    streamed in 25-frame chunks at the decode width, then the host ms of
    its first ``stream_result`` (every kernel the result runs loads on
    first use) and of five warm ones; prints one JSON line."""
    dec, cfg = full_width_decoder(seed, "cuda")
    x = speech_features(seed, cfg, 1, 4.0)[0]
    st = dec.stream_init(batch=1, max_frames=-(-len(x) // CHUNK) * CHUNK)
    for lo in range(0, len(x), CHUNK):
        dec.stream_feed(st, x[lo:lo + CHUNK])
    first, first_ms = synced_ms(lambda: dec.stream_result(st, 2))
    _, warm_ms = synced_ms(lambda: dec.stream_result(st, 2), reps=5)
    check(len(first) == 1 and len(first[0]) >= 1, "a fresh process's "
          "stream result holds a hypothesis")
    print(json.dumps(dict(first_ms=first_ms, warm_ms_median_of_5=warm_ms,
                          chunks=len(st.tb_prev),
                          finalize_kernel_launches=dk.decoder_finalize_cuda
                          .launches)), flush=True)


def pruned_bound(dec: DeviceBeamDecoder, b: int, t_c: int,
                 frames: int) -> dict:
    """The block-pruned scan's least time: of the scores ``[B, Tc, S]`` only
    the senones the lexicon's emitting states name, on this run's
    ``frames`` valid frames, and ``n_valid`` read once; the compact carry
    (``kb`` int64 ``[B, K]``, deltas float32 and ctx int32 ``[B, K, blk,
    Ns]``) and the entry row (score and ctx, ``[B, N]``) read and written
    once; the rows ``[B, Tc]`` written once; the tables (bands, senones,
    parents, root flags, slots, block slot ranges) read once.  Operations a
    valid frame, as the lookahead needs them: each distinct senone row's
    max (G Ns: the nodes share ~100 rows, ``senone_groups``), entry +
    la and its block max (2 N), the K active blocks' ``max_s d + la`` and
    its max (K blk (Ns + 1)), the top K over the blocks (K n_blocks), the
    advance ((2W + 4) a token state of the K blocks) and the entry
    refresh's compare (N); the emission's compares over the active blocks'
    slots (about K blk a frame) are left out.  Each counts as one float32
    operation (:func:`bound_ms`).  Bytes are the elements' own.
    ``lookahead_traffic_ms``: the plain loop's lookahead as it is built,
    ``[B, N, Ns]`` float32 written and read back every frame."""
    tabs = dec._prep_device()
    n, n_s, w = tabs.bands.shape
    q = int(tabs.node_slot.shape[0])
    k, blk = dec.active_blocks, dec.block_size
    n_groups = int(torch.unique(torch.where(tabs.emitting, tabs.senone, -1),
                                dim=0).shape[0])
    n_sen = int(torch.unique(tabs.senone[tabs.emitting]).numel())
    n_bytes = (4 * frames * n_sen + 4 * b + 2 * 8 * b * k
               + 2 * 8 * b * k * blk * n_s + 2 * 8 * b * n + 8 * b * t_c
               + 4 * n * n_s * (w + 1) + 5 * n + 9 * q + 4 * (n // blk + 1))
    ops = (n_groups * n_s + 3 * n + k * (n // blk) + k * blk * (n_s + 1)
           + k * blk * n_s * (2 * w + 4))
    out = bound_ms(n_bytes, frames * ops, "float32")
    out.update(senones_read=n_sen, senone_groups=n_groups,
               table_groups=dk.n_groups(tabs), ops_per_frame=ops)
    out["lookahead_traffic_ms"] = frames * n * n_s * 8 / PEAK_BYTES_S * 1e3
    return out


def pruned_case(dec: DeviceBeamDecoder, scores, n_valid, t0: int = 0,
                carry=None, reps: int = 5) -> dict:
    """The pruned scan kernel (``dec._scan`` on the card) against its plain
    loop (``dec._scan_plain`` with ``_step_pruned``) on the same scores and
    carry: ``kb``, the compact carry, the entry row and the traceback rows
    must be equal bit for bit, or this raises.  ``ms``: one event pair
    around a wrapper call (median of ``reps``); ``kernel_ms``: the kernel
    alone under the profiler; ``plain_ms``: host ms of the plain loop,
    synchronised; ``plain_peak_mem_bytes`` / ``peak_mem_bytes``: the device
    memory each call peaks at above what was allocated before it;
    ``phase_cycles_utt0``: the first utterance's SM cycles in each of the
    kernel's phases (one more launch, with ``phase_clocks``)."""
    tabs = dec._prep_device()
    b, t_c, s = scores.shape
    if carry is None:
        carry = dec._seed(tabs, b)

    def kernel():
        return dec._scan(tabs, carry, scores, t0, n_valid)

    def plain():
        return dec._scan_plain(tabs, carry, scores, t0, n_valid)

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    before = dk.decoder_scan_pruned_cuda.launches
    got, kernel_peak = peak(kernel)
    want, plain_peak = peak(plain)
    names = ("kb", "d_act", "c_act", "entry", "entry_ctx")
    pairs = {**{k: (g, w) for k, g, w in zip(names, got[0], want[0])},
             "tb_prev": (got[1], want[1]), "tb_word": (got[2], want[2])}
    equal = {k: bool(torch.equal(a, b)) for k, (a, b) in pairs.items()}
    n, n_s, _ = tabs.bands.shape
    k = dec.active_blocks
    line = dict(b=b, t_c=t_c, t0=t0, n_nodes=n, n_s=n_s, s=s,
                block_size=dec.block_size, active_blocks=k,
                prune_hysteresis=dec.prune_hysteresis,
                n_blocks=dec._n_blocks, lm="none" if dec.lm is None else
                "sparse" if tabs.lm_sparse is not None else "flat",
                placement=dk.tables_placement(tabs, s, k, dec.block_size,
                                              dec._r_top(tabs)),
                equal=equal, max_abs_err=max(
                    float((got[0][i] - want[0][i]).abs().max())
                    for i in (1, 3)),
                words_emitted=int((got[2] >= 0).sum()),
                peak_mem_bytes=kernel_peak, plain_peak_mem_bytes=plain_peak)
    check(all(equal.values()), f"pruned scan kernel vs plain loop: {line}")
    del got, want
    line.update(ms=median_ms(kernel, reps=reps),
                kernel_ms=kernel_device_ms(kernel, "decoder_pruned", reps=5),
                plain_ms=synced_ms(plain)[1], library_ms=None,
                **pruned_bound(dec, b, t_c,
                               int(np.clip(np.asarray(n_valid), 0,
                                           t_c).sum())))
    # where a frame goes: the first utterance's SM cycles in each phase
    clocks = torch.zeros(len(dk.PRUNED_PHASES), dtype=torch.int64,
                         device=scores.device)
    dk.decoder_scan_pruned_cuda(
        tabs, carry, scores, t0, n_valid, n_vocab=dec._n_vocab,
        r_top=dec._r_top(tabs), penalty=-float(dec.word_penalty),
        block_size=dec.block_size, hysteresis=dec.prune_hysteresis,
        phase_clocks=clocks)
    cycles = clocks.cpu().tolist()
    line["phase_cycles_utt0"] = dict(zip(dk.PRUNED_PHASES, cycles))
    line["phase_share_utt0"] = {k: c / max(1, sum(cycles)) for k, c in
                                zip(dk.PRUNED_PHASES, cycles)}
    line["launches"] = dk.decoder_scan_pruned_cuda.launches - before
    return line


def selection_changes(dec: DeviceBeamDecoder, scores, n_valid) -> int:
    """The (utterance, frame) pairs of the plain loop (``_scan_plain``) whose
    step changes the set of active blocks, over the valid frames."""
    tabs = dec._prep_device()
    step, changes = dec._step_pruned, []

    def recorder(tabs, carry, frame_scores, ti, active):
        out = step(tabs, carry, frame_scores, ti, active)
        old = torch.sort(carry[0], dim=1).values
        new = torch.sort(out[0][0], dim=1).values
        changes.append(((old != new).any(dim=1) & active).sum())
        return out
    dec._step_pruned = recorder
    try:
        dec._scan_plain(tabs, dec._seed(tabs, scores.shape[0]), scores, 0,
                        n_valid)
    finally:
        del dec._step_pruned
    return int(torch.stack(changes).sum())


# the sticky selection's bonus in the pruned cell: the value
# benchmarks/pruned_trained.py runs
PRUNE_HYST = 8.0


def phase_pruned(seed: int, smi: str, batch: int = 256,
                 utt_seconds: float = 4.0) -> dict:
    """Block-pruned search at the decode batch (bench.py's 256 x 4 s of
    noise through the frontend) over the synthetic ~21.6k-node lexicon
    standing in for Mandarin.dat: exact, then block_size 256 with 8 and 4
    active blocks, and 8 with the sticky selection (``prune_hysteresis``
    8.0), each timed after a warm-up call and a synchronise, with
    its peak device memory and its launches (the exact call one frame-scan
    launch, a pruned call one pruned-scan launch, each one n-best launch);
    then the pruned scan kernel held to its plain loop at this cell, bit
    for bit, with its times (also at 8 blocks with a sparse bigram LM), and
    at k8 with and without the sticky selection the frames whose step
    changed the active set (the plain loop's); then one pruned stream
    session without and one with the sticky selection (one pruned launch a
    chunk) against the one-shot pruned decode.  Returns the
    frame-scan kernel's launches in the exact call, the pruned kernel's in
    the pruned calls and chunks, the n-best kernel's in the four calls,
    and the pruned kernel's ``kernels`` record (k8; k4 and k8 with the
    sticky selection beside it)."""
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

    runs, outs, cases = {}, {}, {}
    launches = dict(scan=0, pruned=0, fin=0)
    for name, kw in (("exact", {}),
                     ("k8", dict(block_size=256, active_blocks=8)),
                     ("k4", dict(block_size=256, active_blocks=4)),
                     ("k8_hyst8", dict(block_size=256, active_blocks=8,
                                       prune_hysteresis=PRUNE_HYST))):
        dec = DeviceBeamDecoder(bank, flat, **kw)
        t0 = time.perf_counter()
        dec._prep_device()
        prep_s = time.perf_counter() - t0
        check(dec._prune_on == bool(kw), f"{name}: pruning engaged as set")
        dec.decode_batch(feats, n_frames)                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        t0 = time.perf_counter()
        outs[name] = dec.decode_batch(feats, n_frames)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = kernel_counts()
        check(counts["gmm"] == 1,
              f"{name}: one GMM kernel launch per decode call")
        want = (0, 1) if kw else (1, 0)
        check((counts["scan"], counts["pruned"]) == want,
              f"{name}: frame-scan and pruned-scan launches "
              f"{(counts['scan'], counts['pruned'])}, expected {want}")
        check(counts["fin"] == 1,
              f"{name}: one n-best launch per decode call ({counts['fin']})")
        for key in launches:
            launches[key] += counts[key]
        check(all(len(h) >= 1 for h in outs[name]),
              f"{name}: every utterance decoded")
        runs[name] = dict(wall_ms=wall_ms, table_prep_seconds=prep_s,
                          peak_mem_bytes=torch.cuda.max_memory_allocated(),
                          blocks=getattr(dec, "_n_blocks", None),
                          scan_kernel_launches=counts["scan"],
                          pruned_kernel_launches=counts["pruned"],
                          finalize_kernel_launches=counts["fin"],
                          decode_call_profile=device_profile(
                              lambda: dec.decode_batch(feats, n_frames)))
        if kw:
            scores = dec._scores(feats)
            cases[name] = pruned_case(dec, scores, n_frames)
            if name != "k4":
                cases[name]["active_set_changes"] = selection_changes(
                    dec, scores, n_frames)
            del scores
        del dec
        torch.cuda.empty_cache()
    # the same scan with a sparse bigram LM over the lexicon's words (the
    # emission's 16 candidates, fewer finite ones where few blocks emit)
    from poccala_tpu_torch.lm.ngram import Ngram

    lm = Ngram(2)
    lm.train([list(rng.choice(words, size=8)) for _ in range(2000)])
    dec = DeviceBeamDecoder(bank, flat, lm=lm, lm_weight=3.0, word_penalty=1.0,
                            block_size=256, active_blocks=8)
    dec._prep_device()
    scores = dec._scores(feats)
    cases["k8_sparse_lm"] = pruned_case(dec, scores, n_frames, reps=3)
    del scores, dec
    torch.cuda.empty_cache()
    for name in ("k8", "k4", "k8_hyst8"):
        agree, worst = 0, 0.0
        for he, hp in zip(outs["exact"], outs[name]):
            agree += he[0].words == hp[0].words
            worst = max(worst, (hp[0].score - he[0].score) / abs(he[0].score))
        check(worst <= 1e-4, f"{name}: a pruned 1-best beat the exact one by "
              f"{worst} relative")
        runs[name].update(one_best_agreement=agree / batch,
                          max_rel_excess_over_exact=worst)

    # a pruned stream session of one utterance equals the pruned one-shot,
    # with one pruned-scan launch a chunk; then one with the sticky
    # selection (its active blocks ride the carry across chunks)
    x = feats[0, : int(n_frames[0])]
    for key, hyst in (("pruned_stream", 0.0), ("pruned_stream_hyst8",
                                                PRUNE_HYST)):
        dec = DeviceBeamDecoder(bank, flat, block_size=256, active_blocks=8,
                                prune_hysteresis=hyst)
        st = dec.stream_init(batch=1, max_frames=len(x))
        reset_kernel_counts()
        for lo in range(0, len(x), CHUNK):
            dec.stream_feed(st, x[lo:lo + CHUNK])
        chunks = len(st.tb_prev)
        stream_counts = kernel_counts()
        check((stream_counts["pruned"], stream_counts["scan"]) == (chunks, 0),
              f"one pruned-scan launch a pruned stream chunk: "
              f"{stream_counts}, {chunks} chunks")
        launches[key] = stream_counts["pruned"]
        same_nbest(dec.stream_result(st, 2)[0], dec.decode_batch(
            x[None], [len(x)], 2)[0],
            f"pruned stream vs pruned one-shot (hysteresis {hyst})")
    for name, line in cases.items():
        say("pruned_scan", case=name, **line)
    say("pruned", lexicon_nodes=int(flat.n_nodes), words=len(words),
        lexicon_build_seconds=lex_s, batch=batch, utt_seconds=utt_seconds,
        frames=int(feats.shape[1]), block_size=256, runs=runs,
        stream_equals_one_shot=True, stream_chunks=chunks,
        source=dk.SOURCE, replaces=dk.PRUNED_REPLACES,
        phase_seconds=time.perf_counter() - phase_t0,
        device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    line = cases["k8"]
    launches["record"] = {k: line[k] for k in (
        "max_abs_err", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "lookahead_traffic_ms")}
    launches["record_k4"] = {k: cases["k4"][k] for k in (
        "ms", "kernel_ms", "plain_ms", "bound_ms")}
    launches["record_hyst8"] = {k: cases["k8_hyst8"][k] for k in (
        "prune_hysteresis", "max_abs_err", "ms", "kernel_ms", "plain_ms",
        "bound_ms", "active_set_changes")}
    launches["record"]["active_set_changes"] = cases["k8"][
        "active_set_changes"]
    return launches


# forward_log_assoc's cases (N, T, label budget): the training cell's
# sentence HMM made dense (N = 50, W = 5) over 4 s, and the default label
# budget's (N = 98) over 20 s and 200 s of frames; then random finite
# operators with no dead entry (dense log_A and log_pi, N = 98, T = 1,600),
# where the kernels skip nothing; then labels of 40 and 48 units (N = 122,
# where one product's operands and result fill a CTA's shared memory
# alone, and N = 146, past it: the k-tiled route) over 20 s
ASSOC_CASES = ((50, TRAIN_T, TRAIN_L), (98, 1600, 32), (98, 16000, 32),
               (98, 1600, None), (122, 1600, 40), (146, 1600, 48))
# finite log_alpha within ASSOC_TOL of max(|value|, 1) and loglik at rtol
# ASSOC_TOL: the card against the plain version and against float64
# (tests/test_torch_assoc.py's tolerance against JAX)
ASSOC_TOL = 1e-5


def assoc_seq_tol(t: int) -> float:
    """The tolerance against the sequential banded kernel: its float32
    recursion rounds the running log-likelihood once a step, so it may
    drift from float64 by up to ~T·2⁻²⁴ relative (measured ~1e-4 at T =
    16,000 with the plain banded forward on the CPU: 8.3 nats of 80,787,
    where the scan's tree of products drifted 0.0017); twice that, plus
    ASSOC_TOL."""
    return 2 * t * 2.0 ** -24 + ASSOC_TOL

# an exponential a cycle per SM quarter: 16 a cycle an SM on Hopper's SFUs,
# at the H100 SXM's 1,980 MHz boost clock
EXP_RATE = 132 * 16 * 1.98e9


def assoc_products(t: int) -> list:
    """The batch size P of each product launch of the scan over T - 1
    operators, in launch order (``ops.hmm._assoc_scan_into``)."""
    out, n = [], t - 1
    while n >= 2:
        out.append(n // 2)
        out.append(n // 2 - 1 if n % 2 == 0 else n // 2)
        n //= 2
    return [p for p in out if p > 0]


def assoc_bound(t: int, n: int) -> dict:
    """The least time of one ``forward_log_assoc`` call's kernels: each
    product of N x N matrices needs N³ terms of an add, a max, a
    subtraction, an exponential and a sum add (5 N³ float32 operations) and
    moves its two operands and its result once (3 N² floats); the tail
    (T - 1 rows through a product) 5 (T - 1) N² operations and its
    operators, alpha_0 and its rows once.  The published 67 TFLOP/s counts
    every operation alike; the card's exponentials run at 16 a cycle an SM
    (``exp_floor_ms``, ~4.2 T/s), far below it."""
    ps = assoc_products(t)
    prod_ops = 5 * sum(ps) * n ** 3
    prod_bytes = 4 * 3 * sum(ps) * n * n
    rows_ops = 5 * (t - 1) * n * n
    rows_bytes = 4 * ((t - 1) * n * n + n + (t - 1) * n)
    return dict(product=dict(**bound_ms(prod_bytes, prod_ops, "float32"),
                             exp_floor_ms=sum(ps) * n ** 3 / EXP_RATE * 1e3,
                             products=len(ps), matrices=sum(ps)),
                rows=dict(**bound_ms(rows_bytes, rows_ops, "float32"),
                          exp_floor_ms=(t - 1) * n * n / EXP_RATE * 1e3))


def assoc_live_bound(log_a, log_pi, log_b) -> dict:
    """:func:`assoc_bound` counted on what this case's operands need: the
    terms whose two operands are live (above NEG_INF) in each product of
    the call's scan, counted with boolean products on the card through the
    same recursion (``ops.hmm._assoc_scan_into``), 5 operations each; the
    tail's terms of alpha_0's live entries; the bytes as in the dense bound
    (every operand is read, for its live entries and its NaN)."""
    t, n = log_b.shape
    live = (log_a[None] + log_b[1:, None, :] > -1e30).float()
    terms = []

    def product(x, y, out):
        terms.append(float((x.sum(-2).double() * y.sum(-1).double()).sum()))
        out.copy_(torch.bmm(x, y) > 0)

    prefix = torch.empty_like(live)
    hmm_ops._assoc_scan_into(live, prefix, product)
    a_live = (log_pi + log_b[0] > -1e30).double()
    rows_terms = float((prefix.sum(-1).double() @ a_live).sum())
    prod_terms = sum(terms)
    prod_bytes = 4 * 3 * sum(assoc_products(t)) * n * n
    rows_bytes = 4 * ((t - 1) * n * n + n + (t - 1) * n)
    del live, prefix
    return dict(product=dict(**bound_ms(prod_bytes, 5 * prod_terms,
                                        "float32"),
                             exp_floor_ms=prod_terms / EXP_RATE * 1e3,
                             live_terms=prod_terms),
                rows=dict(**bound_ms(rows_bytes, 5 * rows_terms, "float32"),
                          exp_floor_ms=rows_terms / EXP_RATE * 1e3,
                          live_terms=rows_terms,
                          alpha0_live=int(a_live.sum())))


def call_device_ms(fn, launches: tuple, reps: int = 3) -> dict:
    """Device time per call of ``fn`` under ``torch.profiler`` (``reps``
    calls after a warm-up): the semiring product's launches (``product``),
    the row kernel's (``rows``), every device event (``busy``), from the
    first of three profiles that kept every launch (``launches``: the
    product's and the row kernel's a call); "not measured" where none did.
    ``events``: the launches each profile kept a call.  Inside the whole
    script a profile loses some launches to the next one, so a count can
    match without its events being the profile's own: :func:`graph_ms`
    is the figure, this one beside it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    kept = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]

        def total(key, what="self_device_time_total"):
            return sum(getattr(e, what) for e in events
                       if key in e.key) / reps

        kept.append((total("lse_product", "count"),
                     total("lse_rows", "count")))
        if kept[-1] == tuple(launches):
            return dict(product=total("lse_product") / 1e3,
                        rows=total("lse_rows") / 1e3,
                        busy=total("") / 1e3, events=kept)
    return dict.fromkeys(("product", "rows", "busy"), "not measured") | dict(
        events=kept)


def graph_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of one replay of ``fn`` captured in a CUDA
    graph (after a warm-up call): its kernels back to back, without the
    host's launch gaps.  The graph's memory is given back after."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    out = median_ms(graph.replay, reps)
    del graph
    torch.cuda.empty_cache()
    return out


def build_assoc_variants() -> dict:
    """Two other builds of ``hmm_assoc.cu``'s C interface, built as the
    port's sources are (both at once) into
    ``build/poccala_tpu_torch/assoc_<name>/``, for the ``assoc`` phase's
    comparisons alone: ``parent``, the dense kernels that the live-range
    kernels replaced (``tests/cuda_emu/hmm_assoc_parent.cu``, which they
    equal bit for bit); ``tiled``, ``csrc/hmm_assoc.cu`` with
    ``SMEM_LIMIT`` 0, every product on the k-tiled route.  name ->
    ``(product, rows)``: the port's wrappers on that library, their
    launches not counted."""
    import ctypes
    import functools

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "tests", "cuda_emu",
                           "hmm_assoc_parent.cu")) as f:
        parent = f.read()
    tiled, n = re.subn(r"constexpr int SMEM_LIMIT = [^;]*;",
                       "constexpr int SMEM_LIMIT = 0;",
                       (build.CSRC / "hmm_assoc.cu").read_text())
    check(n == 1, "hmm_assoc.cu declares SMEM_LIMIT once")
    procs = {}
    for name, src in (("parent", parent), ("tiled", tiled)):
        out_dir = build.BUILD_DIR / f"assoc_{name}"
        out_dir.mkdir(parents=True, exist_ok=True)
        cu, so = out_dir / f"hmm_assoc_{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(src)
        procs[name] = so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        check(proc.returncode == 0, f"{name} build: {err[-2000:]}")
        lib = ak.bind(ctypes.CDLL(str(so)))
        out[name] = (functools.partial(ak.lse_product_cuda, lib=lib),
                     functools.partial(ak.lse_rows_cuda, lib=lib))
    return out


class SmClock:
    """The card's SM clock (MHz) as ``nvidia-smi`` reads it every 20 ms
    while a block runs: ``with SmClock() as clock: ...``, then
    ``clock.mhz``, the readings taken inside the block (the first one
    waited for before it starts)."""

    def __enter__(self):
        import threading

        self.readings = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        t0 = time.time()
        while (not self.readings and self.proc.poll() is None
               and time.time() - t0 < 10):
            time.sleep(0.005)
        self.first = len(self.readings)
        return self

    def _read(self) -> None:
        for line in self.proc.stdout:
            try:
                self.readings.append(float(line.strip()))
            except ValueError:
                pass

    def __exit__(self, *exc) -> None:
        last = len(self.readings)
        self.proc.terminate()
        self.proc.wait(timeout=10)
        self.reader.join(timeout=10)
        self.mhz = self.readings[self.first:last]


def alpha_error(got, want) -> tuple[float, bool]:
    """The largest error of finite log_alpha over max(|value|, 1), and
    whether the finite masks are equal."""
    got, want = got.double().cpu(), want.double().cpu()
    fin = want > -1e30 / 2
    same = bool(torch.equal(got > -1e30 / 2, fin))
    err = ((got - want).abs()[fin] / want.abs()[fin].clamp(min=1.0))
    return float(err.max()) if err.numel() else 0.0, same


def assoc_case(gen, n_want: int, t: int, max_l):
    """A case's operators: one utterance's sentence HMM from the training
    path's operands (``dp_inputs``: labels of up to ``max_l`` units, log_b
    from a random XIF bank), its band made dense (NEG_INF off it); or, at
    ``max_l = None``, random finite log_A, log_pi and log_b (no dead
    entry).  Returns (band or None, log_A, log_pi, log_b)."""
    if max_l is None:
        a = torch.rand(n_want, n_want, generator=gen) * 0.9 + 0.1
        pi = torch.rand(n_want, generator=gen) * 0.9 + 0.1
        log_b = torch.randn(t, n_want, generator=gen) * 3 - 5
        return (None, (a / a.sum(1, keepdim=True)).log().cuda(),
                (pi / pi.sum()).log().cuda(), log_b.cuda())
    band, log_pi, log_b, _ = dp_inputs(gen, 2, t, max_l)
    band, log_pi, log_b = band[0], log_pi[0], log_b[0].contiguous()
    check(band.shape[0] == n_want,
          f"assoc: {band.shape[0]} sentence states, expected {n_want}")
    return band, hmm_ops.band_to_dense(band), log_pi, log_b


def phase_assoc(seed: int, smi: str) -> dict:
    """``forward_log_assoc`` (``ops/hmm.py``, JAX's time-parallel forward)
    on the card at ASSOC_CASES (:func:`assoc_case`).  Each call is driven
    with the counts at 0 just before it and read just after (the product
    kernel once a level's products, the row kernel once).  Held to float64
    (the plain banded forward, or the dense forward for the dense case, on
    the CPU) within ASSOC_TOL, to the sequential banded kernel
    (``forward_log_banded``) within :func:`assoc_seq_tol`, where the plain
    version's sums fit (T <= 1,600) to it within ASSOC_TOL, and bit for bit
    (``torch.equal``, and a digest of log_alpha) to the dense kernels they
    replaced and to the k-tiled route alone (:func:`build_assoc_variants`).
    Times: one event pair around a call (``ms``), each kernel alone per
    call replayed from a CUDA graph (:func:`graph_ms`: the scan's products
    alone, the tail alone) and under the profiler where every profile kept
    every launch (:func:`call_device_ms`; ``profiled_*``), in turns (parent,
    change, tiled, tiled, change, parent) with the card's SM clock read
    during each (:class:`SmClock`); the call's split (operator build,
    products, tail, the rest), the sequential kernel alone, the plain
    version and its scan of products and tail alone (each kernel's plain
    version) where it runs; the live-term
    bounds (:func:`assoc_live_bound`, the record's ``bound_ms``) and the
    dense bounds (:func:`assoc_bound`), each kernel's share of both.
    Returns the two kernels' ``kernels`` records (at N = 98, T = 1,600)
    with their launches."""
    gen = torch.Generator().manual_seed(seed)
    variants = build_assoc_variants()
    lines = []
    for n_want, t, max_l in ASSOC_CASES:
        band, log_a, log_pi, log_b = assoc_case(gen, n_want, t, max_l)
        n = n_want
        mask = torch.ones(t, dtype=torch.bool, device="cuda")

        def call():
            return hmm_ops.forward_log_assoc(log_a, log_pi, log_b)

        def variant_call(name):
            return lambda: hmm_ops._forward_assoc(log_a, log_pi, log_b,
                                                  *variants[name])

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        got_a, got_ll = call()
        torch.cuda.synchronize()
        counts = kernel_counts()
        peak = torch.cuda.max_memory_allocated() - base
        products = assoc_products(t)
        check((counts["product"], counts["rows"]) == (len(products), 1),
              f"assoc N={n} T={t}: launches {counts}, expected "
              f"{len(products)} products and 1 row launch")
        check(bool(torch.isfinite(got_a).all()) and got_a.shape == (t, n),
              f"assoc N={n} T={t}: finite log_alpha of shape (T, N)")
        par_a, par_ll = variant_call("parent")()
        til_a, til_ll = variant_call("tiled")()
        same_parent = bool(torch.equal(got_a, par_a)
                           and torch.equal(got_ll, par_ll))
        same_tiled = bool(torch.equal(got_a, til_a)
                          and torch.equal(got_ll, til_ll))
        if band is None:
            ref_a, ref_ll = hmm_ops.forward_log(
                log_a.double().cpu(), log_pi.double().cpu(),
                log_b.double().cpu(), mask.cpu())
            ref_a, ref_ll = ref_a[None], ref_ll[None]
        else:
            ref_a, ref_ll = hmm_ops.forward_log_banded_plain(
                band[None].double().cpu(), log_pi[None].double().cpu(),
                log_b[None].double().cpu(), mask[None].cpu(), TRAIN_W)
        err64, same64 = alpha_error(got_a, ref_a[0])
        ll64 = float(ref_ll[0])
        line = dict(
            case="dense" if band is None else "sentence",
            n_s=n, t=t, label_units=max_l, loglik=float(got_ll),
            loglik_float64=ll64,
            loglik_rel_err_float64=abs(float(got_ll) - ll64) / abs(ll64),
            alpha_err_float64=err64,
            launches_product=counts["product"], launches_rows=counts["rows"],
            digest=digest(got_a), parent_digest=digest(par_a),
            tiled_digest=digest(til_a), bit_equal_to_parent=same_parent,
            bit_equal_to_tiled=same_tiled,
            peak_mem_bytes=peak, operators_bytes=4 * (t - 1) * n * n,
            tol=dict(float64=ASSOC_TOL, sequential=assoc_seq_tol(t)))
        check(same_parent and line["digest"] == line["parent_digest"],
              f"assoc bit for bit the dense kernels': {line}")
        check(same_tiled and line["digest"] == line["tiled_digest"],
              f"assoc bit for bit the k-tiled route's: {line}")
        check(same64 and err64 <= ASSOC_TOL
              and line["loglik_rel_err_float64"] <= ASSOC_TOL,
              f"assoc vs float64: {line}")
        seq_a = None
        if band is not None:
            seq_a, seq_ll = hmm_ops.forward_log_banded(band, log_pi, log_b,
                                                       mask, TRAIN_W)
            err_seq, same_seq = alpha_error(got_a, seq_a)
            line.update(
                seq_loglik_rel_err_float64=abs(float(seq_ll) - ll64)
                / abs(ll64),
                seq_alpha_err_float64=alpha_error(seq_a, ref_a[0])[0],
                alpha_err_vs_seq=err_seq,
                loglik_rel_err_vs_seq=abs(float(got_ll) - float(seq_ll))
                / abs(float(seq_ll)))
            check(same_seq and err_seq <= assoc_seq_tol(t)
                  and line["loglik_rel_err_vs_seq"] <= assoc_seq_tol(t),
                  f"assoc vs the sequential kernel: {line}")
        if t <= 1600:
            plain = lambda: hmm_ops.forward_log_assoc_plain(   # noqa: E731
                log_a, log_pi, log_b)
            pl_a, pl_ll = plain()
            err_pl, same_pl = alpha_error(got_a, pl_a)
            line.update(alpha_err_vs_plain=err_pl,
                        loglik_rel_err_vs_plain=abs(
                            float(got_ll) - float(pl_ll)) / abs(float(pl_ll)),
                        max_abs_err=float((got_a - pl_a).abs().max()))
            check(same_pl and err_pl <= ASSOC_TOL
                  and line["loglik_rel_err_vs_plain"] <= ASSOC_TOL,
                  f"assoc kernel vs plain: {line}")
            del pl_a
            line["plain_ms"] = median_ms(plain, reps=3)
            # each kernel's plain version alone: the scan's products, and
            # the tail's rows through the prefix products
            ops = log_a[None] + log_b[1:, None, :]
            prefix = torch.empty_like(ops)
            alpha0 = log_pi + log_b[0]
            tail = torch.empty((t - 1, n), device="cuda")
            line["plain_product_ms"] = median_ms(
                lambda: hmm_ops._assoc_scan_into(
                    ops, prefix, hmm_ops._product_into_plain), reps=3)
            line["plain_rows_ms"] = median_ms(
                lambda: hmm_ops._rows_into_plain(alpha0, prefix, tail),
                reps=3)
            del ops, prefix
        else:
            line["plain_ms"] = ("not measured: the plain version's [P, N, N, "
                                "N] sums take ~30 GB")
        del got_a, par_a, til_a, seq_a, ref_a
        torch.cuda.empty_cache()
        # this, the parent kernels and the k-tiled route alone in turns:
        # parent, change, tiled, tiled, change, parent, the SM clock read
        # during each; each turn a call's wall time, the profiler's sums of
        # its launches, and the scan's products alone and the tail alone
        # replayed from a CUDA graph
        fns = {"parent": variant_call("parent"), "change": call,
               "tiled": variant_call("tiled")}
        kernels = {"parent": variants["parent"], "tiled": variants["tiled"],
                   "change": (ak.lse_product_cuda, ak.lse_rows_cuda)}
        ops = log_a[None] + log_b[1:, None, :]
        prefix = torch.empty_like(ops)
        alpha0 = log_pi + log_b[0]
        tail = torch.empty((t - 1, n), device="cuda")
        dev = {who: [] for who in fns}
        wall = {who: [] for who in fns}
        scan = {who: [] for who in fns}
        rows_ev = {who: [] for who in fns}
        clock = {who: [] for who in fns}
        for who in ("parent", "change", "tiled", "tiled", "change",
                    "parent"):
            product, rows = kernels[who]
            with SmClock() as sm:
                wall[who].append(median_ms(fns[who], reps=5))
                dev[who].append(call_device_ms(
                    fns[who], (len(products), 1)))
                scan[who].append(graph_ms(
                    lambda: hmm_ops._assoc_scan_into(ops, prefix, product)))
                rows_ev[who].append(graph_ms(
                    lambda: rows(alpha0, prefix, tail)))
            clock[who].append(float(np.median(sm.mhz)) if sm.mhz
                              else "not measured")
        del ops, prefix

        def mean(who, key):
            """The kernel alone: the mean of the graph replays."""
            return float(np.mean((scan if key == "product" else
                                  rows_ev)[who]))

        def profiled(who, key):
            """The profiler's mean where every turn's profile kept every
            launch (inside the whole script it may lose some)."""
            vals = [d[key] for d in dev[who]]
            return (sum(vals) / len(vals)
                    if all(isinstance(v, float) for v in vals)
                    else "not measured")

        ms = float(np.mean(wall["change"]))
        bound = assoc_bound(t, n)
        live = assoc_live_bound(log_a, log_pi, log_b)
        operators_ms = median_ms(lambda: log_a[None] + log_b[1:, None, :])
        line.update(
            ms=ms, ms_turns=wall["change"], parent_ms=float(
                np.mean(wall["parent"])), parent_ms_turns=wall["parent"],
            tiled_ms=float(np.mean(wall["tiled"])),
            product_kernel_ms=mean("change", "product"),
            rows_kernel_ms=mean("change", "rows"),
            parent_product_kernel_ms=mean("parent", "product"),
            parent_rows_kernel_ms=mean("parent", "rows"),
            tiled_product_kernel_ms=mean("tiled", "product"),
            profiled_ms={w: {k: profiled(w, k) for k in ("product", "rows")}
                         for w in dev},
            profiled_product_kernel_ms_turns={
                w: [d["product"] for d in dev[w]] for w in dev},
            profiled_launches_turns={w: [d["events"] for d in dev[w]]
                                     for w in dev},
            products_graph_ms_turns=scan, rows_graph_ms_turns=rows_ev,
            sm_clock_mhz_turns=clock, dense_bound=bound, live_bound=live,
            library_ms=None)
        for key, k_ms in (("product", line["product_kernel_ms"]),
                          ("rows", line["rows_kernel_ms"])):
            line[f"{key}_share_of_live_bound"] = live[key]["bound_ms"] / k_ms
            line[f"{key}_share_of_dense_bound"] = bound[key]["bound_ms"] / k_ms
        line["product_vs_parent"] = (line["product_kernel_ms"]
                                     / line["parent_product_kernel_ms"])
        line["product_vs_tiled"] = (line["product_kernel_ms"]
                                    / line["tiled_product_kernel_ms"])
        # the call's split: the operators' build (one elementwise launch,
        # alone), the products, the tail, and the rest of the call (the
        # level copies, the concatenation, the final logsumexp, allocation
        # and launch gaps); the device's busy time where the profiler kept
        # every launch
        busy = profiled("change", "busy")
        busy = busy if isinstance(busy, float) else None
        line["split_ms"] = dict(
            operators=operators_ms, products=line["product_kernel_ms"],
            tail=line["rows_kernel_ms"],
            rest=ms - operators_ms - line["product_kernel_ms"]
            - line["rows_kernel_ms"],
            device_busy="not measured" if busy is None else busy,
            device_idle="not measured" if busy is None else ms - busy)
        if band is not None:
            line["seq_kernel_ms"] = kernel_device_ms(
                lambda: hmm_ops.forward_log_banded(band, log_pi, log_b, mask,
                                                   TRAIN_W), "forward",
                reps=5)
        say("assoc", **line)
        lines.append(line)
    rec = next(v for v in lines if v["t"] == 1600 and v["n_s"] == 98
               and v["case"] == "sentence")
    out = {}
    for key, ms in (("product", "product_kernel_ms"),
                    ("rows", "rows_kernel_ms")):
        out[key] = dict(
            launches=rec[f"launches_{key}"], max_abs_err=rec["max_abs_err"],
            ms=rec[ms], profiled_ms=rec["profiled_ms"]["change"][key],
            parent_ms=rec[f"parent_{ms}"],
            plain_ms=rec[f"plain_{key}_ms"], plain_call_ms=rec["plain_ms"],
            bound_ms=rec["live_bound"][key]["bound_ms"],
            bound_by=rec["live_bound"][key]["bound_by"],
            dense_bound_ms=rec["dense_bound"][key]["bound_ms"],
            dense_bound_by=rec["dense_bound"][key]["bound_by"],
            exp_floor_ms=rec["live_bound"][key]["exp_floor_ms"],
            library_ms=None, n_s=rec["n_s"], t=rec["t"], call_ms=rec["ms"],
            other_cases=[{k: v[k] for k in ("case", "n_s", "t", "ms", ms,
                                            f"parent_{ms}",
                                            f"launches_{key}")}
                         | {"bound_ms": v["live_bound"][key]["bound_ms"],
                            "dense_bound_ms":
                                v["dense_bound"][key]["bound_ms"]}
                         for v in lines if v is not rec])
    say("assoc_summary", device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        ptxas_registers_spill_stores_loads=PTXAS.get("hmm_assoc", {}))
    return out


def phase_frontend_precision(seed: int, smi: str, batch: int = 256,
                             utt_seconds: float = 4.0) -> dict:
    """The frontend at each ``dot_precision`` on the decode cell's batch
    (256 x 4 s of speech-like audio): ms of one ``mfcc_batch`` call (median
    of 5, events) and the largest feature difference from 'highest', which
    the reduced precisions must show and keep finite."""
    cfg = Config()
    rate = cfg.frontend.sample_rate
    rng = np.random.default_rng(seed)
    signals = torch.as_tensor(np.stack(
        [synthetic_speech(rng, rate, utt_seconds) for _ in range(batch)]
    ).astype(np.float32), device="cuda")
    n_samp = torch.full((batch,), signals.shape[1], device="cuda")
    out, feats = {}, {}
    for precision in ("highest", "high", "default"):
        fcfg = Config().frontend
        fcfg.dot_precision = precision
        fe = Frontend(fcfg, device="cuda")
        feats[precision] = fe.mfcc_batch(signals, n_samp)[0]
        out[precision] = dict(ms=median_ms(
            lambda: fe.mfcc_batch(signals, n_samp), reps=5))
        if precision != "highest":
            diff = (feats[precision] - feats["highest"]).abs()
            out[precision]["max_abs_feature_err_vs_highest"] = float(
                diff.max())
            out[precision]["mean_abs_feature_err_vs_highest"] = float(
                diff.mean())
            check(bool(torch.isfinite(feats[precision]).all())
                  and float(diff.max()) > 0,
                  f"frontend at {precision}: finite and apart from "
                  f"'highest' ({out[precision]})")
    say("frontend_precision", batch=batch, utt_seconds=utt_seconds,
        frames=int(feats["highest"].shape[1]), tf32=bool(
            torch.backends.cuda.matmul.allow_tf32), runs=out,
        device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    return out


def phase_cli(seed: int) -> None:
    """``python -m poccala_tpu_torch.cli``, in process, on a 12-utterance
    synthetic corpus (6 units, 18 senones, 1 of 2 mixtures): with
    ``--device cuda`` synth-corpus, train (scheme 2, two rounds, CMVN),
    align, decode on every tier (``--decoder device``, no ``--decoder``:
    the default ``vector``, and ``--decoder simple``), listen --wav and
    serve over three WAVs, where listen's and serve's 1-best must equal
    the device tier's decode.  Then train, align and decode again with
    ``--device cpu``, the kernels' plain versions: the CPU's logliks from
    its own flat start within CLI_TRAIN_RTOL of the GPU's and, on the GPU's
    checkpoint, align's frames equal and each tier's n-best equal at 1e-4
    relative.  Last the GMM kernel against its plain version on the
    trained bank at the decode's frames."""
    import contextlib
    import io

    from poccala_tpu_torch import cli

    def run(device, *argv) -> list[dict]:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["--device", device, *argv])
        return [json.loads(line) for line in buf.getvalue().splitlines()]

    reset_kernel_counts()
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
        ckpt, logliks, aligned, decoded, profile = {}, {}, {}, {}, {}
        host = {"vector": {}, "simple": {}}
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
            decoded[dev], profile[dev] = profiled(lambda: run(
                dev, *common, "decode", "--decoder", "device",
                "--checkpoint", ckpt["cuda"], "--lexicon", lex, *wavs))
            model = ["--checkpoint", ckpt["cuda"], "--lexicon", lex, *wavs]
            host["vector"][dev] = run(dev, *common, "decode", *model)
            host["simple"][dev] = run(dev, *common, "decode", "--decoder",
                                      "simple", *model)
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
                scan = dk.decoder_scan_cuda.launches
                fin = dk.decoder_finalize_cuda.launches

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
    for tier, runs in host.items():
        check(all(d["nbest"] for d in runs["cuda"]),
              f"decode --decoder {tier} answered every WAV")
        for g, c in zip(runs["cuda"], runs["cpu"]):
            got, want = g["nbest"], c["nbest"]
            check([h["words"] for h in got] == [h["words"] for h in want],
                  f"decode --decoder {tier} {g['wav']}: GPU n-best {got} vs "
                  f"CPU {want}")
            check(np.allclose([h["score"] for h in got],
                              [h["score"] for h in want], rtol=1e-4,
                              atol=0.0),
                  f"decode --decoder {tier} {g['wav']}: GPU scores {got} vs "
                  f"CPU {want}")
    final = listened[-1]["final"]
    dec0 = decoded["cuda"][0]["nbest"]
    check(bool(final) and final[0]["words"] == dec0[0]["words"],
          f"listen's final {final[:1]} vs decode's {dec0[:1]}")
    check([s["wav"] for s in served] == wavs, "serve kept the input order")
    for s, d in zip(served, decoded["cuda"]):
        check(s["nbest"][0]["words"] == d["nbest"][0]["words"],
              f"serve's 1-best {s['nbest'][0]} vs decode's {d['nbest'][0]}")
    check(gmm > 0 and dp["forward"] > 0 and dp["backward"] > 0
          and dp["viterbi"] > 0 and scan > 0, f"the CLI launched the "
          f"kernels: gmm {gmm}, dp {dp}, frame scan {scan}")
    say("cli", commands=["synth-corpus", "build-lexicon", "train", "align",
                         "decode", "listen", "serve"],
        senones=int(bank.num_states), mixtures=int(bank.means.shape[1]),
        gpu_logliks=g_ll, cpu_logliks=c_ll, max_rel_diff=rel,
        tol_rel=CLI_TRAIN_RTOL, align_frames_equal=True,
        decode_equal_rtol=1e-4, kernel_frames=int(x.shape[0]),
        kernel_max_abs_err=err, kernel_tol=F32_TOL,
        one_best=[d["nbest"][0]["words"] for d in decoded["cuda"]],
        one_best_host={t: [d["nbest"][0]["words"] for d in r["cuda"]]
                       for t, r in host.items()},
        listen_partials=len(listened) - 1, gmm_launches=gmm,
        dp_kernel_launches=dp, scan_kernel_launches=scan,
        finalize_kernel_launches=fin,
        device_decode_command_profile=profile["cuda"],
        phase_seconds=time.perf_counter() - t0)


WER_TABLE = {"你": ["ni3"], "好": ["hao3"], "马": ["ma1"]}
WER_WORDS = {"你好": ["ni3", "hao3"], "你": ["ni3"], "马": ["ma1"]}
WER_UNITS = ["n", "i3", "h", "ao3", "m", "a1"]


def phase_wer_e2e(seed: int) -> None:
    """Recognition by a model trained through the DP kernels: the corpus
    of tests/test_full_loop_wer.py (20 WAVs of one or two of three words,
    each unit a separable two-harmonic signature) -> Corpus ->
    ``Trainer.auto(t=4, mode=2, init=True)`` -> ``DeviceBeamDecoder``,
    ``VectorBeamDecoder`` and ``BeamDecoder(candidate=3, max_tokens=48)``
    over ``export_bank()`` -> ``evaluate_decoder``, on the card and on the
    CPU: WER 0.0 on the card on every tier, the host tiers give the device
    tier's words, and the card the CPU's."""
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
            reset_kernel_counts()
            batches = list(corpus_io.Corpus(cfg, inv, device=dev).batches())
            tr = Trainer(cfg, inv, device=dev,
                         generator=torch.Generator().manual_seed(seed))
            lls = tr.auto(batches, t=4, mode=2, init=True)
            dec = DeviceBeamDecoder(tr.export_bank(), flat)
            utts = [(b.feats[i], refs[k * 10 + i])
                    for k, b in enumerate(batches)
                    for i in range(len(b.feats))]
            n_frames = [int(m.sum()) for b in batches for m in b.t_masks]
            result, profile = profiled(
                lambda: evaluate_decoder(dec, utts, n_frames))
            words = [list(dec.decode(f, n_frames=n, return_nbest=1)[0].words)
                     for (f, _), n in zip(utts, n_frames)]
            runs[dev] = dict(
                wer=result.wer, substitutions=result.substitutions,
                deletions=result.deletions, insertions=result.insertions,
                ref_tokens=result.ref_tokens, logliks=lls, words=words,
                dp_kernel_launches={k: f.launches
                                    for k, f in hk.KERNELS.items()},
                scan_kernel_launches=dk.decoder_scan_cuda.launches,
                finalize_kernel_launches=dk.decoder_finalize_cuda.launches,
                evaluate_decoder_profile=profile)
            # the host tiers over the same bank (tests/test_full_loop_wer.py
            # decodes with the simple one)
            for tier, cls in (("vector", VectorBeamDecoder),
                              ("simple", BeamDecoder)):
                host = cls(dec.bank, flat, candidate=3, max_tokens=48)
                res = evaluate_decoder(host, utts, n_frames)
                runs[dev][tier] = dict(
                    wer=res.wer, words=[
                        list(host.decode(f, n_frames=n,
                                         return_nbest=1)[0].words)
                        for (f, _), n in zip(utts, n_frames)])
    g, c = runs["cuda"], runs["cpu"]
    check(len(g["words"]) == 20 and g["ref_tokens"] == sum(map(len, refs)),
          "every utterance was scored")
    check(g["dp_kernel_launches"]["forward"] >= 4
          and g["dp_kernel_launches"]["backward"] >= 4,
          f"training on the card launched the forward and backward kernels "
          f"every epoch: {g['dp_kernel_launches']}")
    check(not any(c["dp_kernel_launches"].values())
          and c["scan_kernel_launches"] == 0, "the CPU run launched no kernel")
    check(g["scan_kernel_launches"] > 0, "the device tier on the card "
          f"launched the frame-scan kernel ({g['scan_kernel_launches']})")
    check(g["wer"] == 0.0, f"WER of the model trained on the card: {g}")
    check(g["words"] == c["words"], f"words on the card {g['words']} vs on "
          f"the CPU {c['words']}")
    for tier in ("vector", "simple"):
        check(g[tier]["wer"] == 0.0, f"{tier} tier WER on the card: "
              f"{g[tier]}")
        check(g[tier]["words"] == g["words"] == c[tier]["words"],
              f"{tier} tier words: card {g[tier]['words']}, device tier "
              f"{g['words']}, CPU {c[tier]['words']}")
    tiers = ("words", "vector", "simple")
    say("wer_e2e", utterances=20, units=len(inv), mixtures=2,
        gpu={k: v for k, v in g.items() if k not in tiers},
        cpu={k: v for k, v in c.items() if k not in tiers},
        host_tiers_wer={t: [g[t]["wer"], c[t]["wer"]]
                        for t in ("vector", "simple")},
        words_equal=True, one_best=["".join(w) for w in g["words"][:5]],
        phase_seconds=time.perf_counter() - t0)


# ----------------------------------------------------------------------
# context-dependent units
# ----------------------------------------------------------------------

def cd_e2e_words() -> list[str]:
    """Sixteen one-character and sixteen two-character words over the
    first characters of the built-in G2P table."""
    chars = list(BUILTIN_PINYIN)[:48]
    return chars[:16] + [a + b for a, b in zip(chars[16::2], chars[17::2])]


def phase_cd_e2e(seed: int) -> None:
    """The context-dependent workflow through the command line, in process,
    on a corpus from the port's formant synthesiser (120 utterances of one
    to three of :func:`cd_e2e_words` between ``sil`` pauses; XIF_tone +
    ``sil``, 609 CI senones, 1 of 2 mixtures, CMVN, a bigram LM of the
    transcripts): ``train`` (four scheme-2 rounds) with ``--device cuda`` and ``--device cpu``; then
    ``cd-expand`` of the card's CI checkpoint on both devices (triples,
    alignment, statistics, trees, clone, retrain, MAP smoothing) and
    ``decode --cd`` of the card's CD system on both.  Held: the two
    sidecars have the same triples, trees, ``senone_of`` and splits in the
    same order (gains within CD_GAIN_RTOL), the CI logliks agree within
    1e-4 relative, the CD checkpoints' banks within CD_BANK_TOL (what both
    CLIs write), the decoded words are
    equal, the kernels' counters rise on the card and stay at zero on the
    CPU.  The word error rate it prints is formant-synthesised proxy
    evidence, on the training utterances."""
    import contextlib
    import io

    from poccala_tpu_torch import cli
    from poccala_tpu_torch.eval import wer as corpus_wer
    from poccala_tpu_torch.io import synth_formant

    def run(device, *argv) -> list[dict]:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["--device", device, *argv])
        return [json.loads(line) for line in buf.getvalue().splitlines()]

    t0 = time.perf_counter()
    inv = UnitInventory(UnitInventory.standard("XIF_tone").units + ["sil"])
    vocabulary = cd_e2e_words()
    with tempfile.TemporaryDirectory() as tmp:
        audio, label, transcripts = synth_formant.generate_formant_corpus(
            tmp, vocabulary, PinYin(), num_utts=120, words_per_utt=(1, 3),
            n_speakers=4, seed=seed, sil_token="sil")
        units = os.path.join(tmp, "units")
        inv.save(units)
        vocab = os.path.join(tmp, "vocab.txt")
        with open(vocab, "w") as f:
            f.write("\n".join(vocabulary) + "\n")
        common = ["--units", units,
                  "--set", f"paths.audio_file_path={audio}",
                  "--set", f"paths.label_file_path={label}",
                  "--set", "train.label_format=pinyin",
                  "--set", "train.load_line=1", "--set", "frontend.vad=false",
                  "--set", "frontend.cmvn=true", "--set", "model.mix_level=1",
                  "--set", "model.max_mix_level=2",
                  "--set", "model.var_floor_scale=0.01",
                  "--set", "train.max_frames=384",
                  "--set", "train.max_label_len=20",
                  "--set", "train.batch_size=20", "--set", "train.step=4",
                  "--set", "train.proportion=1.0"]
        lex = os.path.join(tmp, "lex.pkl")
        run("cuda", *common, "build-lexicon", "--words", vocab, "--out", lex)
        text, lm = os.path.join(tmp, "text.txt"), os.path.join(tmp, "lm.json")
        with open(text, "w") as f:
            f.write("\n".join(" ".join(ws) for _, ws in transcripts) + "\n")
        run("cuda", *common, "train-lm", "--text", text, "--out", lm)
        wavs = [os.path.join(audio, name + ".wav")
                for name, _ in transcripts[:24]]
        refs = [words for _, words in transcripts[:24]]
        ci, cd, ci_lls, decoded, used, profile = {}, {}, {}, {}, {}, {}
        for dev in ("cuda", "cpu"):
            reset_kernel_counts()
            ci[dev] = os.path.join(tmp, f"ci_{dev}")
            hist = os.path.join(tmp, f"hist_{dev}.json")
            run(dev, *common, "train", "--mode", "2", "--epochs", "4",
                "--checkpoint", ci[dev], "--history", hist)
            with open(hist) as f:
                ci_lls[dev] = [h["loglik"] for h in json.load(f)]
            # both devices expand the card's CI bank and decode the card's
            # CD system
            cd[dev] = (os.path.join(tmp, f"cd_{dev}"),
                       os.path.join(tmp, f"cd_{dev}.json"))
            run(dev, *common, "cd-expand", "--checkpoint", ci["cuda"],
                "--vocab", vocab, "--out-checkpoint", cd[dev][0], "--out-cd",
                cd[dev][1], "--target-senones", "900", "--retrain-epochs",
                "2", "--min-occ", "8", "--map-tau", "8")
            decoded[dev], profile[dev] = profiled(lambda: run(
                dev, *common, "decode", "--decoder", "device", "--checkpoint",
                cd["cuda"][0], "--lexicon", lex, "--lm", lm, "--cd",
                cd["cuda"][1], *wavs))
            used[dev] = kernel_counts()
        sidecars = {}
        for dev in ("cuda", "cpu"):
            with open(cd[dev][1]) as f:
                sidecars[dev] = json.load(f)
        cd_banks = {dev: load_checkpoint(cd[dev][0], device="cpu")[0]
                    for dev in cd}
        cd_bank, _ = load_checkpoint(cd["cuda"][0], device="cuda")

    g, c = sidecars["cuda"], sidecars["cpu"]
    for key in ("base_units", "context_free", "triples", "senone_of",
                "n_senones", "question_names", "nodes"):
        check(g[key] == c[key], f"cd sidecars: {key} equal on card and CPU")
    check(len(g["splits_log"]) == len(c["splits_log"]) > 0
          and all({**a, "gain": 0} == {**b, "gain": 0}
                  for a, b in zip(g["splits_log"], c["splits_log"])),
          "the same splits in the same order on card and CPU")
    # the gains are float64, but of float32 features from two frontends
    # (cuFFT against the CPU's FFT), and a gain is a small difference of
    # large log-likelihoods
    rel_gain = max(abs(a["gain"] / b["gain"] - 1)
                   for a, b in zip(g["splits_log"], c["splits_log"]))
    check(rel_gain < CD_GAIN_RTOL, f"split gains on card and CPU differ by "
          f"{rel_gain} relative")
    def rel_diff(lls):
        """Against the largest magnitude: a loglik that passes through
        zero between rounds is a sum of terms of that size."""
        g, c = np.array(lls["cuda"]), np.array(lls["cpu"])
        return float(np.max(np.abs(g - c)) / np.max(np.abs(c)))

    rel_ci = rel_diff(ci_lls)
    check(rel_ci < CLI_TRAIN_RTOL, f"CI logliks {ci_lls}")
    # what both CLIs write: the CD checkpoints' banks, at the tolerance of
    # tests/test_torch_cli.py (two float32 retrains of one clone)
    bank_diff = {f: float((getattr(cd_banks["cuda"], f)
                           - getattr(cd_banks["cpu"], f)).abs().max())
                 for f in ("means", "log_var", "log_A")}
    check(all(torch.allclose(getattr(cd_banks["cuda"], f),
                             getattr(cd_banks["cpu"], f), **CD_BANK_TOL)
              for f in bank_diff),
          f"CD banks of the card and the CPU differ by {bank_diff}")
    check(cd_bank.num_states == g["n_senones"]
          and cd_bank.num_units == len(g["triples"]),
          "the CD checkpoint has the sidecar's senones and triples")
    hyps = {dev: [d["nbest"][0]["words"] if d["nbest"] else []
                  for d in decoded[dev]] for dev in decoded}
    check(hyps["cuda"] == hyps["cpu"], f"decode --cd words on the card "
          f"{hyps['cuda']} vs on the CPU {hyps['cpu']}")
    # every kernel of the exact search's paths
    check(all(n > 0 for k, n in used["cuda"].items()
              if k not in OFF_EXACT_PATHS),
          f"the CD path launched every kernel on the card: {used['cuda']}")
    check(not any(used["cpu"].values()),
          f"the CPU run launched no kernel: {used['cpu']}")
    result = corpus_wer(refs, hyps["cuda"])
    say("cd_e2e", utterances=len(transcripts), vocabulary=len(vocabulary),
        ci_senones=3 * len(inv), triples=len(g["triples"]),
        cd_senones=g["n_senones"], splits=len(g["splits_log"]),
        trees_equal=True, max_rel_gain_diff=rel_gain,
        gain_tol_rel=CD_GAIN_RTOL, ci_logliks=ci_lls, ci_max_rel_diff=rel_ci,
        cd_bank_max_abs_diff=bank_diff, cd_bank_tol=CD_BANK_TOL,
        decoded=len(wavs), words_equal=True,
        wer=result.wer, wer_note="formant-synthesised proxy, on training "
        "utterances: not a recognition result on speech",
        kernel_launches=used, device_decode_command_profile=profile["cuda"],
        one_best=["".join(w) for w in hyps["cuda"][:5]],
        phase_seconds=time.perf_counter() - t0)


def cd_system(seed: int, device):
    """A seeded context-dependent system of the size of the JAX package's
    best artifact: two-character words of the synthetic lexicon, in a
    seeded order, until their within-word triples over XIF_tone + ``sil``
    number CD_TRIPLES or a few more; seeded per-triple statistics (each
    base unit its own mean, each context an offset); trees grown to
    exactly CD_S senones; the CD bank cloned from a seeded CI bank of
    CD_M mixtures.
    :returns: (cfg, inv, cd, trees, ci_bank, cd_bank, entries, seconds)"""
    from poccala_tpu_torch.models import context as ctx

    rng = np.random.default_rng(seed)
    cfg = train_config()
    cfg.model.mix_level = cfg.model.max_mix_level = CD_M
    inv = UnitInventory(UnitInventory.standard("XIF_tone").units + ["sil"])
    sil = inv.id_of["sil"]
    _, words, py = synthetic_lexicon(inv, min_nodes=0)
    entries, seqs, cd = [], [], None
    for k in rng.permutation(len(words)):
        combos = ctx.reading_combos(py, words[k], inv.id_of, cap=1)
        if not combos:
            continue
        entries.append((words[k], combos[0]))
        seqs.append([u for syl in combos[0] for u in syl])
        if len(entries) >= 200 and len(entries) % 5 == 0:
            cd = ctx.CDInventory.from_words(seqs, inv, context_free=[sil])
            if len(cd) >= CD_TRIPLES:
                break
    n = len(cd)
    emit = cfg.model.emit_states
    occ = rng.integers(20, 400, size=(n, emit)).astype(np.float64)
    mean = (rng.normal(size=(len(inv), emit, D))[cd.base_of] * 3
            + rng.normal(size=(n, emit, D)))
    ex2 = mean**2 + rng.uniform(0.5, 2.0, size=(n, emit, D))
    t0 = time.perf_counter()
    trees = ctx.grow_context_trees(cd, occ, mean, ex2, target_senones=CD_S,
                                   min_occ=8.0)
    grow_s = time.perf_counter() - t0
    ci_bank = sb.create_bank(len(inv), cfg.model, D,
                             generator=torch.Generator().manual_seed(seed),
                             device=device)
    cd_bank = ctx.build_cd_bank(ci_bank, cd, trees)
    return cfg, inv, cd, trees, ci_bank, cd_bank, entries, grow_s


def phase_cd_throughput(seed: int, smi: str, epochs: int = 4) -> dict:
    """The context-dependent path at full width (:func:`cd_system`: ~1,091
    triples, 2,049 senones, 6 mixtures, 39 dims) on 256 x 4 s: bench.py's
    training epoch (MFCC -> E-step -> M-step -> Viterbi alignment) over CD
    labels, beside the same epoch over the CI bank it was cloned from (609
    senones) in the same process; ``grow_context_trees`` and
    ``build_cd_lexicon`` in host seconds; a CD ``decode_batch`` in float32
    and one in bfloat16.  Returns the kernels' launches in the timed CD
    epochs and decode calls."""
    from poccala_tpu_torch.models import context as ctx

    phase_t0 = time.perf_counter()
    cfg, inv, cd, trees, ci_bank, cd_bank, entries, grow_s = cd_system(
        seed, "cuda")
    check(trees.n_senones == CD_S and cd_bank.num_states == CD_S
          and cd_bank.max_mix == CD_M and cd_bank.num_units == len(cd),
          f"the CD system has {CD_S} senones of {CD_M} mixtures "
          f"({trees.n_senones}, {tuple(cd_bank.means.shape)})")
    t0 = time.perf_counter()
    flat = ctx.build_cd_lexicon(entries, cd,
                                sil_word=("<sil>", inv.id_of["sil"]))
    lex_s = time.perf_counter() - t0

    signals, n_samp, _, lens = train_batch(seed, cfg, len(inv))
    rng = np.random.default_rng(seed + 1)
    fe = Frontend(cfg.frontend, device="cuda")

    def labels_over(n_units):
        return torch.as_tensor(rng.integers(0, n_units, size=(
            TRAIN_B, TRAIN_L)).astype(np.int32), device="cuda")

    def epoch_rate(bank0, labels):
        """audio-s per wall second of ``epochs`` epochs after a warm-up."""
        def one_epoch(bank):
            feats, masks = fe.mfcc_batch(signals, n_samp)
            stats, _ = acc.batch_stats(bank, labels, lens, feats, masks, 5,
                                       TRAIN_L)
            new_bank = acc.apply_update(bank, stats)
            scores, label_pos = align.align_batch(new_bank, labels, lens,
                                                  feats, masks, 5, TRAIN_L)
            return new_bank, stats.loglik + scores.sum() + label_pos.sum()

        float(one_epoch(bank0)[1])
        for kernel in hk.KERNELS.values():
            kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bank, total = bank0, 0.0
        for _ in range(epochs):
            bank, probe = one_epoch(bank)
            total = total + probe
        total = float(total)
        elapsed = time.perf_counter() - t0
        check(np.isfinite(total), f"finite probe ({total})")
        profile = device_profile(lambda: one_epoch(bank0))
        return (TRAIN_B * 4.0 * epochs / elapsed, elapsed,
                {k: f.launches for k, f in hk.KERNELS.items()}, profile)

    ci_rate, ci_s, _, ci_profile = epoch_rate(ci_bank, labels_over(len(inv)))
    cd_rate, cd_s, dp, cd_profile = epoch_rate(cd_bank, labels_over(len(cd)))
    for k, n in dp.items():
        check(n >= epochs, f"the CD epochs launched the {k} kernel ({n})")

    # decode: the CD graph over the CD bank, 256 x 4 s of noise
    feats, masks = fe.mfcc_batch(signals, n_samp)
    n_frames = masks.sum(dim=1).cpu().numpy()
    del signals
    dec = DeviceBeamDecoder(cd_bank, flat)
    dec.decode_batch(feats, n_frames)                         # warm-up
    gk.gmm_log_scores_cuda.launches = 0
    gk.gmm_log_scores_cuda.launches_bf16 = 0
    dk.decoder_scan_cuda.launches = 0
    dk.decoder_scan_pruned_cuda.launches = 0
    dk.decoder_finalize_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hyps = dec.decode_batch(feats, n_frames)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    check(all(len(h) >= 1 and np.isfinite(h[0].score) for h in hyps),
          "every utterance decoded over the CD graph")
    gmm = gk.gmm_log_scores_cuda.launches
    scan = dk.decoder_scan_cuda.launches
    check(gmm == 1, f"one GMM kernel launch per CD decode call ({gmm})")
    fin = dk.decoder_finalize_cuda.launches
    check(scan == 1, f"one frame-scan launch per CD decode call ({scan})")
    check(fin == 1, f"one n-best launch per CD decode call ({fin})")
    # the frame-scan kernel at the CD graph's size against its plain loop
    say("decoder_scan", case="cd", **scan_case(dec, dec._scores(feats),
                                                n_frames))
    profile = device_profile(lambda: dec.decode_batch(feats, n_frames))
    dec16 = DeviceBeamDecoder(cd_bank, flat, score_dtype="bfloat16")
    dec16.decode_batch(feats, n_frames)                       # warm-up
    gk.gmm_log_scores_cuda.launches_bf16 = 0
    hyps16 = dec16.decode_batch(feats, n_frames)
    gmm16 = gk.gmm_log_scores_cuda.launches_bf16
    check(gmm16 == 1 and all(len(h) >= 1 for h in hyps16),
          f"the bfloat16 CD decode call launched its kernel once ({gmm16})")

    say("cd_throughput", triples=len(cd), base_units=len(inv),
        senones=CD_S, mixtures=CD_M, dim=D, words=len(entries),
        splits=len(trees.splits_log), questions=len(trees.questions),
        grow_context_trees_host_seconds=grow_s,
        build_cd_lexicon_host_seconds=lex_s, lexicon_nodes=int(flat.n_nodes),
        batch=TRAIN_B, utt_seconds=4.0, frames=TRAIN_T, epochs=epochs,
        max_label_len=TRAIN_L,
        cd_train_audio_throughput=cd_rate, cd_epoch_seconds=cd_s / epochs,
        ci_train_audio_throughput=ci_rate, ci_epoch_seconds=ci_s / epochs,
        ci_senones=int(ci_bank.num_states), unit="audio-s/s",
        dp_kernel_launches=dp, cd_epoch_profile=cd_profile,
        ci_epoch_profile=ci_profile,
        cd_decode_audio_throughput=TRAIN_B * 4.0 / decode_s,
        cd_decode_call_ms=decode_s * 1e3, decode_call_profile=profile,
        gmm_launches=gmm, gmm_bf16_launches=gmm16, scan_kernel_launches=scan,
        finalize_kernel_launches=fin,
        phase_seconds=time.perf_counter() - phase_t0,
        device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    return dict(gmm=gmm, gmm_bf16=gmm16, scan=scan, fin=fin, **dp)


# ----------------------------------------------------------------------
# the parallel tier
# ----------------------------------------------------------------------

PAR_RANKS, PAR_DATA, PAR_STATE = 4, 2, 2  # part 2's mesh, on one card
PAR_TIMEOUT_S = 120                       # each rank's collectives
PAR_LIMIT_S = 600                         # the wait for all four ranks


def parallel_batch(seed: int):
    """The parallel phase's batch as host arrays: train_batch's 256 x 4 s
    (bench.py's config 2) through the frontend on the card, and its frame
    counts; the decode runs on the same features."""
    cfg = train_config()
    signals, n_samp, labels, lens = train_batch(
        seed, cfg, len(UnitInventory.standard("XIF")))
    feats, masks = Frontend(cfg.frontend, device="cuda").mfcc_batch(signals,
                                                                   n_samp)
    return dict(labels=labels.cpu().numpy(), lens=lens.cpu().numpy(),
                feats=feats.cpu().numpy(), masks=masks.cpu().numpy())


def parallel_bank(seed: int) -> sb.SenoneBank:
    """The config-2 bank of the sharded calls, on the host (XIF, 186
    senones, 8 mixtures, 39 dims, seeded)."""
    cfg = train_config()
    return sb.create_bank(len(UnitInventory.standard("XIF")), cfg.model, D,
                          generator=torch.Generator().manual_seed(seed + 7),
                          device="cpu")


def words_of(hyps) -> list:
    return [list(h[0].words) if h else [] for h in hyps]


def phase_parallel_one_rank(seed: int, data: dict) -> dict:
    """Part 1 of ``parallel``: ``--distributed`` on one card, a one-rank
    NCCL mesh (1 x 1) at full width.  A ``Trainer(mesh=)`` scheme-2 epoch
    (after a flat start) and scheme-1 realignment round (after an init
    round) on the config-2 batch, the state-sharded E-step and alignment on
    the config-2 bank, and ``decode_batch(mesh=)`` at the decode width, each
    timed against the unsharded call in this process (warmed up first),
    with the kernels' counters over the sharded calls alone.  The trainers'
    banks are held to each other from a second pair of runs under
    ``torch.use_deterministic_algorithms`` (``index_add_`` then sums in a
    fixed order; otherwise its atomics make two unsharded runs differ).
    Returns the unsharded results part 2 is held to, and the counters."""
    import torch.distributed as dist

    from poccala_tpu_torch.parallel import mesh as pmesh

    t_phase = time.perf_counter()
    cfg = train_config()
    cfg.train.max_label_len = TRAIN_L
    inv = UnitInventory.standard("XIF")
    batch = corpus_io.Batch(data["feats"], data["masks"], data["labels"],
                            data["lens"])
    arrays = (data["labels"], data["lens"], data["feats"], data["masks"])
    n_frames = data["masks"].sum(axis=1)
    bank = parallel_bank(seed).to("cuda")
    dec, _ = full_width_decoder(seed, "cuda")
    mesh = pmesh.make_mesh(device="cuda")
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
          and pmesh.mesh_shape(mesh) == {"data": 1, "state": 1},
          "--distributed on one card is a one-rank NCCL mesh")

    def trainer(sharded: bool) -> Trainer:
        kw = dict(mesh=mesh) if sharded else dict(device="cuda")
        return Trainer(cfg, inv, generator=torch.Generator().manual_seed(seed),
                       **kw)

    def train(sharded: bool, reps: int = 1) -> dict:
        """A scheme-2 epoch after a flat start, and a scheme-1 realignment
        round after an init round (each ``reps`` times): the first
        logliks, the median ms and the trained banks."""
        ms = {}
        tr2 = trainer(sharded)
        tr2.flat_start([batch])
        ll2, ms["scheme2_epoch"] = synced_ms(
            lambda: tr2.scheme2_epoch([batch]), reps)
        tr1 = trainer(sharded)
        tr1.scheme1_round([batch], init=True)
        ll1, ms["scheme1_round"] = synced_ms(
            lambda: tr1.scheme1_round([batch], init=False), reps)
        return dict(lls=[ll2, ll1], ms=ms,
                    banks=[tr2.export_bank(), tr1.export_bank()])

    def run(sharded: bool, reps: int = 3) -> dict:
        """Every call of the phase, sharded (over the mesh) or not, each
        ``reps`` times: first results, median ms."""
        out = train(sharded, reps)
        ms = out["ms"]
        if sharded:
            estep = pmesh.make_state_sharded_estep(mesh, 5, TRAIN_L)
            align_fn = pmesh.make_state_sharded_align(mesh, 5, TRAIN_L)
            pmesh.reset_traffic()
            (out["stats"], out["logliks"]), ms["estep"] = synced_ms(
                lambda: estep(bank, *arrays))
            out["estep_traffic"] = dict(calls=pmesh.all_reduce.calls,
                                        bytes=pmesh.all_reduce.bytes)
            ms["estep"] = synced_ms(lambda: estep(bank, *arrays), reps)[1]
        else:
            (out["stats"], out["logliks"]), ms["estep"] = synced_ms(
                lambda: acc.batch_stats(bank, *arrays, 5, TRAIN_L), reps)
            align_fn = lambda *a: align.align_batch(*a, 5, TRAIN_L)  # noqa
        (out["scores"], out["label_pos"]), ms["align"] = synced_ms(
            lambda: align_fn(bank, *arrays), reps)
        out["hyps"], ms["decode_call"] = synced_ms(lambda: dec.decode_batch(
            data["feats"], n_frames, mesh=mesh if sharded else None), reps)
        return out

    run(False, reps=1)                                   # warm-up
    reset_kernel_counts()
    got = run(True)
    launches = kernel_counts()
    decode_profile = device_profile(lambda: dec.decode_batch(
        data["feats"], n_frames, mesh=mesh))
    want = run(False)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det = [train(True), train(False)]
    finally:
        torch.use_deterministic_algorithms(False)
    dist.destroy_process_group()

    for k, n in launches.items():   # a sharded call runs the exact search
        check(n > 0 or k in OFF_EXACT_PATHS,
              f"the sharded path launched the {k} kernel ({n})")
    rel = [abs(g / w - 1) for g, w in zip(got["lls"], want["lls"])]
    check(max(rel) < 1e-4, f"Trainer(mesh=) logliks {got['lls']} against "
          f"the unsharded trainer's {want['lls']}")
    check(det[0]["lls"] == det[1]["lls"], f"deterministic Trainer(mesh=) "
          f"logliks {det[0]['lls']} against the unsharded {det[1]['lls']}")
    bank_err = [{f: float((getattr(a, f) - getattr(b, f)).abs().max())
                 for f in sb.FIELDS if f not in ("log_pi", "senone_map")}
                for a, b in zip(det[0]["banks"], det[1]["banks"])]
    check(all(torch.equal(getattr(a, f), getattr(b, f)) for f in sb.FIELDS
              for a, b in zip(det[0]["banks"], det[1]["banks"])),
          f"deterministic Trainer(mesh=) banks against the unsharded: "
          f"{bank_err}")
    stats_err = stats_close(acc.stats_to_numpy(got["stats"]),
                            acc.stats_to_numpy(want["stats"]))
    check(torch.equal(got["logliks"], want["logliks"])
          and torch.equal(got["label_pos"], want["label_pos"])
          and torch.equal(got["scores"], want["scores"]),
          "sharded logliks, alignment scores and paths equal the unsharded")
    check([[(h.words, h.score) for h in u] for u in got["hyps"]]
          == [[(h.words, h.score) for h in u] for u in want["hyps"]],
          "decode_batch(mesh=) equals the unsharded decode")
    stats_bytes = 4 * sum(getattr(want["stats"], f).numel()
                          for f in acc.STATS_FIELDS)
    say("parallel_one_rank", mesh={"data": 1, "state": 1}, backend="nccl",
        batch=TRAIN_B, utt_seconds=4.0, frames=int(data["masks"].shape[1]),
        train_senones=int(bank.num_states), decode_senones=S, mixtures=M,
        dim=D, sharded_ms=got["ms"], unsharded_ms=want["ms"],
        logliks=dict(sharded=got["lls"], unsharded=want["lls"]),
        loglik_rel_diff=rel, deterministic_bank_max_abs_diff=bank_err,
        stats_max_abs_diff=stats_err,
        state_sharded_estep_collectives=got["estep_traffic"],
        bytes_per_estep=dict(
            statistics_buffer=stats_bytes, logliks=4 * TRAIN_B,
            lattice=4 * TRAIN_B * TRAIN_T * (3 * TRAIN_L + 2)),
        kernel_launches_sharded=launches,
        sharded_decode_call_profile=decode_profile,
        phase_seconds=time.perf_counter() - t_phase)
    return dict(stats=acc.stats_to_numpy(want["stats"]),
                logliks=want["logliks"].cpu().numpy(),
                label_pos=want["label_pos"].cpu().numpy(),
                scores=want["scores"].cpu().numpy(),
                words=words_of(want["hyps"]), launches=launches)


def stats_close(got: dict, want: dict, bank_rows: slice = slice(None)):
    """Each statistics field within rtol 1e-4 plus 1e-4 of the field's
    largest magnitude (tests/test_torch_gpu.py's rule for sums taken in
    another order); GMM fields compared on ``bank_rows``.  Returns the
    max abs differences."""
    err = {}
    for f in acc.STATS_FIELDS:
        w = want[f][bank_rows] if f in ("occ", "c", "cx", "cxx") else want[f]
        g = got[f]
        scale = max(1.0, float(np.abs(w).max()))
        err[f] = float(np.abs(g - w).max())
        check(g.shape == w.shape and np.allclose(g, w, rtol=1e-4,
                                                 atol=1e-4 * scale),
              f"statistics field {f}: {err[f]} at scale {scale}")
    return err


def parallel_rank(rank: int, port: int, tmp: str, seed: int) -> None:
    """The body of one rank of part 2 (``chip_smoke.py --rank R``): a
    ``PAR_DATA x PAR_STATE`` mesh over gloo with CUDA tensors on the one
    card; the state-sharded E-step, alignment and train step on the
    config-2 batch, the sharded decode, then the multichip dry run at
    config-3 scale.  Writes ``tmp/rank{R}.npz``."""
    from datetime import timedelta

    import torch.distributed as dist

    from poccala_tpu_torch.parallel import mesh as pmesh
    from poccala_tpu_torch.parallel.dryrun import dryrun_multichip

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    timeout = timedelta(seconds=PAR_TIMEOUT_S)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=PAR_RANKS, timeout=timeout)
    data = dict(np.load(os.path.join(tmp, "inputs.npz")))
    arrays = (data["labels"], data["lens"], data["feats"], data["masks"])
    n_frames = data["masks"].sum(axis=1)
    mesh = pmesh.make_mesh(PAR_DATA, PAR_STATE, device="cuda",
                           timeout=timeout)
    padded, _ = pmesh.pad_bank_states(parallel_bank(seed), PAR_STATE)
    shard = pmesh.shard_bank_states(padded, mesh)
    dec, _ = full_width_decoder(seed, "cuda")
    estep = pmesh.make_state_sharded_estep(mesh, 5, TRAIN_L)
    align_fn = pmesh.make_state_sharded_align(mesh, 5, TRAIN_L)
    step = pmesh.make_state_sharded_train_step(mesh, 5, TRAIN_L)
    calls = dict(estep=lambda: estep(shard, *arrays),
                 align=lambda: align_fn(shard, *arrays),
                 train_step=lambda: step(shard, *arrays),
                 decode_call=lambda: dec.decode_batch(data["feats"], n_frames,
                                                      mesh=mesh))
    for fn in calls.values():                            # warm-up
        fn()
    reset_kernel_counts()
    out, ms, traffic = {}, {}, {}
    for name, fn in calls.items():
        pmesh.reset_traffic()
        out[name], ms[name] = synced_ms(fn, reps=3)
        traffic[name] = dict(all_reduce_calls=pmesh.all_reduce.calls // 3,
                             all_reduce_bytes=pmesh.all_reduce.bytes // 3)
    launches = kernel_counts()
    stats, logliks = out["estep"]
    dry = dryrun_multichip(PAR_RANKS, device="cuda")
    shard_bytes = sum(getattr(shard, f).numel() * getattr(shard, f)
                      .element_size() for f in ("means", "log_var", "log_w",
                                                "mix_counts"))
    record = dict(coords=[mesh.get_local_rank("data"),
                          mesh.get_local_rank("state")],
                  shard_rows=int(shard.num_states), shard_bytes=shard_bytes,
                  ms=ms, collectives=traffic, kernel_launches=launches,
                  words=words_of(out["decode_call"]), dryrun=dry,
                  train_loglik=float(out["train_step"][1]))
    np.savez(os.path.join(tmp, f"rank{rank}.npz"),
             record=np.asarray(json.dumps(record)),
             logliks=logliks.cpu().numpy(),
             label_pos=out["align"][1].cpu().numpy(),
             scores=out["align"][0].cpu().numpy(),
             **{f"stats_{k}": v for k, v in acc.stats_to_numpy(stats).items()})
    dist.destroy_process_group()


def phase_parallel_ranks(seed: int, data: dict, one: dict) -> None:
    """Part 2 of ``parallel``: four rank processes on the one card (data 2 x
    state 2) over gloo with CUDA tensors (NCCL refuses two ranks on one
    GPU); the kernels were built by this process first, so no two ranks run
    nvcc at once.  Rank 0's statistics (its shard's rows), logliks,
    ``label_pos`` and decoded words are held to part 1's unsharded results;
    a failure or a timeout of any rank fails the phase."""
    import socket

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "inputs.npz"), **data)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(PAR_RANKS)]
        procs = []
        try:
            for r, log in enumerate(logs):
                with open(log, "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__), "--seed",
                         str(seed), "--rank", str(r), "--port", str(port),
                         "--dir", tmp], stdout=f, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + PAR_LIMIT_S
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            with open(log) as f:
                tail = f.read()[-3000:]
            check(p.returncode == 0,
                  f"parallel rank {r} exited {p.returncode}:\n{tail}")
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                 for r in range(PAR_RANKS)]
    recs = [json.loads(str(r["record"])) for r in ranks]
    check([tuple(r["coords"]) for r in recs] == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)],
          "rank = d * state_axis + s")
    s_local = recs[0]["shard_rows"]
    check(s_local == 186 // PAR_STATE, f"{s_local} senone rows a rank")
    got = {k[6:]: v for k, v in ranks[0].items() if k.startswith("stats_")}
    stats_err = stats_close(got, one["stats"], slice(0, s_local))
    for r, rank in enumerate(ranks):
        check(np.array_equal(rank["label_pos"], one["label_pos"]),
              f"rank {r}'s label_pos equal the unsharded alignment")
        check(np.allclose(rank["logliks"], one["logliks"], rtol=1e-5),
              f"rank {r}'s logliks against the unsharded E-step")
        check(recs[r]["words"] == one["words"],
              f"rank {r}'s decoded words equal the unsharded decode")
        # every kernel of the exact search's paths: a sharded decode is exact
        check(all(n > 0 for k, n in recs[r]["kernel_launches"].items()
                  if k not in OFF_EXACT_PATHS),
              f"rank {r} launched every kernel: "
              f"{recs[r]['kernel_launches']}")
        dry = recs[r]["dryrun"]
        check(dry["c3_local"] == 1025 and dry["c3_padded"] == 2050
              and dry["step_max_gmm_rows"] <= 1026,
              f"rank {r} holds S_padded / K rows at config-3 scale: {dry}")
    lattice = 4 * (TRAIN_B // PAR_DATA) * TRAIN_T * (3 * TRAIN_L + 2)
    say("parallel_ranks", ranks=PAR_RANKS,
        mesh={"data": PAR_DATA, "state": PAR_STATE},
        backend="gloo, CUDA tensors", batch=TRAIN_B, frames=TRAIN_T,
        train_senones=186, decode_senones=S,
        shard_bytes=[r["shard_bytes"] for r in recs],
        config3_shard_bytes=[r["dryrun"]["shard_bytes"] for r in recs],
        config3_step_ms=[r["dryrun"]["c3_step_ms"] for r in recs],
        config3_largest_gmm_rows=[r["dryrun"]["step_max_gmm_rows"]
                                  for r in recs],
        lattice_bytes_per_estep=lattice,
        collectives_per_rank=[r["collectives"] for r in recs],
        ms_per_rank=[r["ms"] for r in recs],
        kernel_launches_per_rank=[r["kernel_launches"] for r in recs],
        stats_max_abs_diff_rank0=stats_err,
        train_loglik=[r["train_loglik"] for r in recs],
        dryrun_words=recs[0]["dryrun"]["decode_words"],
        phase_seconds=time.perf_counter() - t_phase)


def phase_parallel(seed: int, smi: str) -> dict:
    """The parallel tier on the card: part 1 in this process, part 2 in
    four rank processes.  Returns part 1's kernel launches."""
    data = parallel_batch(seed)
    one = phase_parallel_one_rank(seed, data)
    phase_parallel_ranks(seed, data, one)
    return one["launches"]


# phases that --only can run by themselves, each as f(seed, smi)
# ----------------------------------------------------------------------
# the device decoder's frame scan (csrc/decoder_scan.cu)
def noise_features(seed: int, batch: int = 256, utt_seconds: float = 4.0):
    """bench_decode's batch: noise audio through the frontend on the card;
    features ``[B, T, D]`` on the card and the host frame counts."""
    cfg = Config()
    n_samples = int(utt_seconds * cfg.frontend.sample_rate)
    rng = np.random.default_rng(seed)
    signals = torch.as_tensor(
        (rng.normal(size=(batch, n_samples)) * 2000).astype(np.float32),
        device="cuda")
    feats, masks = Frontend(cfg.frontend, device="cuda").mfcc_batch(
        signals, torch.full((batch,), n_samples, device="cuda"))
    return feats, masks.sum(dim=1).cpu().numpy()


class TableLM:
    """An LM object without ``bigram_tables_backoff``: the decoder builds
    the flat ``[(V+1) V]`` table through ``logprob`` calls."""

    def __init__(self, lm):
        self.lm = lm

    def logprob(self, word, context):
        return self.lm.logprob(word, context)


def builtin_bigram(seed: int):
    """A bigram LM over the built-in lexicon's words, from seeded text."""
    from poccala_tpu_torch.lm.ngram import Ngram

    rng = np.random.default_rng(seed)
    words = list(BUILTIN_PINYIN)
    lm = Ngram(2)
    lm.train([list(rng.choice(words, size=8)) for _ in range(400)])
    return lm


def plan_at(tabs, n_senones: int, r_top: int, batch: int) -> dict:
    """``dk.scan_plan`` for ``batch`` utterances (in a checkout whose plan
    takes no batch size, its one plan)."""
    if "batch" in inspect.signature(dk.scan_plan).parameters:
        return dk.scan_plan(tabs, n_senones, r_top, batch=batch)
    return dk.scan_plan(tabs, n_senones, r_top)


def scan_bound(tabs, b: int, t_c: int, frames: int) -> dict:
    """The frame scan's least time: of the scores ``[B, Tc, S]`` only the
    senones the lexicon's emitting states name, on this run's ``frames``
    valid frames (frozen frames read none), and ``n_valid`` read once; the
    carry (deltas float32 and ctx int32, ``[B, N, Ns]``) read and written
    once, the rows ``[B, Tc]`` int32 written once, the tables read once;
    (2W + 4) float32 operations per token state and valid frame (the
    advance's W adds and W compares, the emission score's add and clamp,
    the exit's share).  Bytes are the elements' own, not rounded up to the
    32-byte sectors a scattered read moves.  ``carry_round_trip_ms`` is
    the device-memory design's own floor: the carry read and written every
    frame."""
    n, n_s, w = tabs.bands.shape
    q = tabs.node_slot.shape[0]
    n_sen = int(torch.unique(tabs.senone[tabs.emitting]).numel())
    n_bytes = (4 * frames * n_sen + 4 * b + 2 * 8 * b * n * n_s
               + 8 * b * t_c + 4 * n * n_s * (w + 1) + 5 * n + 9 * q)
    out = bound_ms(n_bytes, frames * n * n_s * (2 * w + 4), "float32")
    out["senones_read"] = n_sen
    out["carry_round_trip_ms"] = frames * n * n_s * 16 / PEAK_BYTES_S * 1e3
    return out


def scan_case(dec: DeviceBeamDecoder, scores, n_valid, t0: int = 0,
              carry=None, rows_before=None, reps: int = 11,
              plain_reps: int = 1) -> dict:
    """The frame-scan kernel (``dec._scan`` on the card) against its plain
    version (``dec._scan_plain``, the loop of ``_frame_step``) on the same
    scores and carry: carry, traceback rows and the n-best of each (over
    ``rows_before``, the earlier frames' rows, when ``t0`` > 0) must be
    equal bit for bit, or this raises.  ``ms``: one event pair around a
    wrapper call (median of ``reps``); ``kernel_ms``: the kernel alone under
    the profiler; ``plain_ms``: host ms of the plain loop, synchronised."""
    tabs = dec._prep_device()
    b, t_c, s = scores.shape
    if carry is None:
        carry = dec._seed(tabs, b)

    def kernel():
        return dec._scan(tabs, carry, scores, t0, n_valid)

    def plain():
        return dec._scan_plain(tabs, carry, scores, t0, n_valid)

    def nbest(out):
        carry, prev, word = out
        if rows_before is not None:
            prev = torch.cat([rows_before[0], prev], 1)
            word = torch.cat([rows_before[1], word], 1)
        return dec._finalize(tabs, carry, prev, word, 8)

    before = dk.decoder_scan_cuda.launches
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    g_n, w_n = nbest(got), nbest(want)
    pairs = dict(deltas=(got[0][0], want[0][0]), ctx=(got[0][1], want[0][1]),
                 tb_prev=(got[1], want[1]), tb_word=(got[2], want[2]),
                 nbest_words=(g_n[0], w_n[0]), nbest_scores=(g_n[1], w_n[1]))
    equal = {k: bool(torch.equal(a, b)) for k, (a, b) in pairs.items()}
    n, n_s, w = tabs.bands.shape
    lm = ("none" if dec.lm is None else
          "sparse" if tabs.lm_sparse is not None else "flat")
    plan = plan_at(tabs, s, dec._r_top(tabs), b)
    line = dict(b=b, t_c=t_c, t0=t0, n_nodes=n, n_s=n_s, w=w, s=s,
                slots=int(tabs.node_slot.shape[0]), lm=lm,
                groups=dk.n_groups(tabs), route=plan["route"],
                plan=plan, equal=equal,
                max_abs_err=float((got[0][0] - want[0][0]).abs().max()),
                words_emitted=int((got[2] >= 0).sum()))
    check(all(equal.values()), f"frame-scan kernel vs plain loop: {line}")
    line.update(ms=median_ms(kernel, reps=reps),
                kernel_ms=kernel_device_ms(kernel, "decoder_scan", reps=5),
                plain_ms=synced_ms(plain, reps=plain_reps)[1],
                library_ms=None,
                **scan_bound(tabs, b, t_c,
                             int(np.clip(np.asarray(n_valid), 0, t_c).sum())))
    if line["kernel_ms"] == "not measured":
        # the profiler kept no device event: the kernel's time from CUDA
        # events around back-to-back launches (n_valid already on the card,
        # so no copy orders the host behind the card between them)
        nv = torch.as_tensor(np.asarray(n_valid), dtype=torch.int32,
                             device=scores.device)
        line["kernel_ms_back_to_back"] = loop_ms(
            lambda: dec._scan(tabs, carry, scores, t0, nv), n=reps)
    line["launches"] = dk.decoder_scan_cuda.launches - before
    # where a frame goes: the first utterance's SM cycles in each phase
    clocks = torch.zeros(len(dk.EXACT_PHASES), dtype=torch.int64,
                         device=scores.device)
    dk.decoder_scan_cuda(tabs, carry, scores, t0, n_valid,
                         n_vocab=dec._n_vocab, r_top=dec._r_top(tabs),
                         penalty=-float(dec.word_penalty),
                         phase_clocks=clocks)
    cycles = clocks.cpu().tolist()
    frames0 = max(1, min(t_c, int(np.asarray(n_valid).reshape(-1)[0])))
    line["phase_cycles_utt0"] = dict(zip(dk.EXACT_PHASES, cycles))
    line["cycles_per_frame_utt0"] = sum(cycles) / frames0
    return line


def scan_record(line: dict) -> dict:
    """A :func:`scan_case` line's fields of the ``kernels`` JSON record."""
    out = {k: line[k] for k in ("max_abs_err", "ms", "kernel_ms",
                                "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "carry_round_trip_ms")}
    out.update(scan_route=line["route"], cluster=line["plan"]["cluster"],
               active_clusters=line["plan"]["active_clusters"])
    return out


def phase_decoder_scan(seed: int, smi: str) -> dict:
    """The frame-scan kernel against its plain loop, bit for bit, at the
    decode cell's size (XIF_tone, 606 senones, 8 mixtures, the built-in
    125-node lexicon, 256 x 4 s of noise through the frontend: B = 256,
    Tc = 319) with no LM, a flat and a sparse bigram LM; at a 25-frame
    stream chunk from an earlier chunk's carry (t0 = 25) at B = 1 and 8;
    and over ``synthetic_lexicon`` at the reference lexicon's 3,514 nodes
    and at 21,589 (each carry split over a thread-block cluster).  Each
    case with the first utterance's cycles per phase.  Returns the
    ``kernels`` records of the one-CTA and the cluster route."""
    phase_t0 = time.perf_counter()
    dec, _ = full_width_decoder(seed, "cuda")
    tabs = dec._prep_device()
    feats, n_frames = noise_features(seed)
    scores = dec._scores(feats)
    lines = {"decode": scan_case(dec, scores, n_frames)}
    lm = builtin_bigram(seed)
    for kind, the_lm in (("flat", TableLM(lm)), ("sparse", lm)):
        lm_dec = DeviceBeamDecoder(dec.bank, dec.lexicon, lm=the_lm,
                                   lm_weight=3.0, word_penalty=1.0)
        lines[f"decode_{kind}_lm"] = scan_case(lm_dec, scores, n_frames)
    for b in (1, STREAMS):
        carry, *rows = dec._scan(tabs, dec._seed(tabs, b),
                                 scores[:b, :CHUNK].contiguous(), 0,
                                 n_frames[:b])
        lines[f"stream_chunk_b{b}"] = scan_case(
            dec, scores[:b, CHUNK:2 * CHUNK].contiguous(),
            np.clip(n_frames[:b] - CHUNK, 0, CHUNK), t0=CHUNK, carry=carry,
            rows_before=rows, reps=21, plain_reps=5)
    inv = UnitInventory.standard("XIF_tone")
    # the reference lexicon's scale (README: 3,514 nodes): the largest
    # n_chars whose two-character words stay below it, filled up
    flat, _, _ = synthetic_lexicon(inv, min_nodes=3514, n_chars=56)
    ref = DeviceBeamDecoder(dec.bank, flat)
    lines["exact_3514"] = scan_case(ref, scores, n_frames, reps=3)
    # the reference-scale exact decode call: wall and peak memory
    ref.decode_batch(feats, n_frames)                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hyps, wall = synced_ms(lambda: ref.decode_batch(feats, n_frames))
    check(all(len(h) >= 1 for h in hyps), "3,514 nodes: every utterance "
          "decoded")
    lines["exact_3514"].update(
        decode_call_wall_ms=wall,
        decode_call_peak_mem_bytes=torch.cuda.max_memory_allocated())
    del ref
    flat, _, _ = synthetic_lexicon(inv)
    lines["exact_21k"] = scan_case(DeviceBeamDecoder(dec.bank, flat), scores,
                                   n_frames, reps=3)
    for name, line in lines.items():
        say("decoder_scan", case=name, **line)
    routes = {k: v["route"] for k, v in lines.items()}
    check(all(routes[k] == "smem" for k in routes if not k.startswith("exact"))
          and routes["exact_3514"] == routes["exact_21k"] == "cluster",
          f"the 125-node carries on one CTA, the 3,514- and 21,589-node ones "
          f"over a cluster: {routes}")
    say("decoder_scan_summary", source=dk.SOURCE, replaces=dk.REPLACES,
        routes={k: (v["route"], v["plan"]["cluster"],
                    v["plan"]["active_clusters"]) for k, v in lines.items()},
        ptxas_registers_spill_stores_loads=PTXAS.get("decoder_scan",
                                                     "not rebuilt"),
        phase_seconds=time.perf_counter() - phase_t0,
        device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    del scores, feats
    torch.cuda.empty_cache()
    cluster = scan_record(lines["exact_21k"])
    cluster["exact_3514"] = scan_record(lines["exact_3514"])
    return dict(exact=scan_record(lines["decode"]), exact_cluster=cluster)


def scan_alone_ms(d: DeviceBeamDecoder, sc, nv, t0: int = 0,
                  carry=None, wrapper: bool = False):
    """``d``'s frame scan alone (``torch.profiler``, mean of 5 launches)
    over ``sc`` from ``carry`` (the seed by default); with ``wrapper``,
    ``(alone, one event pair around a wrapper call, median of 5)``."""
    tabs = d._prep_device()
    c = d._seed(tabs, sc.shape[0]) if carry is None else carry

    def call():
        return d._scan(tabs, c, sc, t0, nv)

    alone = kernel_device_ms(call, "decoder_pruned" if d._prune_on
                             else "decoder_scan", reps=5)
    return (alone, median_ms(call)) if wrapper else alone


def second_chunk(d: DeviceBeamDecoder, sc_all, n_frames):
    """The second 25-frame chunk of the first utterance of ``sc_all``
    (t0 = 25) and the carry the first leaves: ``(scores, n_valid,
    carry)``."""
    tabs = d._prep_device()
    carry, *_ = d._scan(tabs, d._seed(tabs, 1),
                        sc_all[:1, :CHUNK].contiguous(), 0, n_frames[:1])
    return (sc_all[:1, CHUNK:2 * CHUNK].contiguous(),
            np.clip(n_frames[:1] - CHUNK, 0, CHUNK), carry)


def scan_trace(d: DeviceBeamDecoder, sc, nv, t0: int = 0,
               carry=None) -> tuple[dict, dict]:
    """The exact scan's plan for ``sc`` and the first utterance's SM cycles
    a frame by phase (``phase_clocks``)."""
    tabs = d._prep_device()
    c = d._seed(tabs, sc.shape[0]) if carry is None else carry
    plan = plan_at(tabs, sc.shape[2], d._r_top(tabs), sc.shape[0])
    clocks = torch.zeros(len(dk.EXACT_PHASES), dtype=torch.int64,
                         device="cuda")
    dk.decoder_scan_cuda(tabs, c, sc, t0, nv, n_vocab=d._n_vocab,
                         r_top=d._r_top(tabs), penalty=-float(d.word_penalty),
                         phase_clocks=clocks)
    frames = max(1, min(sc.shape[1], int(np.asarray(nv)[0])))
    return ({k: plan[k] for k in ("route", "cluster", "active_clusters",
                                  "threads", "nodes_per_cta")},
            {k: v / frames for k, v in zip(dk.EXACT_PHASES,
                                           clocks.cpu().tolist())})


def scan_call_bytes(d: DeviceBeamDecoder, sc, nv, t0: int = 0,
                    carry=None) -> int:
    """The device memory one call of ``d``'s frame scan over ``sc`` takes
    past what was allocated before it (its outputs and scratch):
    ``max_memory_allocated`` during the call less ``memory_allocated``
    before."""
    tabs = d._prep_device()
    c = d._seed(tabs, sc.shape[0]) if carry is None else carry
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = d._scan(tabs, c, sc, t0, nv)
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - before


def nbest_alone_ms(d: DeviceBeamDecoder, scores, n_frames,
                   nbest: int = 1) -> tuple[float, float]:
    """The n-best alone (``torch.profiler``, mean of 5 launches) and through
    its wrapper (one event pair around a call, median of 5) on the carry
    and rows of ``d``'s scan of ``scores``."""
    tabs = d._prep_device()
    carry, prev, word = d._scan(tabs, d._seed(tabs, scores.shape[0]), scores,
                                0, n_frames)
    n_cand = d._n_cand(nbest)

    def call():
        return d._finalize(tabs, carry, prev, word, n_cand)

    return kernel_device_ms(call, "decoder_finalize", reps=5), median_ms(call)


def device_memory_times(seed: int, dec: DeviceBeamDecoder, feats, n_frames,
                        flat: FlatLexicon) -> dict:
    """The exact scan's device-memory route alone: ``state_num = 10`` over
    ``flat`` (the 21,589-node lexicon) at B = 8 and 128 and a 25-frame chunk
    at B = 1, the default topology (``dec``'s bank) over 40,000 nodes at
    B = 8, each with its plan, its bound (:func:`scan_bound`) and the first
    utterance's SM cycles a frame by phase; and the n-best alone over the
    40,000 nodes at B = 256."""
    inv = UnitInventory.standard("XIF_tone")
    out = dict(alone={}, wrapper={}, plans={}, cycles={}, call_bytes={},
               bound={})

    def case(name, d, sc, nv, t0=0, carry=None):
        out["alone"][name], out["wrapper"][name] = scan_alone_ms(
            d, sc, nv, t0, carry, wrapper=True)
        b, t_c = int(sc.shape[0]), int(sc.shape[1])
        out["bound"][name] = scan_bound(
            d._prep_device(), b, t_c,
            int(np.clip(np.asarray(nv), 0, t_c).sum()))
        out["plans"][name], out["cycles"][name] = scan_trace(d, sc, nv, t0,
                                                             carry)
        out["call_bytes"][name] = scan_call_bytes(d, sc, nv, t0, carry)

    cfg10 = Config()
    cfg10.model.state_num = SHAPES_STATE_NUM
    cfg10.model.mix_level = cfg10.model.max_mix_level = M
    d10 = DeviceBeamDecoder(sb.create_bank(
        len(inv), cfg10.model, D,
        generator=torch.Generator().manual_seed(seed), device="cuda"), flat)
    sc10 = d10._scores(feats[:128])
    for b in (8, 128):
        case(f"global_21k_s10_b{b}", d10, sc10[:b].contiguous(),
             n_frames[:b])
    sc, nv, carry = second_chunk(d10, sc10, n_frames)
    case("global_21k_s10_chunk_b1", d10, sc, nv, CHUNK, carry)
    del sc, carry
    del d10, sc10
    huge, _, _ = synthetic_lexicon(inv, min_nodes=40_000)
    d40 = DeviceBeamDecoder(dec.bank, huge)
    scores = d40._scores(feats)
    case("global_40k_b8", d40, scores[:8].contiguous(), n_frames[:8])
    out["nbest_40k_ms"], out["nbest_40k_wrapper_ms"] = nbest_alone_ms(
        d40, scores, n_frames)
    del d40, scores
    torch.cuda.empty_cache()
    return out


def phase_scan_times(seed: int, smi: str) -> dict:
    """Both frame scans' kernel-alone times (``torch.profiler``, mean of 5
    launches) at their cells, with no plain loop: the decode cell with no LM
    and with a flat and a sparse bigram LM, a 25-frame chunk at B = 1 (t0 =
    25) over the built-in lexicon and over 3,514 nodes, the exact scan over
    the CD graph (:func:`cd_system`) and over 3,514 and 21,589 nodes, the
    pruned scan at 8 and 4 of 85 blocks of 256 (and 8 with the LM), and
    the exact scan's device-memory route (:func:`device_memory_times`); the
    B = 1 chunks' host ms of one synchronised wrapper call (median of 21:
    the launch's host cost, the plan included); the n-best alone at the
    decode cell (``return_nbest`` 1 and 5) and over 21,589 (1 and 5) and
    40,000 nodes (B = 256); then one exact, one k8 and one k4
    ``decode_batch`` of the 21,589-node cell, each after a warm-up, with its
    wall ms and peak device memory.  It uses only what the port's decoder
    has had since the pruned scan's first kernel, so a copy of this script
    run in an older checkout times that checkout's kernels: two checkouts
    are compared by alternating them in one chip call."""
    from poccala_tpu_torch.lm.ngram import Ngram
    from poccala_tpu_torch.models import context as ctx

    dec, _ = full_width_decoder(seed, "cuda")
    feats, n_frames = noise_features(seed)
    scores = dec._scores(feats)
    inv = UnitInventory.standard("XIF_tone")
    lm = builtin_bigram(seed)
    alone, call_ms, nbest, nbest_wrapper = {}, {}, {}, {}

    def time_chunk(name, d):
        sc, nv, carry = second_chunk(d, scores, n_frames)
        alone[name] = scan_alone_ms(d, sc, nv, CHUNK, carry)
        tabs = d._prep_device()
        call_ms[name] = synced_ms(
            lambda: d._scan(tabs, carry, sc, CHUNK, nv), reps=21)[1]

    alone["decode"] = scan_alone_ms(dec, scores, n_frames)
    for k in (1, 5):
        nbest[f"decode_n{k}"], nbest_wrapper[f"decode_n{k}"] = \
            nbest_alone_ms(dec, scores, n_frames, k)
    for kind, the_lm in (("flat", TableLM(lm)), ("sparse", lm)):
        alone[f"decode_{kind}_lm"] = scan_alone_ms(DeviceBeamDecoder(
            dec.bank, dec.lexicon, lm=the_lm, lm_weight=3.0,
            word_penalty=1.0), scores, n_frames)
    time_chunk("chunk_b1", dec)
    flat, _, _ = synthetic_lexicon(inv, min_nodes=3514, n_chars=56)
    ref = DeviceBeamDecoder(dec.bank, flat)
    time_chunk("chunk_b1_3514", ref)
    alone["exact_3514"] = scan_alone_ms(ref, scores, n_frames)
    del ref
    _, cd_inv, cd, _, _, cd_bank, entries, _ = cd_system(seed, "cuda")
    cd_dec = DeviceBeamDecoder(cd_bank, ctx.build_cd_lexicon(
        entries, cd, sil_word=("<sil>", cd_inv.id_of["sil"])))
    alone["cd"] = scan_alone_ms(cd_dec, cd_dec._scores(feats), n_frames)
    del cd_dec, cd_bank
    flat, words, _ = synthetic_lexicon(inv)
    big_lm = Ngram(2)
    rng = np.random.default_rng(seed)
    big_lm.train([list(rng.choice(words, size=8)) for _ in range(2000)])
    decs = {"exact": DeviceBeamDecoder(dec.bank, flat),
            "k8": DeviceBeamDecoder(dec.bank, flat, block_size=256,
                                    active_blocks=8),
            "k4": DeviceBeamDecoder(dec.bank, flat, block_size=256,
                                    active_blocks=4)}
    for name, d in decs.items():
        alone["exact_21k" if name == "exact" else f"pruned_{name}"] = \
            scan_alone_ms(d, scores, n_frames)
    alone["pruned_k8_sparse_lm"] = scan_alone_ms(DeviceBeamDecoder(
        dec.bank, flat, lm=big_lm, lm_weight=3.0, word_penalty=1.0,
        block_size=256, active_blocks=8), scores, n_frames)
    for k in (1, 5):
        nbest[f"exact_21k_n{k}"], nbest_wrapper[f"exact_21k_n{k}"] = \
            nbest_alone_ms(decs["exact"], scores, n_frames, k)
    glob = device_memory_times(seed, dec, feats, n_frames, flat)
    alone.update(glob["alone"])
    nbest["exact_40k_n1"] = glob["nbest_40k_ms"]
    nbest_wrapper["exact_40k_n1"] = glob["nbest_40k_wrapper_ms"]
    walls = {}
    for name, d in decs.items():
        d.decode_batch(feats, n_frames)                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, wall = synced_ms(lambda: d.decode_batch(feats, n_frames))
        walls[name] = dict(wall_ms=wall,
                           peak_mem_bytes=torch.cuda.max_memory_allocated())
    say("scan_times", kernel_alone_ms=alone, chunk_call_host_ms=call_ms,
        nbest_kernel_alone_ms=nbest, nbest_wrapper_ms=nbest_wrapper,
        device_memory_wrapper_ms=glob["wrapper"],
        device_memory_plans=glob["plans"],
        device_memory_cycles_per_frame_utt0=glob["cycles"],
        device_memory_call_bytes=glob["call_bytes"],
        device_memory_bound=glob["bound"], calls_21k=walls,
        source=dk.SOURCE, device=torch.cuda.get_device_name(0),
        nvidia_smi=smi)
    return alone


# ----------------------------------------------------------------------
# the device decoder's n-best (decoder_finalize in csrc/decoder_scan.cu)
def finalize_bound(tabs, seqs: torch.Tensor) -> dict:
    """The n-best's least time: of the carry (deltas float32 and ctx int32,
    ``[B, N, Ns]``) only the exit states (``min(W - 1, Ns - 1)`` a node) of
    the nodes the valid slots name, with their band entries; the slots'
    node, word and flag once; of the traceback rows (``[B, T]`` int32,
    two) only the entries the chase follows, counted as each utterance's
    longest chain (its candidates share the rest); ``seqs [B, C, L]``
    int32 and ``scores [B, C]`` written once.  Bytes are the elements'
    own.  Operations: the slots' exits (2 W a slot) and a linear pass of
    the selection over the Q slots — bytes bound it by far.
    ``latency_floor`` is the chase's dependent loads."""
    n, n_s, w = tabs.bands.shape
    b, c, max_words = seqs.shape
    q = int(tabs.node_slot.shape[0])
    named = int(torch.unique(tabs.node_slot[tabs.slot_valid]).numel())
    n_exit = min(w - 1, n_s - 1)
    chased = int(((seqs >= 0).sum(2) - 1).clamp(min=0).amax(1).sum()) \
        if c else 0
    n_bytes = (8 * b * named * n_exit + 4 * named * n_exit + 9 * q
               + 8 * chased + 4 * b * c * max_words + 4 * b * c)
    out = bound_ms(n_bytes, b * q * (2 * w + 2), "float32")
    out.update(named_nodes=named, rows_entries_chased=chased)
    out["latency_floor"] = f"{max_words - 1} dependent loads a candidate"
    return out


def finalize_case(dec: DeviceBeamDecoder, carry, prev, word, nbest: int,
                  reps: int = 21, plain_reps: int = 3) -> dict:
    """The n-best kernel (``dec._finalize`` on the card) against its plain
    version (``dec._finalize_plain``) on the same carry and rows: ``seqs``
    and ``scores`` must be equal bit for bit, or this raises.  ``ms``: one
    event pair around a wrapper call (median of ``reps``); ``kernel_ms``:
    the kernel alone under the profiler; ``plain_ms``: host ms of the plain
    version, synchronised."""
    tabs = dec._prep_device()
    n_cand = dec._n_cand(nbest)
    b, t = prev.shape

    def kernel():
        return dec._finalize(tabs, carry, prev, word, n_cand)

    def plain():
        return dec._finalize_plain(tabs, carry, prev, word, n_cand)

    before = dk.decoder_finalize_cuda.launches
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    equal = dict(seqs=bool(torch.equal(got[0], want[0])),
                 scores=bool(torch.equal(got[1], want[1])))
    q = int(tabs.node_slot.shape[0])
    c, r = dk.finalize_sizes(q, n_cand)
    lm = ("none" if dec.lm is None else
          "sparse" if tabs.lm_sparse is not None else "flat")
    line = dict(b=b, t=t, n_nodes=int(tabs.bands.shape[0]), slots=q, lm=lm,
                return_nbest=nbest, n_cand=c, r_fin=r,
                max_words=dec.max_words, pruned=dec._prune_on,
                rows_in_smem=dk.finalize_rows_in_smem(q, t, n_cand), equal=equal,
                max_abs_err=float((got[1] - want[1]).abs().max()),
                valid_candidates=int((got[1] > -1e30 / 2).sum()),
                words=int((got[0] >= 0).sum()))
    check(all(equal.values()), f"n-best kernel vs plain version: {line}")
    line.update(ms=median_ms(kernel, reps=reps),
                kernel_ms=kernel_device_ms(kernel, "decoder_finalize"),
                plain_ms=synced_ms(plain, reps=plain_reps)[1],
                library_ms=None,
                **finalize_bound(tabs, got[0]))
    line["launches"] = dk.decoder_finalize_cuda.launches - before
    return line


def phase_finalize(seed: int, smi: str) -> dict:
    """The n-best kernel against its plain version, bit for bit, at the
    decode cell (XIF_tone, 606 senones, 8 mixtures, the built-in 125-node
    lexicon, 256 x 4 s of noise: B = 256, T = 319) with no LM, a flat and a
    sparse bigram LM, each at ``return_nbest`` 1 and 5; and over the
    21,589- and 40,000-node ``synthetic_lexicon`` (Q past 20,000 slots) at
    ``return_nbest`` 1 and 5.  Then one decode call at the decode
    cell under the profiler: its launches and where its time goes.
    Returns the ``kernels`` record of the decode cell's case."""
    phase_t0 = time.perf_counter()
    dec, _ = full_width_decoder(seed, "cuda")
    tabs = dec._prep_device()
    feats, n_frames = noise_features(seed)
    scores = dec._scores(feats)
    lm = builtin_bigram(seed)
    lines = {}
    for kind, the_lm in (("none", None), ("flat", TableLM(lm)),
                         ("sparse", lm)):
        d = dec if the_lm is None else DeviceBeamDecoder(
            dec.bank, dec.lexicon, lm=the_lm, lm_weight=3.0,
            word_penalty=1.0)
        t = d._prep_device()
        carry, prev, word = d._scan(t, d._seed(t, scores.shape[0]), scores,
                                    0, n_frames)
        for nbest in (1, 5):
            lines[f"decode_{kind}_n{nbest}"] = finalize_case(
                d, carry, prev, word, nbest)
    inv = UnitInventory.standard("XIF_tone")
    for name, min_nodes in (("21k", None), ("40k", 40_000)):
        flat, _, _ = synthetic_lexicon(inv, **({} if min_nodes is None else
                                               dict(min_nodes=min_nodes)))
        big = DeviceBeamDecoder(dec.bank, flat)
        t = big._prep_device()
        carry, prev, word = big._scan(t, big._seed(t, scores.shape[0]),
                                      scores, 0, n_frames)
        for nbest in (1, 5):
            lines[f"exact_{name}_n{nbest}"] = finalize_case(
                big, carry, prev, word, nbest, reps=5)
        del carry, prev, word, big
    for name, line in lines.items():
        say("decoder_finalize", case=name, **line)
    reset_kernel_counts()
    profile, events = device_profile(
        lambda: dec.decode_batch(feats, n_frames), events=True)
    check(dk.decoder_finalize_cuda.launches == 1
          and dk.decoder_scan_cuda.launches == 1,
          f"one scan and one n-best launch in a decode call: "
          f"{kernel_counts()}")
    # where a decode call's wall goes: the host's enqueue, the wait for the
    # card, the copies of seqs and scores, the host's id -> word mapping
    marks = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        handle = dec.decode_dispatch(feats, n_frames)
        t.append(time.perf_counter())
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        seqs, sc = handle[0].cpu().numpy(), handle[1].cpu().numpy()
        t.append(time.perf_counter())
        dec._to_hypotheses(seqs, sc, handle[2], handle[3])
        t.append(time.perf_counter())
        marks.append(np.diff(t) * 1e3)
    split = dict(zip(("dispatch_host_ms", "device_wait_ms", "copy_ms",
                      "to_hypotheses_ms"), np.median(marks, axis=0).tolist()))
    say("decoder_finalize_summary", source=dk.SOURCE,
        replaces=dk.FINALIZE_REPLACES,
        decode_call_profile=profile, decode_call_events=events,
        decode_call_split_median_of_5=split,
        decode_call_launches=profile.get("kernels", "not measured"),
        phase_seconds=time.perf_counter() - phase_t0,
        device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    del scores, feats
    torch.cuda.empty_cache()
    keys = ("max_abs_err", "ms", "kernel_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    record = {k: lines["decode_none_n1"][k] for k in keys}
    # the large lexicons' (21,589 and 40,000 nodes, Q past 20,000) beside
    for name in ("exact_21k_n1", "exact_21k_n5", "exact_40k_n1"):
        record[name] = {k: lines[name][k] for k in ("slots", *keys)}
    return {"finalize": record}


# ----------------------------------------------------------------------
# the shapes past the kernels' first designs
SHAPES_STATE_NUM = 10       # 18 token states a node, 1,616 senones
SHAPES_S = 29500       # scores rows past the scan's shared memory
SHAPES_MAX_L = 366       # N = 2 + 366 * 3 = 1,100 sentence states


def widened_bank(bank: sb.SenoneBank, n_senones: int, seed: int):
    """``bank`` with its senones spread over ``n_senones`` (the rest random
    copies of them), the highest one in use: each frame's scores row is
    past the frame scan's shared memory, and the senones read reach its
    end."""
    arrays = sb.bank_to_numpy(bank)
    rng = np.random.default_rng(seed)
    s = arrays["means"].shape[0]
    ids = np.sort(rng.choice(n_senones, size=s, replace=False))
    ids[-1] = n_senones - 1
    src = rng.integers(0, s, size=n_senones)
    src[ids] = np.arange(s)
    for f in ("means", "log_var", "log_w", "mix_counts"):
        arrays[f] = arrays[f][src]
    arrays["senone_map"] = ids[arrays["senone_map"]].astype(np.int32)
    return sb.bank_from_numpy(arrays, device="cuda")


def plain_decode(dec: DeviceBeamDecoder, feats, n_frames):
    """``dec.decode_batch`` with the frame scan and the n-best in their
    plain versions (``_scan_plain``, ``_finalize_plain``) on the card."""
    dec._scan, dec._finalize = dec._scan_plain, dec._finalize_plain
    try:
        return dec.decode_batch(feats, n_frames)
    finally:
        del dec._scan, dec._finalize


def shapes_decode(dec: DeviceBeamDecoder, feats, n_frames, name: str,
                  chunks: int = 1) -> dict:
    """One decode call and ``chunks`` 25-frame stream chunks with their
    result through ``dec`` (enough frames for a word of the lexicon to
    end): the scan and n-best kernels' launches, the 1-best, which must be
    the words and scores of the same call through the plain versions."""
    reset_kernel_counts()
    hyps, wall_ms = synced_ms(lambda: dec.decode_batch(feats, n_frames))
    call = kernel_counts()
    reset_kernel_counts()
    st = dec.stream_init(batch=1, max_frames=CHUNK * chunks)
    for lo in range(0, CHUNK * chunks, CHUNK):
        dec.stream_feed(st, feats[:1, lo:lo + CHUNK])
    chunk_hyps = dec.stream_result(st, 1)
    stream = kernel_counts()
    check(call["scan"] == 1 and call["fin"] == 1 and stream["scan"] == chunks
          and stream["fin"] == 1,
          f"{name}: the decode call and the stream chunks ran the frame scan "
          f"and the n-best on the card: {call}, {stream}")
    check(all(len(h) >= 1 and np.isfinite(h[0].score) for h in hyps)
          and len(chunk_hyps[0]) >= 1, f"{name}: every utterance decoded")
    want = plain_decode(dec, feats, n_frames)
    check([[(h.words, h.score) for h in u] for u in hyps]
          == [[(h.words, h.score) for h in u] for u in want],
          f"{name}: the decode call's words and scores are the plain "
          f"versions'")
    return dict(decode_call_ms=wall_ms,
                scan_launches=call["scan"] + stream["scan"],
                stream_scan_launches=stream["scan"],
                finalize_launches=call["fin"] + stream["fin"],
                same_as_plain=True,
                one_best=["".join(h[0].words) for h in hyps[:4]])


def phase_shapes(seed: int, smi: str) -> dict:
    """The kernels at the shapes their first designs refused, each held to
    its plain version on the card: the frame scan at ``state_num = 10`` (18
    token states a node: the states in place in the carry) at the decode
    cell's width (256 x 4 s, 8 mixtures, 39 dims, the built-in lexicon),
    and over a bank of 29,500 senones (each frame's scores row read from
    device memory; 32 x 4 s); the device-memory route (a carry no on-chip
    cluster of 16 holds, the utterance over a cluster all the same) at
    ``state_num = 10`` over the 21,589-node lexicon (8 x 4 s, and a 25-frame
    chunk at B = 1) and at the default topology over 40,000 nodes (8 x
    4 s); a decode call (its words held to the plain versions') and a
    stream chunk through each; and forward, backward and
    Viterbi at N = 1,100 sentence states
    (the block route over a cluster; labels of up to 366 units,
    64 x 4 s), timed, with
    their launches in one E-step and one alignment at that length.
    Returns the ``kernels`` records."""
    phase_t0 = time.perf_counter()
    cfg = Config()
    cfg.model.state_num = SHAPES_STATE_NUM
    cfg.model.mix_level = cfg.model.max_mix_level = M
    inv = UnitInventory.standard("XIF_tone")
    bank = sb.create_bank(len(inv), cfg.model, D,
                          generator=torch.Generator().manual_seed(seed),
                          device="cuda")
    lex = PronunciationLexicon()
    lex.generate(list(BUILTIN_PINYIN), PinYin())
    flat = FlatLexicon.from_tree(lex.lexicon, inv)
    feats, n_frames = noise_features(seed)
    dec = DeviceBeamDecoder(bank, flat)
    tabs = dec._prep_device()
    n, n_s, w = tabs.bands.shape
    check(n_s == 18 and not dk.states_in_regs(n_s, w),
          f"state_num = 10: {n_s} token states, in place in the carry")
    lines = {"state_num_10": scan_case(dec, dec._scores(feats), n_frames)}
    paths = {"state_num_10": shapes_decode(dec, feats, n_frames, "state_num 10")}
    big, _, _ = synthetic_lexicon(inv)
    dec = DeviceBeamDecoder(bank, big)
    b = 8
    x, nf = feats[:b].contiguous(), n_frames[:b]
    sc = dec._scores(x)
    lines["global"] = scan_case(dec, sc, nf, reps=3)
    # three chunks: a word of up to six units of 8 emitting states ends
    paths["global"] = shapes_decode(dec, x, nf, "state_num 10, 21,589 nodes",
                                    chunks=3)
    # one stream chunk at B = 1 (t0 = 25, from the first chunk's carry)
    tabs = dec._prep_device()
    carry, *rows = dec._scan(tabs, dec._seed(tabs, 1), sc[:1, :CHUNK]
                             .contiguous(), 0, nf[:1])
    lines["global_chunk_b1"] = scan_case(
        dec, sc[:1, CHUNK:2 * CHUNK].contiguous(),
        np.clip(nf[:1] - CHUNK, 0, CHUNK), t0=CHUNK, carry=carry,
        rows_before=rows, reps=21, plain_reps=3)
    # its launches on the path: the B = 1 stream's three chunks above,
    # counted from zero before the stream
    paths["global_chunk_b1"] = dict(
        scan_launches=paths["global"]["stream_scan_launches"])
    del dec, bank, big, sc, carry, rows
    # the default topology past the cluster route: more nodes than 16 CTAs
    # of SCAN_THREADS x NODES_PER_THREAD hold
    cfg = Config()
    cfg.model.mix_level = cfg.model.max_mix_level = M
    base = sb.create_bank(len(inv), cfg.model, D,
                          generator=torch.Generator().manual_seed(seed),
                          device="cuda")
    huge, _, _ = synthetic_lexicon(inv, min_nodes=40_000)
    dec = DeviceBeamDecoder(base, huge)
    tabs = dec._prep_device()
    check(tabs.bands.shape[0] >= 40_000
          and not plan_at(tabs, S, 1, b)["onchip"],
          f"{tabs.bands.shape[0]} nodes of 8 states: past the on-chip routes")
    lines["global_40k"] = scan_case(dec, dec._scores(x), nf, reps=3)
    paths["global_40k"] = shapes_decode(dec, x, nf, "40,000 nodes")
    del dec, huge
    for name in ("global", "global_chunk_b1", "global_40k"):
        plan = lines[name]["plan"]
        check(lines[name]["route"] == "global"
              and (plan["cluster"] > 1
                   or lines[name]["b"] * 2 > torch.cuda.get_device_properties(
                       0).multi_processor_count),
              f"{name}: the carry in device memory over more than one CTA "
              f"an utterance ({plan})")

    wide = widened_bank(base, SHAPES_S, seed)
    dec = DeviceBeamDecoder(wide, flat)
    tabs = dec._prep_device()
    plan = plan_at(tabs, SHAPES_S, 1, 32)
    check(not plan["rows_smem"] and plan["route"] == "smem",
          f"29,500 senones: the scores rows in device memory, the carry on "
          f"one CTA: {plan}")
    b = 32
    x, nf = feats[:b].contiguous(), n_frames[:b]
    lines["s29500"] = scan_case(dec, dec._scores(x), nf)
    paths["s29500"] = shapes_decode(dec, x, nf, "29,500 senones")
    del dec, wide, base
    for name, line in lines.items():
        say("shapes_decoder_scan", case=name, **line, **paths[name])

    gen = torch.Generator().manual_seed(seed)
    band, log_pi, log_b, masks = dp_inputs(gen, 64, TRAIN_T, SHAPES_MAX_L)
    b, t, n = (int(v) for v in log_b.shape)
    check(n == 1100 and n > 1024, f"N = {n} sentence states")
    calls = {
        "forward": (lambda: hk.forward_banded_cuda(band, log_pi, log_b, masks,
                                                   TRAIN_W),
                    lambda: hmm_ops.forward_log_banded_plain(
                        band, log_pi, log_b, masks, TRAIN_W)),
        "backward": (lambda: hk.backward_banded_cuda(band, log_b, masks,
                                                     TRAIN_W),
                     lambda: hmm_ops.backward_log_banded_plain(
                         band, log_b, masks, TRAIN_W)),
        "viterbi": (lambda: hk.viterbi_banded_cuda(band, log_pi, log_b, masks,
                                                   TRAIN_W),
                    lambda: hmm_ops.viterbi_log_banded_plain(
                        band, log_pi, log_b, masks, TRAIN_W)),
    }
    dp = {}
    for name, (kernel, plain) in calls.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err, ok, tol = compare_dp(name, got, want)
        exact = (all(torch.equal(g, w_) for g, w_ in zip(got, want))
                 if name == "viterbi" else None)
        check(ok and exact is not False, f"{name} block route vs plain at "
              f"N = {n}: {err}")
        dp[name] = dict(kernel=name, b=b, t=t, n_s=n, w=TRAIN_W,
                        max_abs_err=err, tol=tol, ok=bool(ok),
                        viterbi_bit_equal=exact,
                        ms=median_ms(kernel, reps=11),
                        kernel_ms=kernel_device_ms(kernel, name, reps=10),
                        plain_ms=median_ms(plain, reps=3), library_ms=None,
                        **hmm_bound(name, b, t, n, TRAIN_W))
        say("shapes_hmm_kernel_vs_plain", **dp[name])
    del band, log_pi, log_b, masks
    # the training path at that label length: one E-step and one alignment
    train_launches = training_path_launches(gen, SHAPES_MAX_L)
    say("shapes_summary", dp_launches_training_path=train_launches,
        dp_max_n=hk._lib().hmm_banded_max_n(),
        ptxas_registers_spill_stores_loads=dict(
            scan=PTXAS.get("decoder_scan", "not rebuilt"),
            dp={k: v for k, v in PTXAS.get("hmm_banded", {}).items()
                if "block_kernel" in k}),
        phase_seconds=time.perf_counter() - phase_t0,
        device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    torch.cuda.empty_cache()
    records = {f"scan_{k}": dict(scan_record(v),
                                 launches=paths[k]["scan_launches"])
               for k, v in lines.items()}
    # the device-memory route: its decode-call case, with the B = 1 chunk's
    # and the 40,000-node case's beside
    for k in ("global_chunk_b1", "global_40k"):
        records["scan_global"][k] = records.pop(f"scan_{k}")
    for k, v in dp.items():
        records[f"{k}_n1100"] = dict(
            launches=train_launches[k],
            **{f: v[f] for f in ("max_abs_err", "ms", "kernel_ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")})
    return records


SOLO = {
    "hmm_kernels": lambda seed, smi: phase_hmm_kernels(seed),
    "sentence": phase_sentence,
    "stats": phase_stats,
    "host_decode": phase_host_decode,
    "train_throughput": phase_train_throughput,
    "train_scheme1": phase_train_scheme1,
    "stream": phase_stream,
    "pruned": phase_pruned,
    "cd_e2e": lambda seed, smi: phase_cd_e2e(seed),
    "cd_throughput": phase_cd_throughput,
    "parallel": phase_parallel,
    "decoder_scan": phase_decoder_scan,
    "scan_times": phase_scan_times,
    "finalize": phase_finalize,
    "shapes": phase_shapes,
    "block_sweep": phase_block_sweep,
    "assoc": phase_assoc,
    "frontend": phase_frontend_precision,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=sorted(SOLO), help="after the build "
                    "run this phase alone, --repeat times, and print no "
                    "result line: for holding two checkouts against each "
                    "other on one machine, alternating between them")
    ap.add_argument("--repeat", type=int, default=1)
    # one rank of the parallel phase's four (started by that phase)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dir", help=argparse.SUPPRESS)
    # the stream phase's fresh process
    ap.add_argument("--first-result", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        parallel_rank(args.rank, args.port, args.dir, args.seed)
        return 0
    if args.first_result:
        first_stream_result(args.seed)
        return 0

    smi = phase_device()
    phase_build()
    if args.only:
        for _ in range(args.repeat):
            SOLO[args.only](args.seed, smi)
        return 0
    records = phase_kernel(args.seed)
    records["sentence"] = phase_sentence(args.seed, smi)
    records["stats"] = phase_stats(args.seed, smi)
    records.update(phase_hmm_kernels(args.seed))
    records.update(phase_decoder_scan(args.seed, smi))
    records.update(phase_finalize(args.seed, smi))
    records.update(phase_shapes(args.seed, smi))
    phase_known_answer(args.seed)
    launches, dec = phase_serve(args.seed)
    tp_launches = phase_throughput(args.seed, dec, smi)
    del dec
    torch.cuda.empty_cache()
    host_launches = phase_host_decode(args.seed, smi)
    train_launches = phase_train_throughput(args.seed, smi)
    phase_train_e2e(args.seed)
    phase_train_scheme1(args.seed, smi)
    phase_scheme1_e2e(args.seed)
    stream_launches = phase_stream(args.seed, smi)
    pruned_launches = phase_pruned(args.seed, smi)
    assoc_records = phase_assoc(args.seed, smi)
    phase_frontend_precision(args.seed, smi)
    phase_cli(args.seed)
    phase_wer_e2e(args.seed)
    phase_cd_e2e(args.seed)
    cd_launches = phase_cd_throughput(args.seed, smi)
    par_launches = phase_parallel(args.seed, smi)
    check("jax" not in sys.modules, "jax was never imported")
    check(not [m for m in sys.modules if m.split(".")[0] == "poccala_tpu"],
          "nothing of the JAX package was imported")

    kernels = [dict(name="gmm_log_scores", route="cuda", source=gk.SOURCE,
                    replaces=gk.REPLACES, launches=launches["gmm"],
                    launches_host=host_launches,
                    launches_parallel=par_launches["gmm"],
                    **records["float32"]),
               dict(name="gmm_log_scores_bf16", route="cuda",
                    source=gk.SOURCE, replaces=gk.REPLACES,
                    launches=tp_launches["bf16"], **records["bfloat16"])]
    # the same two kernels at the context-dependent bank's shape, with
    # their launches on the CD path
    kernels += [dict(name="gmm_log_scores_cd", route="cuda", source=gk.SOURCE,
                     replaces=gk.REPLACES, launches=cd_launches["gmm"],
                     **records["float32_cd"]),
                dict(name="gmm_log_scores_bf16_cd", route="cuda",
                     source=gk.SOURCE, replaces=gk.REPLACES,
                     launches=cd_launches["gmm_bf16"],
                     **records["bfloat16_cd"])]
    # the sentence kernel: two launches an epoch (E-step, alignment)
    kernels.append(dict(name="sentence_scores", route="cuda",
                        source=gk.SOURCE, replaces=SENTENCE_REPLACES,
                        launches=train_launches["sentence"],
                        **records["sentence"]))
    # the statistics kernel: one launch an E-step
    kernels.append(dict(name="sentence_stats", route="cuda",
                        source=gk.SOURCE, replaces=STATS_REPLACES,
                        launches=train_launches["stats"],
                        **records["stats"]))
    kernels += [dict(name=f"hmm_{k}_banded", route="cuda", source=hk.SOURCE,
                     replaces=hk.REPLACES[k], launches=train_launches[k],
                     launches_cd=cd_launches[k],
                     launches_parallel=par_launches[k], **records[k])
                for k in hk.KERNELS]
    # the frame scan: one CTA an utterance on the decode, stream, CD and
    # parallel paths; a cluster an utterance on the 21,589-node call (and at
    # the reference lexicon's 3,514 nodes, its times beside)
    kernels += [dict(name="decoder_scan_exact", route="cuda",
                     source=dk.SOURCE, replaces=dk.REPLACES,
                     launches=launches["scan"],
                     launches_stream=stream_launches["scan"],
                     launches_cd=cd_launches["scan"],
                     launches_parallel=par_launches["scan"],
                     **records["exact"]),
                dict(name="decoder_scan_exact_cluster", route="cuda",
                     source=dk.SOURCE, replaces=dk.REPLACES,
                     launches=pruned_launches["scan"],
                     **records["exact_cluster"])]
    check(kernels[-2]["launches_stream"] > 0
          and kernels[-2]["launches_cd"] > 0
          and kernels[-2]["launches_parallel"] > 0,
          f"the frame scan ran on the stream, CD and parallel paths: "
          f"{kernels[-2]}")
    # the n-best: one launch per decode call or stream result, every path
    kernels.append(dict(
        name="decoder_finalize", route="cuda", source=dk.SOURCE,
        replaces=dk.FINALIZE_REPLACES, launches=launches["fin"],
        launches_throughput=tp_launches["fin"],
        launches_stream=stream_launches["fin"],
        launches_cd=cd_launches["fin"],
        launches_parallel=par_launches["fin"],
        launches_pruned=pruned_launches["fin"], **records["finalize"]))
    check(all(v > 0 for k, v in kernels[-1].items()
              if k.startswith("launches")),
          f"the n-best kernel ran on every path: {kernels[-1]}")
    # the pruned scan: one launch per pruned decode call (k8, k4, k8 with
    # the sticky selection) and per pruned stream chunk; its times at k8
    # (k4's and the sticky selection's beside them)
    kernels.append(dict(
        name="decoder_scan_pruned", route="cuda", source=dk.SOURCE,
        replaces=dk.PRUNED_REPLACES, launches=pruned_launches["pruned"],
        launches_stream=pruned_launches["pruned_stream"],
        launches_stream_hysteresis=pruned_launches["pruned_stream_hyst8"],
        k4=pruned_launches["record_k4"],
        hysteresis=pruned_launches["record_hyst8"],
        **pruned_launches["record"]))
    check(kernels[-1]["launches"] == 3 and kernels[-1]["launches_stream"] > 0
          and kernels[-1]["launches_stream_hysteresis"] > 0,
          f"the pruned scan ran once a pruned call and chunk: {kernels[-1]}")
    # forward_log_assoc's semiring product and its row form: launches in
    # the call at N = 98, T = 1,600 (the other cases beside)
    kernels += [dict(name=f"hmm_lse_{key}", route="cuda", source=ak.SOURCE,
                     replaces=ak.REPLACES, **assoc_records[key])
                for key in ("product", "rows")]
    # the instantiations for those shapes, with their launches on their paths
    # (a decode call and a stream chunk; one E-step and one alignment)
    kernels += [
        dict(name="decoder_scan_exact_state_num_10", route="cuda",
             source=dk.SOURCE, replaces=dk.REPLACES,
             **records["scan_state_num_10"]),
        dict(name="decoder_scan_exact_rows_global", route="cuda",
             source=dk.SOURCE, replaces=dk.REPLACES,
             **records["scan_s29500"]),
        dict(name="decoder_scan_exact_global", route="cuda",
             source=dk.SOURCE, replaces=dk.REPLACES,
             **records["scan_global"])]
    # the block route at N = 1,100 (labels of 366 units, a cluster of
    # CTAs), with its launches in one E-step and one alignment there
    kernels += [dict(name=f"hmm_{k}_banded_block_n1100", route="cuda",
                     source=hk.SOURCE, replaces=hk.REPLACES[k],
                     **records[f"{k}_n1100"]) for k in hk.KERNELS]
    # the block route (N > 128; Viterbi also past ~850 frames): its
    # launches in one E-step and one alignment at L = 88, its times at
    # BLOCK_SHAPES (and Viterbi's at VITERBI_LONG)
    kernels += [dict(name=f"hmm_{k}_banded_block", route="cuda",
                     source=hk.SOURCE, replaces=hk.REPLACES[k],
                     **records[f"{k}_block"]) for k in hk.KERNELS]
    check(all(k["launches"] > 0 for k in kernels),
          f"every kernel was launched on its path: {kernels}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
