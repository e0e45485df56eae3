"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the hand-written CUDA kernel from ``poccala_tpu_torch/csrc``,
holds it against its plain PyTorch version, and drives the port's
decode-serving path (WAV -> MFCC -> VAD -> DecodeService ->
DeviceBeamDecoder) at full model width: the XIF_tone inventory (202 units,
606 senones), 8 mixtures, 39-dim features, a random bank from a seeded
``torch.Generator`` and the built-in lexicon.  Each phase prints one line;
any failure raises, so the script exits non-zero and prints no result.
The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": ...}``.

It needs a CUDA device (there is no CPU fallback) and imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from poccala_tpu.config import Config, ModelConfig
from poccala_tpu.io import wav as wav_io
from poccala_tpu_torch.decoder.device import DeviceBeamDecoder
from poccala_tpu_torch.io.corpus import UnitInventory
from poccala_tpu_torch.lexicon import FlatLexicon, PinYin, PronunciationLexicon
from poccala_tpu_torch.lexicon.builtin_table import BUILTIN_PINYIN
from poccala_tpu_torch.models import senone_bank as sb
from poccala_tpu_torch.ops import vad as vad_ops
from poccala_tpu_torch.ops.cuda import build
from poccala_tpu_torch.ops.cuda import gmm_score_cuda as gk
from poccala_tpu_torch.ops.frontend import Frontend
from poccala_tpu_torch.ops.gmm_score import gmm_log_scores
from poccala_tpu_torch.serve import DecodeService

S, M, D = 606, 8, 39          # XIF_tone senones, mixtures, feature dim
SLICE_T = 256 * 319           # bench_decode's 256 x 4 s batch, in frames
F32_TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_pallas_kernels.py:37
BF16_TOL = dict(rtol=1e-3, atol=5e-2)  # tests/test_bf16_scoring.py:115


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


def phase_build() -> None:
    t0 = time.perf_counter()
    built = build.build("gmm_score")
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln]
    say("build", seconds=round(secs, 3), compiled=built.compiled,
        library=str(built.path.name), ptxas=ptxas)


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


def phase_kernel(seed: int) -> dict:
    """Kernel vs plain version at T = 1000 and the slice's T."""
    gen = torch.Generator().manual_seed(seed)
    record = {}
    cases = [("float32", "textbook", False), ("float32", "reference", False),
             ("float32", "textbook", True), ("bfloat16", "textbook", False),
             ("bfloat16", "reference", False)]
    for t in (1000, SLICE_T):
        for dtype, norm, floor in cases:
            x, means, log_var, log_w = scoring_inputs(t, gen, floor)
            kw = dict(normalizer=norm, score_dtype=dtype)
            got = gk.gmm_log_scores_cuda(x, means, log_var, log_w, **kw)
            want = gmm_log_scores(x, means, log_var, log_w, **kw)
            torch.cuda.synchronize()
            tol = F32_TOL if dtype == "float32" else BF16_TOL
            err = float((got - want).abs().max())
            ok = bool(torch.isfinite(got).all()) and got.shape == (t, S) \
                and bool(torch.allclose(got, want, **tol))
            line = dict(t=t, s=S, m=M, d=D, score_dtype=dtype,
                        normalizer=norm, floor_variances=floor,
                        max_abs_err=err, tol=tol, ok=ok)
            if t == SLICE_T and not floor and norm == "textbook":
                line["ms"] = median_ms(lambda: gk.gmm_log_scores_cuda(
                    x, means, log_var, log_w, **kw))
                line["plain_ms"] = median_ms(lambda: gmm_log_scores(
                    x, means, log_var, log_w, **kw))
                if dtype == "float32":
                    record = dict(max_abs_err=err, ms=line["ms"],
                                  plain_ms=line["plain_ms"])
            say("kernel_vs_plain", **line)
            check(ok, f"kernel vs plain at {line}")
            del got, want
    torch.cuda.empty_cache()
    return record


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
                     calls: int = 3) -> None:
    """bench.py:bench_decode's shape: frontend + scoring + frame loop +
    n-best per call, double-buffered dispatch/collect, host work inside
    the timed region."""
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

    audio_s = batch * utt_seconds * calls
    say("throughput", metric="decode_audio_throughput",
        value=audio_s / elapsed, unit="audio-s/s", batch=batch,
        utt_seconds=utt_seconds, calls=calls, frames=int(feats.shape[1]),
        lexicon_nodes=int(dec.lexicon.n_nodes), seconds=elapsed,
        warmup_seconds=warm_s,
        breakdown_ms=dict(frontend=ev[0].elapsed_time(ev[1]),
                          scoring=ev[1].elapsed_time(ev[2]),
                          decode_call_with_scoring=ev[2].elapsed_time(ev[3])),
        decode_call_profile=busy, device=torch.cuda.get_device_name(0), nvidia_smi=smi)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    smi = phase_device()
    phase_build()
    record = phase_kernel(args.seed)
    phase_known_answer(args.seed)
    launches, dec = phase_serve(args.seed)
    phase_throughput(args.seed, dec, smi)
    check("jax" not in sys.modules, "jax was never imported")

    kernel = dict(name="gmm_log_scores", route="cuda", source=gk.SOURCE,
                  replaces=gk.REPLACES, launches=launches, **record)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
