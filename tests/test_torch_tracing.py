"""The port's spans (``poccala_tpu_torch/utils/profiling.py``): silent and
free with no profiler active, recorded under any ``torch.profiler``
profile with their parents, on the trace's timeline only inside
``profiling.trace``, and no change to what they enclose.

The file imports no jax; its ``gpu`` test runs on a card with

    python -m pytest --noconftest -m gpu tests/test_torch_tracing.py
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from poccala_tpu_torch.config import Config, ModelConfig
from poccala_tpu_torch.decoder.device import DeviceBeamDecoder
from poccala_tpu_torch.io.corpus import Batch, UnitInventory
from poccala_tpu_torch.lexicon import FlatLexicon, PinYin, PronunciationLexicon
from poccala_tpu_torch.models import senone_bank as sb
from poccala_tpu_torch.train import alignment
from poccala_tpu_torch.train.trainer import Trainer
from poccala_tpu_torch.utils import profiling

torch.set_num_threads(1)

# the call's device phases (inside decode.dispatch), then its host part
PHASES = ("decode.score", "decode.scan", "decode.finalize")
DECODE = ("decode.dispatch",) + PHASES + ("decode.copy", "decode.map")
ESTEP = ("train.estep.scoring", "train.estep.forward_backward",
         "train.estep.statistics")
TRAIN = ("train.epoch", "train.mstep") + ESTEP
ALL = DECODE + TRAIN + ("train.align",)


def counts():
    return {n: len(profiling.recorded(n)) for n in ALL}


def added(before):
    return {n: c - before[n] for n, c in counts().items() if c != before[n]}


def decoder_and_feats():
    """Six units, three words, two utterances of well-separated frames."""
    rng = np.random.default_rng(0)
    d = 8
    units = ["n", "i3", "h", "ao3", "m", "a1"]
    cfg = ModelConfig(state_num=5, mix_level=1, max_mix_level=1)
    arrays = sb.bank_to_numpy(sb.create_bank(len(units), cfg, d,
                                             differentiation=False,
                                             device="cpu"))
    emb = rng.normal(size=(len(units), d)).astype(np.float32) * 4
    arrays["means"] = np.repeat(emb, cfg.state_num - 2, axis=0)[:, None, :]
    lex = PronunciationLexicon()
    lex.generate(["你好", "你", "马"],
                 PinYin({"你": ["ni3"], "好": ["hao3"], "马": ["ma1"]}))
    dec = DeviceBeamDecoder(sb.bank_from_numpy(arrays, device="cpu"),
                            FlatLexicon.from_tree(lex.lexicon,
                                                  UnitInventory(units)))

    def utt(ids):
        return np.concatenate([emb[u] + rng.normal(size=(12, d)) * 0.3
                               for u in ids]).astype(np.float32)

    return dec, np.stack([utt([0, 1, 2, 3]), utt([4, 5, 4, 5])])


def words(hyps):
    return [[(h.words, h.score) for h in u] for u in hyps]


def trainer_and_batches(mark=None):
    """A random bank over five units and two batches of three utterances."""
    cfg = Config()
    cfg.model.mix_level = cfg.model.max_mix_level = 2
    cfg.train.max_label_len = 3
    rng = np.random.default_rng(1)
    d = cfg.frontend.feat_dim
    tr = Trainer(cfg, UnitInventory([f"u{i}" for i in range(5)]),
                 generator=torch.Generator().manual_seed(0), device="cpu",
                 mark=mark)
    batches = []
    for _ in range(2):
        n = np.array([30, 24, 18])
        batches.append(Batch(
            feats=rng.normal(size=(3, 30, d)).astype(np.float32),
            t_masks=np.arange(30)[None] < n[:, None],
            labels=rng.integers(0, 5, size=(3, 3)).astype(np.int32),
            label_lens=np.array([3, 2, 1], np.int32)))
    return tr, batches


def test_no_profiler_records_nothing_and_allocates_nothing(monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append(1))
    assert not torch.autograd.profiler._is_profiler_enabled
    # one shared context manager, whatever the name or device
    assert profiling.span("a") is profiling.span("b", "cuda")
    with profiling.span("a", "cuda") as rec:
        assert rec is None
    before = counts()
    dec, feats = decoder_and_feats()
    dec.decode_batch(feats, [48, 48], return_nbest=2)
    tr, batches = trainer_and_batches()
    tr.scheme2_epoch(batches)
    assert added(before) == {} and not made
    assert profiling.recorded("a") == []


def test_a_bare_profile_records_each_span_without_timeline_ranges():
    dec, feats = decoder_and_feats()
    tr, batches = trainer_and_batches()
    before = counts()
    with torch.profiler.profile() as prof:
        dec.decode_collect(dec.decode_dispatch(feats, [48, 48], 2))
        dec.decode_collect(dec.decode_dispatch(feats, [48, 36], 2))
        tr.scheme2_epoch(batches)
        b = batches[0]
        alignment.align_batch(tr.bank, b.labels, b.label_lens, b.feats,
                              b.t_masks, 5, 3)
    assert added(before) == {
        **{n: 2 for n in DECODE}, "train.epoch": 1, "train.mstep": 1,
        **{n: 2 for n in ESTEP},
        "train.align": 1}
    assert profiling.recorded("train.align")[-1].parent is None
    epoch = profiling.recorded("train.epoch")[-1]
    for name in ESTEP + ("train.mstep",):
        for rec in profiling.recorded(name)[-(1 + (name in ESTEP)):]:
            assert rec.parent is epoch
            assert epoch.start_ns <= rec.start_ns <= rec.end_ns \
                <= epoch.end_ns
            # on the CPU the work runs as it is called: device ms is host ms
            assert rec.events is None and rec.device_ms == rec.host_ms > 0
    assert epoch.parent is None
    assert not [e.name for e in prof.events()
                if e.name.startswith("poccala/")]
    # the profile has ended: spans are silent again
    again = counts()
    dec.decode_batch(feats, [48, 48])
    assert added(again) == {}


def test_the_decode_call_phases_nest_in_its_dispatch():
    """Under a profile, each call's ``decode.score``, ``decode.scan`` and
    ``decode.finalize`` record once, in that order, inside its
    ``decode.dispatch``; with none they record nothing."""
    dec, feats = decoder_and_feats()
    before = counts()
    dec.decode_batch(feats, [48, 48])
    assert added(before) == {}
    with torch.profiler.profile():
        for n in ([48, 48], [48, 30]):
            dec.decode_collect(dec.decode_dispatch(feats, n))
    assert added(before) == {n: 2 for n in DECODE}
    for k, call in enumerate(profiling.recorded("decode.dispatch")[-2:]):
        phases = [profiling.recorded(n)[-2 + k] for n in PHASES]
        at = call.start_ns
        for rec in phases:
            assert rec.parent is call and at <= rec.start_ns <= rec.end_ns
            # on the CPU the work runs as it is called: device ms is host ms
            assert rec.events is None and rec.device_ms == rec.host_ms > 0
            at = rec.end_ns
        assert at <= call.end_ns and call.parent is None


def test_a_decode_on_the_cpu_counts_no_scan_launch():
    """The frame scan's counters count the kernel's launches alone: a
    decode on the CPU (the plain loop), under a profile or not, leaves
    ``launches`` and ``launches_global`` (its device-memory share) as they
    were.  ``tests/test_torch_gpu.py`` counts them on the card."""
    from poccala_tpu_torch.ops.cuda import decoder_scan_cuda as dk

    dec, feats = decoder_and_feats()
    scan = dk.decoder_scan_cuda
    before = (scan.launches, scan.launches_global)
    dec.decode_batch(feats, [48, 48])
    with torch.profiler.profile():
        dec.decode_collect(dec.decode_dispatch(feats, [48, 30]))
    assert (scan.launches, scan.launches_global) == before


def test_trace_puts_the_spans_on_the_timeline(tmp_path):
    dec, feats = decoder_and_feats()
    with profiling.trace(str(tmp_path)):
        dec.decode_batch(feats, [48, 48])
    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"poccala/" + n for n in DECODE} <= names
    # and only inside it
    with torch.profiler.profile() as prof:
        dec.decode_batch(feats, [48, 48])
    assert not [e.name for e in prof.events()
                if e.name.startswith("poccala/")]


def test_outputs_are_bit_equal_with_recording_on_and_off():
    dec, feats = decoder_and_feats()
    off = dec.decode_batch(feats, [48, 40], return_nbest=3)
    with torch.profiler.profile():
        on = dec.decode_batch(feats, [48, 40], return_nbest=3)
    assert words(on) == words(off) and off[0]
    banks, lls = [], []
    for profiled in (False, True):
        tr, batches = trainer_and_batches()
        if profiled:
            with torch.profiler.profile():
                lls.append(tr.scheme2_epoch(batches))
        else:
            lls.append(tr.scheme2_epoch(batches))
        banks.append(sb.bank_to_numpy(tr.bank))
    assert lls[0] == lls[1]
    for k in banks[0]:
        assert np.array_equal(banks[0][k], banks[1][k]), k


def test_scheme2_epoch_passes_its_phases_to_mark():
    marks = []
    tr, batches = trainer_and_batches(mark=marks.append)
    tr.scheme2_epoch(batches)
    phases = ["scoring", "forward_backward", "statistics"]
    assert marks == phases * 2 + ["m_step"]


def test_spans_of_two_threads_do_not_nest():
    inside, done = threading.Event(), threading.Event()

    def other():
        with profiling.span("thread.b"):
            inside.set()
            done.wait(10)

    with torch.profiler.profile():
        with profiling.span("thread.a"):
            t = threading.Thread(target=other)
            t.start()
            assert inside.wait(10)
            with profiling.span("thread.a.child"):
                pass
            done.set()
            t.join(10)
    assert not t.is_alive()
    a, = profiling.recorded("thread.a")[-1:]
    b, = profiling.recorded("thread.b")[-1:]
    child, = profiling.recorded("thread.a.child")[-1:]
    assert b.parent is None and child.parent is a and a.parent is None


@pytest.mark.gpu
def test_device_ms_of_a_span_covers_its_matmuls():
    """The events' interval is positive and no longer than the host's
    interval from the span's entry to the end of a synchronise after it
    (the span's host time plus what was still queued)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: spans time it by CUDA events")
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.randn(2048, 2048, device="cuda")
    (a @ a).sum().item()
    with torch.profiler.profile():
        torch.cuda.synchronize()
        with profiling.span("gpu.matmul", a.device) as rec:
            for _ in range(10):
                b = a @ a
        assert not torch.cuda.current_stream().query()  # no synchronise
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    dev_ms = rec.device_ms
    assert b.is_cuda and rec.events is not None
    assert 0 < dev_ms <= (t1 - rec.start_ns) * 1e-6
    # ten 2048^3 float32 products are ~0.17 GFLOP each: well over 0.1 ms
    assert dev_ms > 0.1
