"""The full-vocabulary CD cell (``cd6k_fullvocab_exact_offline``) and the
two metrics that read the decode call's device phases: the cell judged
``correct`` at a small size on the CPU (and its control not), its traced
run reading ``decode_score_ms`` and ``decode_scan_ms`` from the program's
spans (and the decode call's host metrics), the readers' silence where the program has no such span, and the
yardstick's bounds at the cell's own sizes against hand counts."""

import numpy as np
import pytest

from asrbench.harness import spec
from asrbench.harness import yardstick as y
from asrbench.harness.model import build_model
from asrbench.harness.runner import run_cell
from asrbench.harness.traffic import lengths_s
from poccala_tpu_torch.utils import profiling

CELL = "cd6k_fullvocab_exact_offline"
# the configuration cut to a small size: 10 syllables (a 379-node tree of
# within-word triples), 64 senones x 4 mixtures; six utterances a batch
SMALL = {"config": {"lexicon": {"syllables": 10, "min_nodes": 200},
                    "senones": 64, "mixtures": 4},
         "traffic": {"batch": 6, "batches": 2,
                     "seconds": {"median": 0.8, "lo": 0.5, "hi": 1.0}}}
NEW = ("decode_score_ms", "decode_scan_ms")
# the decode call's host metrics, read in this cell as in cell 1
CALL = ("decode_collect_ms.decode", "decode_map_ms.decode",
        "decode_copy_ms.decode")


def test_the_cell_reports_the_decode_metrics():
    bench = spec.benchmark()
    e2e, layer = spec.cell_metrics(bench, CELL)
    assert {m["name"] for m in e2e} == {"decode_audio_s_per_s", "setup_s"}
    assert {m["name"] for m in layer} == {
        "decoder_scan_roofline", "gmm_score_roofline", "decode_mfu",
        "device_idle_pct.decode", *NEW, *CALL}
    cell = spec.workload(CELL)
    assert cell["chips"] == 1 and cell["limits"] == {"missing": 0,
                                                     "answer_gap": 1e-05}
    cfg = spec.config(cell["config"])
    assert (cfg["senones"], cfg["mixtures"], cfg["dim"], cfg["reduced"]) \
        == (6000, 32, 39, [])


@pytest.mark.parametrize("control", [False, True])
def test_small_run_is_judged(control):
    result, checks = run_cell(CELL, 2**31 + 4242, 0.3, False, device="cpu",
                              overrides=SMALL, control=control)
    assert result["correct"] is (not control), checks
    assert result["attempted"] > 0 and result["failed"] == 0


def test_a_traced_run_reads_the_phases():
    # records live as long as the process; `asrbench/run.py` runs one cell
    # a process, so start this one's afresh
    profiling._records.clear()
    result, _ = run_cell(CELL, 23, 0.2, True, device="cpu", overrides=SMALL)
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert all(got.get(m) is not None and got[m] > 0 for m in NEW + CALL), \
        got
    # on the CPU a span's device ms is its host ms: scoring and the scan
    # lie inside the dispatch of each call
    dispatch = result["timing"]["span_ms"]["decode_dispatch"]
    assert 0.5 * dispatch < got["decode_score_ms"] + got["decode_scan_ms"] \
        <= dispatch


@pytest.mark.parametrize("name", NEW)
def test_readers_are_silent_without_the_spans(name, monkeypatch):
    """An older program (no such span, or no span module at all)."""
    monkeypatch.setattr(profiling, "recorded", lambda name: [])
    assert spec.metric_reader(name)(None) is None


def test_bounds_at_the_cell_sizes_by_hand():
    cfg = spec.config("cd_tied6k_m32_fullvocab")
    mix = spec.traffic("offline_read_b128")
    model = build_model(cfg, 1)
    lex = model.lexicon
    b, t_pad, s, m, d = 128, 852, 6000, 32, 39
    n, n_s, w, q = lex.n_nodes, 8, 2, len(lex.word_node)
    n_sen = int(np.unique(model.senone_map[lex.node_units[1:]]).size)
    assert (n, q, n_sen) == (31176, 21466, 5997)
    lengths = [round(x * 80) for x in lengths_s(mix["seconds"], b)]
    frames = int(sum(lengths))
    assert frames == 45694 and max(lengths) == t_pad
    # GMM: 2·T·2D·S·M operations of 109,056 padded frames, 3.27 TFLOP at
    # 67 TFLOP/s; the [T, S] scores' 2.6 GB are 0.78 ms
    t = b * t_pad
    gmm = y.gmm_bound(t, s, m, d, "float32")
    assert gmm["bound_by"] == "operations"
    assert gmm["bound_ms"] == pytest.approx(2 * t * 2 * d * s * m / 67e9)
    assert gmm["bound_ms"] == pytest.approx(48.753, abs=1e-3)
    # the scan: (2W + 4) operations a token state and valid frame
    scan = y.scan_bound(n, n_s, w, q, n_sen, b, t_pad, frames)
    n_bytes = (4 * frames * n_sen + 4 * b + 16 * b * n * n_s + 8 * b * t_pad
               + 4 * n * n_s * (w + 1) + 5 * n + 9 * q)
    assert scan["bound_by"] == "operations" and n_bytes / 3.35e9 < 0.5
    assert scan["bound_ms"] == pytest.approx(frames * n * n_s * 8 / 67e9)
    assert scan["bound_ms"] == pytest.approx(1.3608, abs=1e-4)
