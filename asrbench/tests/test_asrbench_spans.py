"""The per-layer metrics that read the program's own spans: every cell,
traced at the small sizes on the CPU, reads each of its new metrics, and
each is bounded by the harness's span around the same calls."""

import pytest
from conftest import SMALL

from asrbench.harness.runner import run_cell
from poccala_tpu_torch.utils import profiling

NEW = {
    "fullvocab_exact_offline": ("decode_map_ms.decode",
                                "decode_copy_ms.decode"),
    "cd2k_decode_offline": ("decode_map_ms.cd", "decode_copy_ms.cd"),
    "cd2k_train_long_sentences": ("estep_scoring_ms.train",
                                  "estep_fb_ms.train", "estep_stats_ms.train",
                                  "mstep_ms.train", "align_device_ms.train"),
}


@pytest.mark.parametrize("cell", list(NEW))
def test_a_traced_cell_reads_its_span_metrics(cell):
    # records live as long as the process; `asrbench/run.py` runs one cell a
    # process, so start this one's afresh
    profiling._records.clear()
    result, _ = run_cell(cell, 9, 0.2, True, device="cpu",
                         overrides=SMALL[cell])
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert all(got.get(m) is not None and got[m] > 0 for m in NEW[cell]), got
    span_ms = result["timing"]["span_ms"]
    if cell == "cd2k_train_long_sentences":
        # on the CPU a span's device ms is its host ms: the five phases
        # lie inside the harness's two spans of each step
        phases = sum(got[m] for m in NEW[cell])
        whole = span_ms["em_epoch"] + span_ms["align_pass"]
        assert 0.5 * whole < phases <= whole
    else:
        parts = sum(got[m] for m in NEW[cell])
        assert 0.5 * span_ms["decode_collect"] < parts \
            <= span_ms["decode_collect"]
