"""BENCHMARK.json against the contract's form, and the harness finding a
new cell and a new per-layer metric by their files alone."""

import json
import re
import shutil
import subprocess
import sys

from asrbench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.benchmark()


def test_names_and_units_use_allowed_characters():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w[k] for w in BENCH["workloads"]
              for k in ("name", "config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for group in ("end_to_end", "per_layer", "configs", "workloads"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        mine_e2e, mine_layer = spec.cell_metrics(BENCH, w["name"])
        names = {m["name"] for m in mine_e2e}
        assert "setup_s" in names and len(names) >= 2
        assert mine_layer, w["name"]
        for m in mine_layer:
            assert m["moves"] in e2e and m["moves"] in names, (w, m)


def test_every_name_has_its_file():
    for c in BENCH["configs"]:
        assert (spec.REPO / c["file"]).is_file()
        assert spec.config(c["name"])["source"] == c["source"]
    for w in BENCH["workloads"]:
        cell = spec.workload(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) \
            == (w["config"], w["traffic"], w["chips"], w["why"])
        assert spec.traffic(w["traffic"])["driver"]
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


DUMMY_METRIC = '''
def read(run):
    return float(run.work["flops"] > 0)
'''


def test_a_cell_and_a_metric_are_files_and_entries(tmp_path):
    """A copy of the benchmark gains a cell (a new workload file over the
    existing mix and configuration) and a per-layer metric (a new reader)
    with entries in its BENCHMARK.json and no edit to any existing file;
    the copied harness runs the new cell and reports the new metric."""
    src = spec.ROOT
    dst = tmp_path / "asrbench"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(dst): p.read_bytes()
              for p in dst.rglob("*") if p.is_file()}
    bench = json.loads((spec.REPO / "BENCHMARK.json").read_text())
    cell = json.loads((src / "workloads/cd2k_decode_offline.json").read_text())
    cell["why"] = "a second copy of the CD decode cell"
    (dst / "workloads/dummy_cell.json").write_text(json.dumps(cell))
    (dst / "metrics/dummy_metric.py").write_text(DUMMY_METRIC)
    bench["workloads"].append({"name": "dummy_cell", "config": cell["config"],
                               "traffic": cell["traffic"], "chips": 1,
                               "why": cell["why"]})
    for m in bench["end_to_end"]:
        if m["name"] == "decode_audio_s_per_s":
            m["workloads"].append("dummy_cell")
    bench["per_layer"].append({
        "name": "dummy_metric", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "whole step",
        "moves": "decode_audio_s_per_s", "workloads": ["dummy_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p.relative_to(dst): p.read_bytes()
             for p in dst.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
    from conftest import SMALL
    code = f"""
import json, sys, torch
torch.set_num_threads(1)
sys.path[:0] = [{str(tmp_path)!r}, {str(spec.REPO)!r}]
from asrbench.harness.runner import run_cell
r, _ = run_cell("dummy_cell", 5, 0.5, True, device="cpu",
                overrides={SMALL['cd2k_decode_offline']!r})
print(json.dumps(r["metrics"]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["dummy_metric"]["value"] == 1.0
    assert set(metrics) == {"dummy_metric"}
