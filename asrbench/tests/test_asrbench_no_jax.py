"""Nothing a run of the benchmark loads is JAX or the JAX package, and the
plain references import nothing of the program."""

import ast
import subprocess
import sys

from asrbench.harness import spec

REFERENCES = ("harness/ref_decode.py", "harness/ref_train.py",
              "harness/model.py", "harness/traffic.py",
              "harness/yardstick.py")


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_references_import_nothing_of_the_program():
    for rel in REFERENCES:
        names = _top_level_imports(spec.ROOT / rel)
        assert not names & {"poccala_tpu", "poccala_tpu_torch", "jax",
                            "jaxlib", "flax"}, (rel, names)


def test_a_run_loads_no_jax():
    """A whole small run of every cell, traced, in a fresh process: no
    loaded module's top-level name (compared whole: ``poccala_tpu_torch``
    is not ``poccala_tpu``) is JAX's or the JAX package's."""
    code = f"""
import sys, torch
torch.set_num_threads(1)
sys.path[:0] = [{str(spec.REPO)!r}, {str(spec.ROOT / 'tests')!r}]
from conftest import SMALL
from asrbench.harness.runner import run_cell
import asrbench.run as entry
for cell in SMALL:
    run_cell(cell, 9, 0.2, True, device="cpu", overrides=SMALL[cell])
print(",".join(entry.forbidden_modules()) or "none")
print("poccala_tpu_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2:] == ["none", "True"], lines


def test_forbidden_names_compare_whole(monkeypatch):
    import asrbench.run as entry

    monkeypatch.setitem(sys.modules, "poccala_tpu_torchlike", sys)
    assert "poccala_tpu" not in entry.forbidden_modules()
    monkeypatch.setitem(sys.modules, "poccala_tpu.ops", sys)
    assert "poccala_tpu" in entry.forbidden_modules()
