"""On the card (``gpu`` marker; skipped without a CUDA device): each cell
at its own size, once as the configuration states it (``correct``) and
once as its control (not ``correct``).  Run on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu asrbench/tests/test_asrbench_gpu.py
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from asrbench.harness import spec  # noqa: E402

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("control", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(cell, control, card):
    from asrbench.harness.runner import run_cell

    result, checks = run_cell(cell, 2**31 + 77, 2.0, False, device="cuda",
                              control=control)
    assert result["correct"] is (not control), checks
