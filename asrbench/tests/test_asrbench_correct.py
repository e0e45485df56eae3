"""``correct`` at small sizes on the CPU: the program's sound run passes
each cell's limits; the control (the program's bfloat16 scoring) and each
fault the cell can have, planted underneath the timed path, fail them.

The faults: a step that returns its state unchanged; half of the batch
left out (for training, the statistics' means then taken over the rest);
an answer altered where it is produced.  No cell runs on several chips,
so there is no exchange between chips to leave out."""

import pytest

from asrbench.harness import spec
from asrbench.harness.faults import FAULTS, plant
from asrbench.harness.runner import run_cell
from conftest import SMALL

SEED = 2**31 + 12345


def _run(cell, **kw):
    result, checks = run_cell(cell, SEED, 0.3, False, device="cpu",
                              overrides=SMALL[cell], **kw)
    return result, checks


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    result, checks = _run(cell)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct(cell):
    result, checks = _run(cell, control=True)
    assert not result["correct"], checks


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_is_not_correct(cell, fault):
    driver = spec.traffic(spec.workload(cell)["traffic"])["driver"]
    undo = plant(driver, fault)
    try:
        result, checks = _run(cell)
    finally:
        undo()
    assert not result["correct"], checks
