"""Experiment-dataset loading (a copy of ``poccala_tpu/io/dataset.py``).

Replaces ``StatisticalModel/DataInitialization.py:19-120`` — the base
class holding ``data``/``datasize`` with a CSV loader used "for
experiments" (``init_data``, ``DataInitialization.py:32-90``) on fixtures
like ``HiddenMarkovModelDataSet.csv`` (header: count/dim/classes, then
comma-separated observation rows).  Arrays replace the container class;
only the loader survives as a function.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ExperimentDataset:
    data: list          # list of observation sequences (str or float rows)
    count: int
    dim: int
    classes: int
    vocabulary: list    # distinct symbols (discrete datasets)

    def encoded(self) -> np.ndarray:
        """Symbol sequences as int ids ``[count, dim]`` (discrete case)."""
        id_of = {s: i for i, s in enumerate(self.vocabulary)}
        return np.asarray([[id_of[s] for s in row] for row in self.data])


def load_experiment_csv(path: str) -> ExperimentDataset:
    """Parse the toy-fixture format (``HiddenMarkovModelDataSet.csv:1-2``):
    a title line, a header ``count dim classes …``, then one
    comma-separated observation sequence per line."""
    with open(path, encoding="utf-8") as f:
        lines = [l.strip("\n") for l in f if l.strip()]
    header = lines[1].split()
    count, dim, classes = int(header[0]), int(header[1]), int(header[2])
    rows = [line.split(",") for line in lines[2: 2 + count]]
    try:
        rows = [[float(v) for v in row] for row in rows]
        vocab: list = []
    except ValueError:
        vocab = sorted({s for row in rows for s in row})
    return ExperimentDataset(
        data=rows, count=count, dim=dim, classes=classes, vocabulary=vocab
    )
