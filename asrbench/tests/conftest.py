"""Shared pieces of the benchmark's own tests: small sizes for the CPU
(the cells' configurations and mixes cut down, everything else as the
cell has it) and the check for a card."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

torch.set_num_threads(1)

SMALL = {
    "fullvocab_exact_offline": {
        "config": {"lexicon": {"syllables": 8, "min_nodes": 120},
                   "mixtures": 4},
        "traffic": {"batch": 6, "batches": 2,
                    "seconds": {"median": 1.0, "lo": 0.5, "hi": 2.0}}},
    "cd2k_decode_offline": {
        "config": {"lexicon": {"syllables": 10, "words": 30},
                   "mixtures": 4, "senones": 120},
        "traffic": {"batch": 6, "batches": 2,
                    "seconds": {"median": 1.0, "lo": 0.5, "hi": 2.0}}},
    "cd2k_train_long_sentences": {
        "config": {"lexicon": {"syllables": 10, "words": 30},
                   "mixtures": 2, "senones": 120,
                   "train": {"max_label_len": 16}},
        "traffic": {"batch": 8, "batches": 2,
                    "seconds": {"lo": 1.0, "hi": 1.6}}},
}


@pytest.fixture
def card():
    """Skips a test that needs a CUDA device where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
