"""Checkpoint loading (port of ``poccala_tpu/train/checkpoint.py``, load
side only).

Reads the single-process format the JAX package writes: ``bank.npz``
holding the bank fields plus ``manifest.json``
(``checkpoint.py:114-125, 186-191, 215-217``).  The orbax sharded layout
(``bank_orbax/``) needs orbax and jax, so it raises here; saving and the
reference-layout interop wait for the training port.
"""

from __future__ import annotations

import json
import os

import numpy as np

from poccala_tpu_torch.models.senone_bank import SenoneBank, bank_from_numpy
from poccala_tpu_torch.utils.errors import ParameterFileError


def load_checkpoint(path: str, device=None) -> tuple[SenoneBank, dict]:
    """Load a checkpoint directory -> (bank on ``device``, manifest)."""
    manifest = {}
    man_path = os.path.join(path, "manifest.json")
    if os.path.exists(man_path):
        with open(man_path) as f:
            manifest = json.load(f)

    if os.path.isdir(os.path.join(path, "bank_orbax")):
        raise ParameterFileError(
            f"{path} holds the orbax sharded layout, which the PyTorch port "
            "cannot read; save it single-device (bank.npz) instead")
    npz_path = os.path.join(path, "bank.npz")
    if not os.path.exists(npz_path):
        raise ParameterFileError(f"no checkpoint at {path}")
    with np.load(npz_path) as data:
        bank = bank_from_numpy(data, device=device)
    return bank, manifest
