"""Checkpoints (port of ``poccala_tpu/train/checkpoint.py``, the
single-process format).

A checkpoint is a directory holding ``bank.npz`` (the bank fields) and
``manifest.json`` (training phase, units, shapes, ``"format": "npz"``),
exactly as the JAX package writes it for a single-device bank
(``checkpoint.py:114-125``), so each package reads the other's files.
The orbax sharded layout (``bank_orbax/``) needs orbax and jax: saving
it and reading it raise here.  Reference-layout interop is not ported.
"""

from __future__ import annotations

import json
import os

import numpy as np

from poccala_tpu_torch.models.senone_bank import (
    FIELDS, SenoneBank, bank_from_numpy, bank_to_numpy)
from poccala_tpu_torch.utils.errors import ParameterFileError


def save_checkpoint(path: str, bank: SenoneBank, manifest: dict | None = None,
                    units: list[str] | None = None,
                    sharded: bool | None = None) -> None:
    """Write ``bank.npz`` + ``manifest.json`` under ``path``.  The bank is
    copied to the host; ``sharded=True`` (orbax) raises."""
    if sharded:
        raise NotImplementedError(
            "the orbax sharded checkpoint format needs jax; the PyTorch "
            "port writes the single-process bank.npz format")
    os.makedirs(path, exist_ok=True)
    arrays = bank_to_numpy(bank)
    np.savez(os.path.join(path, "bank.npz"), **arrays)
    man = dict(manifest or {})
    if units is not None:
        man["units"] = units
    man["shapes"] = {f: list(arrays[f].shape) for f in FIELDS}
    man["format"] = "npz"
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(man, f, indent=2)


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
