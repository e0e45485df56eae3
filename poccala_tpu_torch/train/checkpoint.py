"""Checkpoints (port of ``poccala_tpu/train/checkpoint.py``, the
single-process format).

A checkpoint is a directory holding ``bank.npz`` (the bank fields) and
``manifest.json`` (training phase, units, shapes, ``"format": "npz"``),
exactly as the JAX package writes it for a single-device bank
(``checkpoint.py:114-125``), so each package reads the other's files.
The orbax sharded layout (``bank_orbax/``) needs orbax and jax: saving
it and reading it raise here.

:func:`export_reference_layout` / :func:`import_reference_layout` read
and write the reference's per-unit directory format (host code copied
from the JAX module), so parameters move between the systems.
"""

from __future__ import annotations

import configparser
import json
import os

import numpy as np
import torch

from poccala_tpu_torch.models.senone_bank import (
    FIELDS, SenoneBank, bank_from_numpy, bank_to_numpy, identity_senone_map)
from poccala_tpu_torch.utils.device import resolve
from poccala_tpu_torch.utils.errors import ParameterFileError
from poccala_tpu_torch.utils.logmath import masked_log


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
    """Load a checkpoint directory -> (bank on ``device``, manifest);
    ``device`` None means the card (``utils/device.py``)."""
    device = resolve(device)
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


# ----------------------------------------------------------------------
# Reference-layout interop (host NumPy + configparser, copied)
# ----------------------------------------------------------------------

def export_reference_layout(root: str, bank: SenoneBank, inventory,
                            unit_type: str = "XIF_tone",
                            fix_code: int = 0) -> None:
    """Write the reference's per-unit parameter directories
    (``PARAMETERS_FILE_PATH/<unit_type>/<unit>/...``,
    ``LHMM.save_parameter`` ``LHMM.py:192-209``, ``GMM.save_parameter``
    ``Clustering.py:234-255``)."""
    base = os.path.join(root, unit_type)
    os.makedirs(base, exist_ok=True)
    emit = bank.emit_states
    arrays = bank_to_numpy(bank)
    means = arrays["means"]
    var = np.exp(arrays["log_var"])
    w = np.exp(arrays["log_w"])
    log_a = arrays["log_A"]
    pi = np.exp(arrays["log_pi"])
    mix_counts = arrays["mix_counts"]
    senone_map = arrays["senone_map"]

    for u, unit in enumerate(inventory.units):
        unit_dir = os.path.join(base, unit)
        hmm_dir = os.path.join(unit_dir, "HMM")
        os.makedirs(hmm_dir, exist_ok=True)
        np.save(os.path.join(hmm_dir, "transmat.npy"), np.exp(log_a[u]))
        np.save(os.path.join(hmm_dir, "pi.npy"), pi[u])
        cp = configparser.ConfigParser()
        cp.add_section("Configuration")
        cp.set("Configuration", "FIX_CODE", str(fix_code))
        with open(os.path.join(hmm_dir, "HMM_config.ini"), "w") as f:
            cp.write(f)
        for e in range(emit):
            s = int(senone_map[u, e])  # tied states export shared params
            m_act = int(mix_counts[s])
            gmm_dir = os.path.join(unit_dir, f"GMM_{e}")
            os.makedirs(gmm_dir, exist_ok=True)
            np.save(os.path.join(gmm_dir, "GMM_means.npy"), means[s, :m_act])
            cov = np.stack([np.diag(var[s, mi]) for mi in range(m_act)])
            np.save(os.path.join(gmm_dir, "GMM_covariance.npy"), cov)
            np.save(os.path.join(gmm_dir, "GMM_weight.npy"), w[s, :m_act])
            cp = configparser.ConfigParser()
            cp.add_section("Configuration")
            cp.set("Configuration", "MIXTURE", str(m_act))
            cp.set("Configuration", "DIMENSION", str(bank.dim))
            cp.set("Configuration", "BIAS", "100.0")
            with open(os.path.join(gmm_dir, "GMM_config.ini"), "w") as f:
                cp.write(f)


def import_reference_layout(root: str, inventory, unit_type: str,
                            state_num: int, max_mix: int,
                            device=None) -> SenoneBank:
    """Load a reference-format parameter store into a bank on ``device``
    (``AcousticModel.init_parameter``, ``AcousticModel.py:228-240``);
    ``device`` None means the card (``utils/device.py``)."""
    device = resolve(device)
    base = os.path.join(root, unit_type)
    emit = state_num - 2
    u_total = len(inventory)
    first = None
    banks = {}
    for u, unit in enumerate(inventory.units):
        unit_dir = os.path.join(base, unit)
        if not os.path.isdir(unit_dir):
            raise ParameterFileError(f"missing unit directory: {unit_dir}")
        transmat = np.load(os.path.join(unit_dir, "HMM", "transmat.npy"))
        pi = np.load(os.path.join(unit_dir, "HMM", "pi.npy"))
        gmms = []
        for e in range(emit):
            gmm_dir = os.path.join(unit_dir, f"GMM_{e}")
            mu = np.load(os.path.join(gmm_dir, "GMM_means.npy"))
            cov = np.load(os.path.join(gmm_dir, "GMM_covariance.npy"))
            wt = np.load(os.path.join(gmm_dir, "GMM_weight.npy"))
            cov = np.squeeze(cov)
            if cov.ndim == 2:  # single mixture [D, D]
                cov = cov[None]
            var = np.stack([np.diag(c) for c in cov])
            gmms.append((mu, var, wt))
            if first is None:
                first = mu.shape[-1]
        banks[u] = (transmat, pi, gmms)

    d = first
    s_total = u_total * emit
    means = np.zeros((s_total, max_mix, d), np.float32)
    var = np.ones((s_total, max_mix, d), np.float32)
    w = np.zeros((s_total, max_mix), np.float32)
    mix_counts = np.zeros((s_total,), np.int32)
    log_a = np.zeros((u_total, state_num, state_num), np.float32)
    pi_all = np.zeros((u_total, state_num), np.float32)
    for u in range(u_total):
        transmat, pi, gmms = banks[u]
        with np.errstate(divide="ignore"):
            log_a[u] = np.where(transmat > 0, np.log(np.maximum(transmat, 1e-300)), -1e30)
        pi_all[u] = pi
        for e, (mu, v, wt) in enumerate(gmms):
            s = u * emit + e
            m_act = len(wt)
            means[s, :m_act] = mu
            var[s, :m_act] = np.maximum(v, 1e-10)
            w[s, :m_act] = wt
            mix_counts[s] = m_act

    return bank_from_numpy({
        "means": means,
        "log_var": np.log(var),
        "log_w": masked_log(torch.as_tensor(w)).numpy(),
        "log_A": log_a,
        "log_pi": masked_log(torch.as_tensor(np.maximum(pi_all, 0.0))).numpy(),
        "mix_counts": mix_counts,
        "senone_map": identity_senone_map(u_total, emit).numpy(),
    }, device=device)
