"""The senone bank: all units' HMM+GMM parameters as one module of buffers.

Port of ``poccala_tpu/models/senone_bank.py``.  The JAX package keeps the
bank as a registered-dataclass pytree; here it is an ``nn.Module`` whose
fields are buffers, so ``bank.to(device)`` moves it whole:

* ``means[S, M, D]``, ``log_var[S, M, D]``, ``log_w[S, M]`` — the GMMs of
  all emitting states (``log_w`` is NEG_INF on padded mixture slots);
* ``log_A[U, N, N]``, ``log_pi[U, N]`` — per-unit transition matrices and
  initial distributions (rows 0 and N-1 are the virtual entry/exit
  states, ``AcousticModel.py:174-181``);
* ``mix_counts[S]`` and ``senone_map[U, N-2]`` (int32).

:func:`bank_from_numpy` / :func:`bank_to_numpy` convert to and from the
``{field: ndarray}`` form keyed like the checkpoint's ``bank.npz``
(``train/checkpoint.py:42-44``) — the weight converter between the two
packages.  Banks are not modified in place: :func:`replace` builds a new
one, as ``dataclasses.replace`` does for the JAX bank.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from poccala_tpu_torch.config import ModelConfig
from poccala_tpu_torch.utils.device import resolve
from poccala_tpu_torch.utils.logmath import masked_log

FIELDS = ("means", "log_var", "log_w", "log_A", "log_pi", "mix_counts",
          "senone_map")
_INT_FIELDS = ("mix_counts", "senone_map")


class SenoneBank(nn.Module):
    def __init__(self, means, log_var, log_w, log_A, log_pi, mix_counts,
                 senone_map):
        super().__init__()
        for name, value in zip(FIELDS, (means, log_var, log_w, log_A, log_pi,
                                        mix_counts, senone_map)):
            dtype = torch.int32 if name in _INT_FIELDS else torch.float32
            self.register_buffer(name, torch.as_tensor(value).to(dtype))

    @property
    def num_states(self) -> int:
        return self.means.shape[0]

    @property
    def max_mix(self) -> int:
        return self.means.shape[1]

    @property
    def dim(self) -> int:
        return self.means.shape[2]

    @property
    def num_units(self) -> int:
        return self.log_A.shape[0]

    @property
    def state_num(self) -> int:
        return self.log_A.shape[1]

    @property
    def emit_states(self) -> int:
        return self.state_num - 2

    def senone_id(self, unit: int, emit: int) -> int:
        return int(self.senone_map[unit, emit])


def bank_from_numpy(arrays: dict, device=None) -> SenoneBank:
    """``{field: ndarray}`` (e.g. a loaded ``bank.npz``, or a JAX bank's
    fields through ``np.asarray``) -> :class:`SenoneBank` on ``device``
    (None = the card; ``utils/device.py``)."""
    bank = SenoneBank(**{f: torch.from_numpy(np.array(arrays[f]))
                         for f in FIELDS})
    return bank.to(resolve(device))


def bank_to_numpy(bank: SenoneBank) -> dict:
    """:class:`SenoneBank` -> ``{field: ndarray}`` (host copies)."""
    return {f: getattr(bank, f).detach().cpu().numpy() for f in FIELDS}


def replace(bank: SenoneBank, **changes) -> SenoneBank:
    """A new bank with the given fields replaced (``dataclasses.replace``
    on the JAX package's bank)."""
    return SenoneBank(**{f: changes.get(f, getattr(bank, f)) for f in FIELDS})


def identity_senone_map(num_units: int, emit: int,
                        device=None) -> torch.Tensor:
    """The untied layout: senone(u, e) = u * emit + e."""
    u = torch.arange(num_units, device=device)[:, None]
    e = torch.arange(emit, device=device)[None, :]
    return (u * emit + e).to(torch.int32)


def unit_transmat(state_num: int) -> np.ndarray:
    """Left-to-right unit topology (``AcousticModel.py:176-181``):
    virtual entry 0 -> 1 with prob 1; emitting states 0.5 self / 0.5
    next; virtual exit absorbing."""
    a = np.zeros((state_num, state_num))
    a[0, 1] = 1.0
    for j in range(1, state_num - 1):
        a[j, j] = 0.5
        a[j, j + 1] = 0.5
    return a


def create_bank(
    num_units: int,
    cfg: ModelConfig,
    dim: int,
    generator: torch.Generator | None = None,
    mix_level: int | None = None,
    differentiation: bool = True,
    device=None,
) -> SenoneBank:
    """Fresh bank with the reference's initial values
    (``AcousticModel.init_unit`` -> ``Clustering.GMM.__init__``,
    ``Clustering.py:66-90``): random means in [0,1) when
    ``differentiation`` else zeros; unit diagonal covariance; uniform
    mixture weights; the standard unit transmat; uniform pi.

    The means are drawn on the CPU from ``generator`` (seeded
    ``torch.Generator``; a fixed seed of 0 when None), so one seed gives
    one bank on every device.  The draws differ from ``jax.random``'s:
    parity tests convert one bank with :func:`bank_from_numpy` instead.
    ``device`` None means the card (``utils/device.py``)."""
    dev = resolve(device)
    n = cfg.state_num
    emit = n - 2
    s = num_units * emit
    m = cfg.max_mix_level
    active = mix_level if mix_level is not None else cfg.mix_level

    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if differentiation:
        means = torch.rand((s, m, dim), generator=generator,
                           dtype=torch.float32)
    else:
        means = torch.zeros((s, m, dim), dtype=torch.float32)
    log_var = torch.zeros((s, m, dim), dtype=torch.float32)
    mix_counts = torch.full((s,), active, dtype=torch.int32)
    w = torch.where(torch.arange(m)[None, :] < active, 1.0 / active,
                    0.0).to(torch.float32).expand(s, m)
    log_w = masked_log(w)
    log_a = masked_log(torch.as_tensor(unit_transmat(n), dtype=torch.float32))
    log_a = log_a[None].repeat(num_units, 1, 1)
    log_pi = torch.full((num_units, n), -float(np.log(float(n))),
                        dtype=torch.float32)
    bank = SenoneBank(means, log_var, log_w, log_a, log_pi, mix_counts,
                      identity_senone_map(num_units, emit))
    return bank.to(dev)


def flat_start(
    bank: SenoneBank,
    global_mean: torch.Tensor,
    global_var: torch.Tensor,
    generator: torch.Generator,
    coefficient: float = 1.0,
    differentiation: bool = True,
) -> SenoneBank:
    """Flat start (``AcousticModel.__flat_start``,
    ``AcousticModel.py:479-517``): every senone's GMM gets the global
    mean/covariance; mixture means are differentiated by a random
    per-mixture offset ``diff * diag(cov)`` drawn once and shared by all
    senones (``AcousticModel.py:504-509``).  ``diff`` is drawn on the CPU
    from ``generator`` (its draws differ from ``jax.random``'s)."""
    s, m, d = bank.means.shape
    dev = bank.means.device
    global_mean = torch.as_tensor(global_mean, dtype=torch.float32,
                                  device=dev)
    global_var = torch.as_tensor(global_var, dtype=torch.float32, device=dev)
    if differentiation:
        u1 = torch.rand((m, 1), generator=generator)
        u2 = torch.rand((m, 1), generator=generator)
        diff = ((u1 - u2) * coefficient).to(dev)  # [M, 1], in (-c, c)
    else:
        diff = torch.zeros((m, 1), device=dev)
    # mean_m[j] = global_mean + diff_j * diag(global_cov) (AcousticModel.py:514)
    mean_m = global_mean[None, :] + diff * global_var[None, :]
    means = mean_m[None].expand(s, m, d).contiguous()
    log_var = torch.log(torch.clamp(global_var, min=1e-10))[None, None] \
        .expand(s, m, d).contiguous()
    return replace(bank, means=means, log_var=log_var)


# ----------------------------------------------------------------------
# Mixture growth (Controller.add_mix_level, Controller.py:153-159)
# ----------------------------------------------------------------------

def grow_mixtures(bank: SenoneBank, new_counts) -> SenoneBank:
    """Record new per-senone mixture targets, capped at ``max_mix``.  The
    re-clustering itself happens at the next k-means init
    (``AcousticModel.__cal_gmm`` re-clusters when ``gmm.mixture !=
    mix_level``, ``AcousticModel.py:552-558``)."""
    new_counts = torch.as_tensor(new_counts, device=bank.mix_counts.device)
    return replace(bank, mix_counts=torch.clamp(new_counts, max=bank.max_mix)
                   .to(torch.int32))
