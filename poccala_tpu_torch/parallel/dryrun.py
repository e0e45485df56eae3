"""The multi-rank dry run: the port's counterpart of
``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:71-170``).

Every rank of an initialised world of ``n_ranks`` processes calls
:func:`dryrun_multichip`.  It builds a ``(data, state)`` mesh over them,
runs the state-sharded train step on a toy bank, then at BASELINE config-3
scale (683 units = 2,049 senones, 16 mixtures, 39 dims) with per-shard
shape checks and a watch over every tensor the step produces, then the
data-parallel sharded decode.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from poccala_tpu_torch.config import ModelConfig
from poccala_tpu_torch.models import senone_bank as sb
from poccala_tpu_torch.parallel import decode as pdecode
from poccala_tpu_torch.parallel import mesh as pmesh


def _make_model(num_units=8, dim=13, mix=2, max_mix=2, state_num=5, seed=0):
    """A seeded bank on the host (each rank moves only its shard)."""
    cfg = ModelConfig(state_num=state_num, mix_level=mix,
                      max_mix_level=max_mix)
    bank = sb.create_bank(num_units, cfg, dim,
                          generator=torch.Generator().manual_seed(seed),
                          device="cpu")
    return cfg, bank


def _example_batch(num_units, dim, b=4, t=32, max_l=4, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_units, size=(b, max_l)).astype(np.int32)
    lens = rng.integers(1, max_l + 1, size=(b,)).astype(np.int32)
    xs = rng.normal(size=(b, t, dim)).astype(np.float32)
    masks = np.ones((b, t), bool)
    return labels, lens, xs, masks


class GmmRowWatch(TorchDispatchMode):
    """The largest senone-row count of any ``[S, M, D]`` or ``[S, M]``
    tensor an op produces while the mode is on: what a rank allocated of
    the GMM tensors."""

    def __init__(self, m: int, d: int):
        super().__init__()
        self.tails = {(m, d), (m,)}
        self.max_rows = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and tuple(t.shape[1:]) in self.tails:
                self.max_rows = max(self.max_rows, t.shape[0])
        return out


def _say(msg: str) -> None:
    if dist.get_rank() == 0:
        print(msg, flush=True)


def dryrun_multichip(n_ranks: int, device=None) -> dict:
    """Run the full distributed train step over an ``n_ranks`` mesh (data
    × state, the GMM tensors sharded over ``state`` so each rank holds
    S/state_axis rows) on tiny shapes, at config-3 scale, then a
    data-parallel sharded decode.  ``device`` is where this rank computes
    (None = the card).  Rank 0 prints one line per part; every rank
    returns the same summary, but for its own ``shard_bytes``."""
    state_axis = 2 if n_ranks % 2 == 0 and n_ranks >= 4 else 1
    mesh = pmesh.make_mesh(data_axis=n_ranks // state_axis,
                           state_axis=state_axis, device=device)
    n_data = pmesh.mesh_shape(mesh)["data"]

    cfg, bank = _make_model()
    bank, s_orig = pmesh.pad_bank_states(bank, state_axis)
    bank = pmesh.shard_bank_states(bank, mesh)
    batch = _example_batch(bank.num_units, bank.dim, b=n_data * 2)
    step = pmesh.make_state_sharded_train_step(mesh, cfg.state_num, 4)
    new_bank, loglik = step(bank, *batch)
    ll = float(loglik)
    assert np.isfinite(ll), f"non-finite loglik from distributed step: {ll}"
    shard_s = new_bank.num_states
    assert shard_s * state_axis >= s_orig, (shard_s, state_axis, s_orig)
    _say(f"dryrun_multichip({n_ranks}): mesh={pmesh.mesh_shape(mesh)} "
         f"train loglik={ll:.3f} bank shard S={shard_s}/{s_orig} ok")

    out = dict(mesh=pmesh.mesh_shape(mesh), toy_loglik=ll)
    out.update(_dryrun_config3_scale(mesh, state_axis))
    out.update(_dryrun_decode(mesh, n_ranks))
    return out


def _dryrun_config3_scale(mesh, state_axis: int) -> dict:
    """The same sharded train step at BASELINE config-3 scale (~2k
    senones, 16 mixtures, 39 dims): every GMM tensor of the new bank is
    ``S_padded / state_axis`` rows on each rank, and no tensor the step
    produced had more rows than that and the scatter's spare bucket."""
    cfg, bank = _make_model(num_units=683, dim=39, mix=16, max_mix=16,
                            seed=3)
    s_true = bank.num_states
    bank, _ = pmesh.pad_bank_states(bank, state_axis)
    s_padded = bank.num_states
    bank = pmesh.shard_bank_states(bank, mesh)
    batch = _example_batch(bank.num_units, bank.dim,
                           b=pmesh.mesh_shape(mesh)["data"] * 2, t=48,
                           max_l=8, seed=3)
    step = pmesh.make_state_sharded_train_step(mesh, cfg.state_num, 8)
    watch = GmmRowWatch(bank.max_mix, bank.dim)
    with watch:
        new_bank, loglik = step(bank, *batch)
        ll = float(loglik)
    assert np.isfinite(ll), f"non-finite loglik at config-3 scale: {ll}"
    # the step's time, unwatched: the watch runs Python at every op
    t0 = time.perf_counter()
    float(step(bank, *batch)[1])
    step_ms = (time.perf_counter() - t0) * 1e3

    want_local = s_padded // state_axis
    shard_bytes = 0
    for name in ("means", "log_var", "log_w", "mix_counts"):
        t = getattr(new_bank, name)
        assert t.shape[0] == want_local, (name, tuple(t.shape), want_local)
        shard_bytes += t.numel() * t.element_size()
    # the statistics' scatter adds one spare row for foreign senones
    assert watch.max_rows <= want_local + 1, (watch.max_rows, want_local)
    full = shard_bytes * state_axis
    _say(f"dryrun_multichip config-3 scale: {s_true} senones x 16 mix "
         f"x 39 dim, shard S={want_local}/{s_padded}, "
         f"{shard_bytes / 1e6:.2f} MB/rank GMM tensors "
         f"(full {full / 1e6:.2f} MB, x1/{state_axis}), largest GMM "
         f"tensor of the step {watch.max_rows} rows, loglik={ll:.3f} ok")
    return dict(c3_senones=s_true, c3_padded=s_padded, c3_local=want_local,
                c3_loglik=ll, shard_bytes=shard_bytes,
                step_max_gmm_rows=watch.max_rows, c3_step_ms=step_ms)


def _dryrun_decode(mesh, n_ranks: int) -> dict:
    """Data-parallel distributed beam decode over the mesh (BASELINE
    config 5: utterance batches sharded over ``data``, lexicon and bank
    whole on every rank)."""
    words, scores = pdecode.dryrun(mesh)
    assert np.isfinite(scores).all(), scores
    _say(f"dryrun_multichip({n_ranks}): sharded decode "
         f"words={words.tolist()} ok")
    return dict(decode_words=words.tolist(), decode_scores=scores.tolist())
