"""Scheme-1 training end to end, PyTorch port vs JAX package, plus state
tying and the reference parameter layout.

Deterministic parity: JAX's ``Trainer`` flat-starts, its bank is carried
across, and both trainers run ``scheme1_round(init=True, smem=False,
reinit=False)`` then ``scheme1_round(init=False, ...)`` (the ``cd-expand``
retrain call: uniform segmentation, then Viterbi realignment; EM from
the carried GMMs; the transmat epoch).  Round logliks agree at rtol 1e-5
and banks at rtol 1e-3 / atol 2e-3 — the bars of
``tests/test_torch_trainer.py``.  The two packages shuffle each senone's
frame bucket with their own random streams, so buckets are compared as
sorted sets of rows; ``fit_gmms`` alone on identical buckets agrees at
rtol 1e-4 / atol 1e-4 (``tests/test_torch_kmeans_em.py``'s EM bar).

The k-means seeding streams differ, so rounds that re-seed (the default
``auto(mode=1)``) are held to JAX's scheme-1 behaviours
(``tests/test_training_e2e.py:108-131``) instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poccala_tpu.config import Config
from poccala_tpu.io import corpus as jcorpus
from poccala_tpu.models import questions as jquestions
from poccala_tpu.models import tying as jtying
from poccala_tpu.train import checkpoint as jckpt
from poccala_tpu.train.trainer import Trainer as JaxTrainer
from poccala_tpu_torch.io import corpus as tcorpus
from poccala_tpu_torch.models import senone_bank as tsb
from poccala_tpu_torch.models import tying as ttying
from poccala_tpu_torch.train import checkpoint as tckpt
from poccala_tpu_torch.train.trainer import Trainer

from .test_senone_topology import make_bank

torch.set_num_threads(1)

LL_RTOL = 1e-5
BANK_TOL = dict(rtol=1e-3, atol=2e-3)
FIT_TOL = dict(rtol=1e-4, atol=1e-4)


def carry(jbank):
    return tsb.bank_from_numpy({f: np.asarray(getattr(jbank, f))
                                for f in tsb.FIELDS}, device="cpu")


def assert_banks_close(bank, jbank, **tol):
    for f in tsb.FIELDS:
        np.testing.assert_allclose(getattr(bank, f).numpy(),
                                   np.asarray(getattr(jbank, f)),
                                   err_msg=f, **tol)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """XIF inventory, 6 spoken units, CMVN features (see
    tests/test_torch_trainer.py for why parity needs both)."""
    root = str(tmp_path_factory.mktemp("scheme1_corpus"))
    inv = jcorpus.UnitInventory.standard("XIF")
    audio, label = jcorpus.generate_synthetic_corpus(
        root, jcorpus.UnitInventory(inv.units[20:26]), num_utts=20,
        units_per_utt=(2, 4), unit_seconds=0.2, seed=5)
    cfg = Config()
    cfg.paths.audio_file_path = audio
    cfg.paths.label_file_path = label
    cfg.frontend.vad = False
    cfg.frontend.cmvn = cfg.frontend.cmvn_var = True
    cfg.model.state_num = 5
    cfg.model.mix_level = 2
    cfg.model.max_mix_level = 3
    cfg.train.batch_size = 8
    cfg.train.max_frames = 96
    cfg.train.max_label_len = 4
    cfg.train.step = 2
    cfg.train.proportion = 1.0
    cfg.train.max_em_iters = 8
    jb = list(jcorpus.Corpus(cfg, inv).batches(use_native=False))
    tinv = tcorpus.UnitInventory.standard("XIF")
    return cfg, inv, tinv, jb


def flat_started(cfg, inv, tinv, batches):
    jtr = JaxTrainer(cfg, inv, key=jax.random.PRNGKey(0))
    jtr.flat_start(batches)
    tr = Trainer(cfg, tinv, device="cpu")
    tr.bank = carry(jtr.bank)
    return jtr, tr


def sorted_rows(frames, mask, s):
    rows = frames[s][mask[s]]
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("init", [True, False])
def test_collect_frames_match_jax_as_sets(corpus, init):
    cfg, inv, tinv, batches = corpus
    jtr, tr = flat_started(cfg, inv, tinv, batches)
    wf, wm = jtr._collect_frames(batches, init=init)
    gf, gm = tr._collect_frames(batches, init=init)
    assert gf.shape == wf.shape and gf.dtype == np.float32
    assert np.array_equal(gm.sum(1), wm.sum(1))
    assert tr.round_info["dropped"] == 0 and tr.round_info["cap"] == 256
    for s in np.nonzero(wm.any(1))[0]:
        assert np.array_equal(sorted_rows(gf, gm, s), sorted_rows(wf, wm, s))
    # padding stays zero
    assert not gf[~gm].any()


def test_fit_gmms_matches_jax_on_identical_buckets(corpus):
    cfg, inv, tinv, batches = corpus
    jtr, tr = flat_started(cfg, inv, tinv, batches)
    frames, mask = jtr._collect_frames(batches, init=True)
    jtr.fit_gmms(frames, mask, reinit=False)
    tr.fit_gmms(frames, mask, reinit=False)
    assert_banks_close(tr.bank, jtr.bank, **FIT_TOL)
    assert 1 <= tr.round_info["em_iters"] <= cfg.train.max_em_iters


@pytest.mark.parametrize("var_floor_scale", [0.0, 0.3])
def test_scheme1_rounds_match_jax(corpus, var_floor_scale):
    """With ``var_floor_scale`` the EM floor is the per-dim relative
    floor (a ``[D]`` vector) computed from the corpus."""
    cfg, inv, tinv, batches = corpus
    cfg.model.var_floor_scale = var_floor_scale
    try:
        jtr, tr = flat_started(cfg, inv, tinv, batches)
        want, got = [], []
        for init in (True, False):
            want.append(jtr.scheme1_round(batches, init=init, smem=False,
                                          reinit=False))
            got.append(tr.scheme1_round(batches, init=init, smem=False,
                                        reinit=False))
    finally:
        cfg.model.var_floor_scale = 0.0
    np.testing.assert_allclose(got, want, rtol=LL_RTOL)
    assert_banks_close(tr.bank, jtr.bank, **BANK_TOL)
    if var_floor_scale:
        np.testing.assert_allclose(tr.var_floor, jtr.var_floor, rtol=1e-6)
        # the relative floor binds somewhere
        assert np.any(np.isclose(np.exp(tr.bank.log_var.numpy()),
                                 tr.var_floor, rtol=1e-5))


def test_auto_realigns_and_grows_mixtures(corpus):
    """JAX's scheme-1 behaviours (tests/test_training_e2e.py:108-131) on
    the port: the realignment round raises the loglik, emitting rows of A
    stay stochastic, SMEM runs on the init round, and the next mixture
    level re-clusters where the data suffice."""
    cfg, inv, tinv, batches = corpus
    tr = Trainer(cfg, tinv, generator=torch.Generator().manual_seed(1),
                 device="cpu")
    tr.flat_start(batches)
    lls = tr.auto(batches, t=2, mode=1, init=True)
    assert np.isfinite(lls).all() and lls[1] > lls[0]
    a = torch.exp(tr.bank.log_A).numpy()
    assert np.allclose(a[:, 1:-1, :].sum(-1), 1.0, atol=1e-3)
    assert [h["round"] for h in tr.history] == [0, 1]
    assert "smem_accepted" in tr.history[0] and \
        "smem_accepted" not in tr.history[1]
    assert int(tr.bank.mix_counts.max()) == 2

    tr.add_mix_level()
    tr.auto(batches, t=1, mode=1, init=False)
    counts = tr.bank.mix_counts.numpy()
    assert counts.max() == 3
    grown = counts == 3
    assert np.all(np.exp(tr.bank.log_w.numpy()[grown, 2]) > 0)
    tr.add_mix_level()              # max_mix_level caps the growth
    assert tr.mix_level == 3
    # one seed, one model
    again = Trainer(cfg, tinv, generator=torch.Generator().manual_seed(1),
                    device="cpu")
    again.flat_start(batches)
    assert again.auto(batches, t=2, mode=1, init=True) == lls


def test_grow_mixtures_caps_at_max_mix(corpus):
    cfg, inv, tinv, batches = corpus
    bank = Trainer(cfg, tinv, device="cpu").bank
    grown = tsb.grow_mixtures(bank, bank.mix_counts + 5)
    assert grown.mix_counts.dtype == torch.int32
    assert torch.all(grown.mix_counts == bank.max_mix)
    assert torch.equal(grown.means, bank.means)


def test_tied_bank_trains_through_scheme1(corpus):
    cfg, inv, tinv, batches = corpus
    tr = Trainer(cfg, tinv, device="cpu")
    tr.flat_start(batches)
    tr.scheme1_round(batches, init=True, smem=False)
    s_old = tr.bank.num_states
    tr.bank = ttying.tie_by_kmeans(tr.bank, target_senones=90,
                                   generator=torch.Generator().manual_seed(0))
    sm = tr.bank.senone_map.numpy()
    assert tr.bank.num_states <= 90 < s_old
    assert sm.max() < tr.bank.num_states
    blocks = [set(sm[:, e].tolist()) for e in range(3)]
    assert blocks[0].isdisjoint(blocks[1]) and blocks[1].isdisjoint(blocks[2])
    lls = [tr.scheme1_round(batches, init=False, smem=False)
           for _ in range(2)]
    assert np.isfinite(lls).all() and lls[1] >= lls[0] - 1e-2
    assert tr.bank.num_states <= 90


def test_merge_and_tree_tying_match_jax():
    rng = np.random.default_rng(4)
    units = jcorpus.standard_inventory("IF")[:12]
    _, jbank = make_bank(rng, num_units=12, state_num=5, mix=2, max_mix=2,
                         dim=5)
    bank = carry(jbank)
    np.testing.assert_allclose(ttying.senone_embedding(bank),
                               jtying.senone_embedding(jbank), rtol=1e-6)
    # identical assignments merge identically
    assign = rng.integers(0, 7, size=bank.num_states)
    occ = rng.uniform(0.5, 3, size=bank.num_states)
    assert_banks_close(ttying._merge_assignments(bank, assign, 7, occ),
                       jtying._merge_assignments(jbank, assign, 7, occ),
                       rtol=1e-6, atol=1e-6)
    # tree tying is deterministic: the same questions give the same tree
    qs = jquestions.default_questions(units)
    got, gtrees = ttying.tie_by_tree(bank, units, 18, occupancy=occ,
                                     questions=qs, return_trees=True)
    want, wtrees = jtying.tie_by_tree(jbank, units, 18, occupancy=occ,
                                      questions=qs, return_trees=True)
    assert np.array_equal(got.senone_map.numpy(),
                          np.asarray(want.senone_map))
    assert [[s.question for s in v] for v in gtrees.values()] == \
        [[s.question for s in v] for v in wtrees.values()]
    assert_banks_close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        ttying.tie_by_tree(bank, units, 18)


def test_reference_layout_roundtrips_with_jax(corpus, tmp_path):
    cfg, inv, tinv, batches = corpus
    _, jbank = make_bank(np.random.default_rng(6), num_units=len(tinv),
                         state_num=5, mix=2, max_mix=3, dim=5)
    # one senone with a single mixture exercises the squeezed [D, D] file
    counts = np.array(jbank.mix_counts)
    counts[4] = 1
    w = np.exp(np.array(jbank.log_w))
    w[4] = [1.0, 0.0, 0.0]
    jbank = dataclasses.replace(jbank, mix_counts=jnp.asarray(counts),
                                log_w=jnp.asarray(np.log(np.maximum(
                                    w, 1e-30)).astype(np.float32)))
    bank = carry(jbank)
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    tckpt.export_reference_layout(tdir, bank, tinv, unit_type="XIF",
                                  fix_code=2)
    jckpt.export_reference_layout(jdir, jbank, inv, unit_type="XIF",
                                  fix_code=2)
    kw = dict(unit_type="XIF", state_num=5, max_mix=3)
    from_port_by_jax = jckpt.import_reference_layout(tdir, inv, **kw)
    from_jax_by_port = tckpt.import_reference_layout(jdir, tinv, **kw,
                                                     device="cpu")
    from_port_by_port = tckpt.import_reference_layout(tdir, tinv, **kw,
                                                      device="cpu")
    # the files agree; the logs of the imports to one ulp (XLA's CPU log
    # is not correctly rounded, ROADMAP.md Queue 3)
    assert_banks_close(from_jax_by_port, from_port_by_jax, rtol=2e-7, atol=0)
    assert_banks_close(from_port_by_port, from_port_by_jax, rtol=2e-7, atol=0)
    for name in ("GMM_0/GMM_means.npy", "GMM_2/GMM_covariance.npy",
                 "HMM/transmat.npy", "HMM/pi.npy"):
        for unit in ("b", tinv.units[4 // 3]):
            assert np.array_equal(np.load(f"{tdir}/XIF/{unit}/{name}"),
                                  np.load(f"{jdir}/XIF/{unit}/{name}"))
    # the layout keeps the active parameters
    act = from_port_by_port.log_w.numpy() > -1e29
    np.testing.assert_allclose(from_port_by_port.means.numpy()[act],
                               bank.means.numpy()[act], rtol=1e-6)
    assert from_port_by_port.mix_counts[4] == 1
    with pytest.raises(tckpt.ParameterFileError):
        tckpt.import_reference_layout(str(tmp_path / "none"), tinv, **kw,
                                      device="cpu")
