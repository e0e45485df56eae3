"""The PyTorch port's training modules vs the JAX package: Baum-Welch
statistics, the M-step, forced alignment, the flat start and the host
code copied into the port.

Banks are JAX banks carried across through the numpy weight converter;
batches are seeded numpy.  Tolerances: per-utterance logliks rtol 1e-5,
statistics rtol = atol = 1e-4 (``tests/test_accumulators.py:137-141``:
float32 sums in another order), an M-step from identical statistics
rtol 1e-6, Viterbi alignments exactly.
"""

import inspect
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poccala_tpu.io import corpus as jcorpus
from poccala_tpu.models import senone_bank as jsb
from poccala_tpu.train import accumulators as jacc
from poccala_tpu.train import alignment as jalign
from poccala_tpu.utils import logging as jlogging
from poccala_tpu_torch.io import corpus as tcorpus
from poccala_tpu_torch.models import senone_bank as tsb
from poccala_tpu_torch.train import accumulators as tacc
from poccala_tpu_torch.train import alignment as talign
from poccala_tpu_torch.utils import logging as tlogging

from .test_senone_topology import make_bank

torch.set_num_threads(1)

STATS = dict(rtol=1e-4, atol=1e-4)


def to_torch(jbank):
    return tsb.bank_from_numpy({f: np.asarray(getattr(jbank, f))
                                for f in tsb.FIELDS}, device="cpu")


def world(rng, dim=5, num_units=4, b=5, t_pad=30, max_l=3, mix=2):
    """A JAX bank, its port copy, and a ragged batch drawn near the bank's
    senone means, with a batch-padding utterance (label_len 0)."""
    cfg, jbank = make_bank(rng, num_units=num_units, state_num=5, mix=mix,
                           max_mix=mix, dim=dim)
    means = np.asarray(jbank.means)
    labels = rng.integers(0, num_units, size=(b, max_l)).astype(np.int32)
    lens = rng.integers(1, max_l + 1, size=b).astype(np.int32)
    lens[-1] = 0
    xs = np.zeros((b, t_pad, dim), np.float32)
    for i in range(b):
        units = labels[i, : max(lens[i], 1)]
        seq = np.repeat(units, t_pad // len(units) + 1)[:t_pad]
        for ti, u in enumerate(seq):
            s = u * 3 + rng.integers(0, 3)
            xs[i, ti] = means[s, rng.integers(0, mix)] + rng.normal(size=dim)
    t_true = rng.integers(t_pad // 2, t_pad + 1, size=b)
    t_true[0] = t_pad
    masks = np.arange(t_pad)[None] < t_true[:, None]
    return cfg, jbank, to_torch(jbank), (labels, lens, xs, masks)


def jax_batch(batch):
    return tuple(jnp.asarray(a) for a in batch)


def assert_stats_close(got, want, **tol):
    g = tacc.stats_to_numpy(got)
    for f in tacc.STATS_FIELDS:
        w = np.asarray(getattr(want, f))
        assert g[f].shape == w.shape, f
        np.testing.assert_allclose(g[f], w, err_msg=f, **(tol or STATS))


@pytest.mark.parametrize("normalizer", ["textbook", "reference"])
@pytest.mark.parametrize("count_final_exit", [True, False])
@pytest.mark.parametrize("bw_inner_iters", [1, 3])
def test_batch_stats_matches_jax(rng, normalizer, count_final_exit,
                                 bw_inner_iters):
    cfg, jbank, tbank, batch = world(rng)
    kw = dict(normalizer=normalizer, count_final_exit=count_final_exit,
              bw_inner_iters=bw_inner_iters)
    want, wll = jacc.batch_stats(jbank, *jax_batch(batch), 5, 3, **kw)
    got, gll = tacc.batch_stats(tbank, *batch, 5, 3, **kw)
    np.testing.assert_allclose(gll.numpy()[:-1], np.asarray(wll)[:-1],
                               rtol=1e-5)
    assert float(got.n_utts) == 4.0
    assert_stats_close(got, want)


def test_bw_inner_loop_stops_per_utterance(rng):
    """With a loose convergence delta some utterances stop after one pass
    and others iterate: each must follow its own while_loop."""
    cfg, jbank, tbank, batch = world(rng, b=6, t_pad=24)
    labels, lens, xs, masks = batch
    for i in range(6):
        want, wll = jacc.utterance_stats(
            jbank, jnp.asarray(labels[i]), jnp.asarray(max(lens[i], 1)),
            jnp.asarray(xs[i]), jnp.asarray(masks[i]), 5, 3,
            bw_inner_iters=4, bw_converge_delta=2.0)
        got, gll = tacc.utterance_stats(
            tbank, labels[i], max(lens[i], 1), xs[i], masks[i], 5, 3,
            bw_inner_iters=4, bw_converge_delta=2.0)
        np.testing.assert_allclose(float(gll), float(wll), rtol=1e-5)
        assert_stats_close(got, want)
    # the batched loop, where utterances stop at different iterations
    batch = (labels, np.maximum(lens, 1), xs, masks)
    stats, _ = tacc.batch_stats(tbank, *batch, 5, 3, bw_inner_iters=4)
    want, _ = jacc.batch_stats(jbank, *jax_batch(batch), 5, 3,
                               bw_inner_iters=4)
    assert_stats_close(stats, want)


def test_bf16_scoring_centres_each_utterance(rng):
    """bf16 centres on each utterance's padded [T, D] frame mean; a batch
    mean would move every utterance's bf16 rounding and its loglik far
    beyond 1e-5.  The statistics get the repo's bf16 bar (1e-3,
    ``tests/test_bf16_scoring.py:115``): the two packages' f32 frame means
    can differ in the last ulp, which flips the rounding of a few bf16
    operands and moves posteriors by ~1e-4."""
    cfg, jbank, tbank, batch = world(rng, dim=13)
    labels, lens, xs, masks = batch
    xs = xs + np.linspace(0, 10, len(xs))[:, None, None].astype(np.float32)
    batch = (labels, lens, xs, masks)
    want, wll = jacc.batch_stats(jbank, *jax_batch(batch), 5, 3,
                                 score_dtype="bfloat16")
    got, gll = tacc.batch_stats(tbank, *batch, 5, 3, score_dtype="bfloat16")
    np.testing.assert_allclose(gll.numpy()[:-1], np.asarray(wll)[:-1],
                               rtol=1e-5)
    assert_stats_close(got, want, rtol=1e-3, atol=1e-3)


def test_utterance_stats_and_padding(rng):
    """A single utterance equals JAX's, padded frames change nothing, and
    an all-padding batch slot (label_len 0) contributes nothing."""
    cfg, jbank, tbank, (labels, lens, xs, masks) = world(rng)
    want, wll = jacc.utterance_stats(
        jbank, jnp.asarray(labels[0]), jnp.asarray(lens[0]),
        jnp.asarray(xs[0]), jnp.asarray(masks[1]), 5, 3)
    got, gll = tacc.utterance_stats(tbank, labels[0], lens[0], xs[0],
                                    masks[1], 5, 3)
    np.testing.assert_allclose(float(gll), float(wll), rtol=1e-5)
    assert_stats_close(got, want)
    t_true = int(masks[1].sum())
    short, _ = tacc.utterance_stats(tbank, labels[0], lens[0],
                                    xs[0, :t_true], masks[1, :t_true], 5, 3)
    for f in tacc.STATS_FIELDS:
        np.testing.assert_allclose(tacc.stats_to_numpy(short)[f],
                                   tacc.stats_to_numpy(got)[f], **STATS)
    full, _ = tacc.batch_stats(tbank, labels, lens, xs, masks, 5, 3)
    part, _ = tacc.batch_stats(tbank, labels[:-1], lens[:-1], xs[:-1],
                               masks[:-1], 5, 3)
    for f in tacc.STATS_FIELDS:
        np.testing.assert_allclose(tacc.stats_to_numpy(full)[f],
                                   tacc.stats_to_numpy(part)[f], **STATS)


def test_stats_numpy_roundtrip_and_fold(rng):
    cfg, jbank, tbank, batch = world(rng)
    stats, _ = tacc.batch_stats(tbank, *batch, 5, 3)
    back = tacc.stats_from_numpy(tacc.stats_to_numpy(stats), device="cpu")
    for f in tacc.STATS_FIELDS:
        assert torch.equal(getattr(back, f), getattr(stats, f))
    zero = tacc.zero_stats(tbank)
    jzero = jacc.zero_stats(jbank)
    for f in tacc.STATS_FIELDS:
        assert getattr(zero, f).shape == np.shape(getattr(jzero, f))
    twice = tacc.add_stats(tacc.add_stats(zero, stats), stats)
    assert torch.allclose(twice.cx, 2 * stats.cx)


@pytest.mark.parametrize("floor", ["scalar", "vector"])
def test_apply_update_matches_jax(rng, floor):
    """The M-step from the same statistics (JAX's, carried across) gives
    the same bank; the vector floor is Trainer.var_floor's per-dim form."""
    cfg, jbank, tbank, batch = world(rng)
    stats, _ = jacc.batch_stats(jbank, *jax_batch(batch), 5, 3)
    c_cov = 1e-6 if floor == "scalar" else \
        np.linspace(0.05, 0.5, 5).astype(np.float32)
    want = jacc.apply_update(jbank, stats, c_covariance=c_cov)
    tstats = tacc.stats_from_numpy({f: np.asarray(getattr(stats, f))
                                    for f in tacc.STATS_FIELDS}, device="cpu")
    got = tacc.apply_update(tbank, tstats, c_covariance=c_cov)
    for f in tsb.FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    if floor == "vector":
        assert np.all(np.exp(got.log_var.numpy()) >= c_cov * (1 - 1e-6))
    frozen = tacc.apply_update(tbank, tstats, update_gmm=False)
    assert torch.equal(frozen.means, tbank.means)
    frozen = tacc.apply_update(tbank, tstats, update_transmat=False)
    assert torch.equal(frozen.log_A, tbank.log_A)


def test_align_batch_matches_jax(rng):
    cfg, jbank, tbank, batch = world(rng, b=6, t_pad=36)
    for sd in ("float32", "bfloat16"):
        wsc, wlp = jalign.align_batch(jbank, *jax_batch(batch), 5, 3,
                                      score_dtype=sd)
        gsc, glp = talign.align_batch(tbank, *batch, 5, 3, score_dtype=sd)
        assert glp.dtype == torch.int32
        assert np.array_equal(glp.numpy(), np.asarray(wlp))
        np.testing.assert_allclose(gsc.numpy(), np.asarray(wsc), rtol=1e-5)
    labels, lens, xs, masks = batch
    sc, lp = talign.align_utterance(tbank, labels[0], lens[0], xs[0],
                                    masks[0], 5, 3)
    assert np.array_equal(lp.numpy(), glp[0].numpy())


def test_flat_start(rng):
    cfg, jbank, tbank, _ = world(rng, dim=7)
    mean = rng.normal(size=7).astype(np.float32)
    var = rng.uniform(0.5, 3, size=7).astype(np.float32)
    want = jsb.flat_start(jbank, jnp.asarray(mean), jnp.asarray(var),
                          jax.random.PRNGKey(0), differentiation=False)
    got = tsb.flat_start(tbank, torch.from_numpy(mean), torch.from_numpy(var),
                         torch.Generator().manual_seed(0),
                         differentiation=False)
    for f in tsb.FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f == "log_var":
            # XLA's CPU log is not correctly rounded (it misses the
            # float64-rounded value for ~16% of inputs); torch's log is:
            # one ulp apart at most
            np.testing.assert_array_max_ulp(g, w, maxulp=1)
        else:
            assert np.array_equal(g, w), f
    c = 0.25
    diff = tsb.flat_start(tbank, torch.from_numpy(mean),
                          torch.from_numpy(var),
                          torch.Generator().manual_seed(1), coefficient=c)
    offs = (diff.means.numpy() - mean) / var             # [S, M, D] = diff_m
    assert np.allclose(offs, offs[:1], atol=1e-5)       # shared by senones
    assert np.allclose(offs, offs[:, :, :1], atol=1e-5)  # one per mixture
    assert np.all(np.abs(offs) < c)
    assert len(np.unique(np.round(offs[0, :, 0], 5))) == offs.shape[1]


# ----------------------------------------------------------------------
# host code copied from the JAX package
# ----------------------------------------------------------------------

VERBATIM = {
    "uniform_label_pos": (jalign.uniform_label_pos,
                          talign.uniform_label_pos),
    "check_alignment": (jalign.check_alignment, talign.check_alignment),
    "group_frames_by_senone": (jalign.group_frames_by_senone,
                               talign.group_frames_by_senone),
    "scan_corpus": (jcorpus.scan_corpus, tcorpus.scan_corpus),
    "shard_pairs": (jcorpus.shard_pairs, tcorpus.shard_pairs),
    "read_label": (jcorpus.read_label, tcorpus.read_label),
    "Batch": (jcorpus.Batch, tcorpus.Batch),
    "Corpus._encode_label": (jcorpus.Corpus._encode_label,
                             tcorpus.Corpus._encode_label),
    "Corpus.load_utterance": (jcorpus.Corpus.load_utterance,
                              tcorpus.Corpus.load_utterance),
    "Corpus._pack": (jcorpus.Corpus._pack, tcorpus.Corpus._pack),
    "synth_unit_signal": (jcorpus.synth_unit_signal,
                          tcorpus.synth_unit_signal),
    "generate_synthetic_corpus": (jcorpus.generate_synthetic_corpus,
                                  tcorpus.generate_synthetic_corpus),
    "CsvFormatter": (jlogging.CsvFormatter, tlogging.CsvFormatter),
    "get_logger": (jlogging.get_logger, tlogging.get_logger),
    "note": (jlogging.note, tlogging.note),
}


@pytest.mark.parametrize("name", sorted(VERBATIM))
def test_copied_source_is_verbatim(name):
    orig, copy = VERBATIM[name]
    assert inspect.getsource(copy) == inspect.getsource(orig)


def test_host_helpers_agree(rng):
    cfg, jbank, tbank, (labels, lens, xs, masks) = world(rng, b=6, t_pad=36)
    lens = np.maximum(lens, 1)
    for fn in ("uniform_label_pos",):
        assert np.array_equal(getattr(talign, fn)(lens, masks),
                              getattr(jalign, fn)(lens, masks))
    _, lp = talign.align_batch(tbank, labels, lens, xs, masks, 5, 3)
    lp = lp.numpy()
    assert np.array_equal(talign.check_alignment(lp, labels, lens),
                          jalign.check_alignment(lp, labels, lens))
    got = talign.group_frames_by_senone(
        xs, labels, lens, lp, tbank.num_states, 3, 16,
        rng=np.random.default_rng(0))
    want = jalign.group_frames_by_senone(
        xs, labels, lens, lp, tbank.num_states, 3, 16,
        rng=np.random.default_rng(0))
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_logger_writes_csv(tmp_path):
    log = tlogging.get_logger("torch-train-test", 7, log_dir=str(tmp_path),
                              console=False)
    tlogging.note(log, "\x1b[31mred\x1b[0m line", "w")
    for h in log.handlers:
        h.flush()
    row = (tmp_path / "log_7.csv").read_text().strip()
    assert row.startswith("[WARN],") and row.endswith(",red line")
    assert log.level == logging.INFO
