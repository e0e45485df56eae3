"""The port's parallel tier (``poccala_tpu_torch/parallel/``) against the JAX
package's (``tests/test_parallel.py``, ``tests/test_scheme1_sharded.py``,
``tests/test_cli_distributed.py``) on the CPU.

In-process tests run on a one-rank gloo group.  The rest spawn worlds of
four gloo ranks (``tests/test_torch_parallel_worker.py``; one world runs
every check of the library and writes one npz per rank) and hold what the
ranks wrote against the JAX functions on four of the conftest's CPU
devices, at ``tests/test_parallel.py``'s tolerances: statistics
rtol/atol 1e-4, logliks rtol 1e-5, ``label_pos`` and decoded words
exactly.  Each world has a 60 s timeout in ``init_process_group`` and a
limit on its wait, so a hung collective fails its test.
"""

import json
import os
import sys
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from poccala_tpu.parallel import decode as jdecode
from poccala_tpu.parallel import mesh as jmesh
from poccala_tpu.train import checkpoint as jckpt
from poccala_tpu_torch import cli as tcli
from poccala_tpu_torch.io.corpus import UnitInventory
from poccala_tpu_torch.models import senone_bank as tsb
from poccala_tpu_torch.parallel import mesh as pmesh
from poccala_tpu_torch.train import accumulators as tacc
from poccala_tpu_torch.train import checkpoint as tckpt
from poccala_tpu_torch.train.trainer import Trainer

from .test_parallel import synth_arrays
from .test_scheme1_sharded import _mk_batches
from .test_senone_topology import make_bank
from .test_torch_parallel_worker import (fit_config, free_port, run_ranks,
                                         run_world)

torch.set_num_threads(1)

STATS_TOL = dict(rtol=1e-4, atol=1e-4)
GMM = ("occ", "c", "cx", "cxx")
WORLD_LIMIT_S = 240


# ----------------------------------------------------------------------
# in-process: a one-rank gloo group
# ----------------------------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    assert not dist.is_initialized()
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def test_make_mesh_shapes_and_errors(one_rank):
    m = pmesh.make_mesh(device="cpu")
    assert pmesh.mesh_shape(m) == {"data": 1, "state": 1}
    assert m.mesh_dim_names == ("data", "state")
    assert (m.get_local_rank("data"), m.get_local_rank("state")) == (0, 0)
    assert pmesh.mesh_device(m) == torch.device("cpu")
    assert pmesh.mesh_shape(pmesh.make_mesh(1, 1, device="cpu")) == \
        {"data": 1, "state": 1}
    for data, state in ((-1, 2), (2, 1), (1, 2)):
        with pytest.raises(AssertionError):
            pmesh.make_mesh(data, state, device="cpu")


def test_make_mesh_starts_a_one_rank_group():
    assert not dist.is_initialized()
    try:
        m = pmesh.make_mesh(device="cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert pmesh.mesh_shape(m) == {"data": 1, "state": 1}
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_pad_unpad_bit_equal_to_jax(rng, n_shards):
    _, jbank = make_bank(rng, num_units=5, state_num=5, mix=2, max_mix=3,
                         dim=4)
    tbank = tsb.bank_from_numpy({f: np.asarray(getattr(jbank, f))
                                 for f in tsb.FIELDS}, device="cpu")
    jp, js = jmesh.pad_bank_states(jbank, n_shards)
    tp, ts = pmesh.pad_bank_states(tbank, n_shards)
    assert ts == js == 15
    for f in tsb.FIELDS:
        want = np.asarray(getattr(jp, f))
        got = getattr(tp, f).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    back = pmesh.unpad_bank_states(tp, ts)
    for f in tsb.FIELDS:
        assert torch.equal(getattr(back, f), getattr(tbank, f)), f


def test_pad_batch_bit_equal_to_jax(one_rank, rng):
    jm = jmesh.make_mesh(data_axis=8, state_axis=1)
    tm = pmesh.make_mesh(device="cpu")
    arrays = (rng.normal(size=(5, 3)).astype(np.float32),
              np.ones((5,), np.int32), np.ones((5, 4), bool))
    # the one-rank mesh pads to a multiple of 1: nothing
    (a,), n = pmesh.pad_batch_for_mesh(arrays[:1], tm)
    assert a is arrays[0] and n == 5

    class Eight:   # a mesh of 8 data ranks, for the pure padding rule
        mesh_dim_names = ("data", "state")
        shape = (8, 1)

    got, n = pmesh.pad_batch_for_mesh(arrays, Eight())
    want, jn = jmesh.pad_batch_for_mesh(arrays, jm)
    assert n == jn == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    tgot, _ = pmesh.pad_batch_for_mesh(
        tuple(torch.as_tensor(a) for a in arrays), Eight())
    for g, w in zip(tgot, want):
        assert np.array_equal(g.numpy(), w)


def test_one_rank_estep_equals_batch_stats(one_rank, rng):
    _, jbank = make_bank(rng, num_units=3, state_num=5, mix=2, max_mix=2,
                         dim=5)
    bank = tsb.bank_from_numpy({f: np.asarray(getattr(jbank, f))
                                for f in tsb.FIELDS}, device="cpu")
    batch = synth_arrays(rng, jbank)
    mesh = pmesh.make_mesh(device="cpu")
    pmesh.reset_traffic()
    for make in (pmesh.make_parallel_estep, pmesh.make_state_sharded_estep):
        stats, logliks = make(mesh, 5, 3)(bank, *batch)
        want, want_ll = tacc.batch_stats(bank, *batch, 5, 3)
        for f in tacc.STATS_FIELDS:
            torch.testing.assert_close(getattr(stats, f), getattr(want, f),
                                       rtol=0, atol=0, msg=f)
        torch.testing.assert_close(logliks, want_ll, rtol=0, atol=0)
    # one statistics buffer and one loglik row each; the state-sharded
    # E-step also exchanges its [B, T, N_s] lattice
    assert pmesh.all_reduce.calls == 5
    n_s = 3 * 3 + 2
    flat = sum(getattr(want, f).numel() for f in tacc.STATS_FIELDS)
    assert pmesh.all_reduce.bytes == 4 * (2 * flat + 2 * 8 + 8 * 20 * n_s)


# ----------------------------------------------------------------------
# four ranks: the library against JAX
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def four(tmp_path_factory):
    rng = np.random.default_rng(0)
    tmp = tmp_path_factory.mktemp("parallel4")
    cfg, jbank = make_bank(rng, num_units=5, state_num=5, mix=2, max_mix=2,
                           dim=5)
    inp = {f"bank_{f}": np.asarray(getattr(jbank, f)) for f in tsb.FIELDS}
    for key, b, t in (("b8", 8, 20), ("b5", 5, 20), ("b16", 16, 24)):
        for f, a in zip(("labels", "lens", "xs", "masks"),
                        synth_arrays(rng, jbank, b=b, t=t)):
            inp[f"{key}_{f}"] = a
    s_pad = 16
    inp["fit_frames"] = rng.normal(size=(s_pad, 12, 5)).astype(np.float32)
    mask = np.ones((s_pad, 12), bool)
    mask[3, 1:] = False          # a senone with too few frames keeps its GMM
    mask[9, 6:] = False
    inp["fit_mask"] = mask
    inp["fit_seed"] = np.asarray(7)
    tb = _mk_batches(rng, 5)[0]
    inp.update(t_xs=tb.feats, t_masks=tb.t_masks, t_labels=tb.labels,
               t_lens=tb.label_lens)
    np.savez(tmp / "in.npz", **inp)
    run_world("library", 4, str(tmp / "in.npz"), str(tmp), WORLD_LIMIT_S)
    ranks = [dict(np.load(tmp / f"rank{r}.npz", allow_pickle=False))
             for r in range(4)]
    return dict(cfg=cfg, jbank=jbank, inp=inp, ranks=ranks)


def jbatch(inp, key):
    return tuple(jnp.asarray(inp[f"{key}_{f}"])
                 for f in ("labels", "lens", "xs", "masks"))


def jax_mesh(data, state):
    return jmesh.make_mesh(data_axis=data, state_axis=state,
                           devices=jax.devices()[:4])


def test_rank_layout(four):
    """rank = d * state_axis + s, as reshape(data_axis, state_axis)."""
    coords = [tuple(r["coords"]) for r in four["ranks"]]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [int(r["shard_rows"]) for r in four["ranks"]] == [8] * 4


def test_shards_are_rows_of_the_jax_global_arrays(four):
    """A JAX bank padded and sharded over ``state``: ``np.asarray`` of each
    field gives the whole padded rows, and the port's ranks hold them,
    ``Shard(0)`` fields split between the two state ranks, ``Replicate()``
    fields whole on each."""
    from torch.distributed.tensor import Shard

    ranks = four["ranks"]
    jp = jmesh.shard_bank_states(
        jmesh.pad_bank_states(four["jbank"], 2)[0], jax_mesh(2, 2))
    for f, place in pmesh.bank_pspec().items():
        want = np.asarray(getattr(jp, f))
        for d in (0, 2):
            if isinstance(place, Shard):
                got = np.concatenate([ranks[d][f"shard_{f}"],
                                      ranks[d + 1][f"shard_{f}"]])
            else:
                got = ranks[d][f"shard_{f}"]
            assert got.dtype == want.dtype and np.array_equal(got, want), f


def assert_stats(ranks, prefix, want, s_orig=None):
    for f in tacc.STATS_FIELDS:
        w = np.asarray(getattr(want, f))
        if s_orig is not None and f in GMM:
            # state shards 0 and 1 of data rank 0; every data rank agrees
            for d in (0, 2):
                got = np.concatenate([ranks[d][f"{prefix}_{f}"],
                                      ranks[d + 1][f"{prefix}_{f}"]])
                np.testing.assert_allclose(got[:s_orig], w[:s_orig],
                                           **STATS_TOL, err_msg=f)
        else:
            for r in ranks:
                np.testing.assert_allclose(r[f"{prefix}_{f}"], w,
                                           **STATS_TOL, err_msg=f)


def test_data_parallel_estep_matches_jax(four):
    ranks, inp = four["ranks"], four["inp"]
    bank_r = jmesh.replicate_bank(four["jbank"], jax_mesh(4, 1))
    estep = jmesh.make_parallel_estep(jax_mesh(4, 1), 5, 3)
    stats, logliks = estep(bank_r, *jbatch(inp, "b8"))
    assert_stats(ranks, "p4", stats)
    for r in ranks:
        np.testing.assert_allclose(r["p4_logliks"], np.asarray(logliks),
                                   rtol=1e-5)
    # padded utterances contribute nothing
    padded, n = jmesh.pad_batch_for_mesh(
        tuple(inp[f"b5_{f}"] for f in ("labels", "lens", "xs", "masks")),
        jax_mesh(4, 1))
    stats, _ = estep(bank_r, *(jnp.asarray(a) for a in padded))
    assert_stats(ranks, "p4pad", stats)
    assert int(ranks[0]["p4pad_n"]) == n == 5
    assert float(ranks[0]["p4pad_n_utts"]) == 5.0


def test_data_parallel_train_step_matches_jax(four):
    ranks, inp = four["ranks"], four["inp"]
    step = jmesh.make_parallel_train_step(jax_mesh(4, 1), 5, 3)
    b1, ll1 = step(jmesh.replicate_bank(four["jbank"], jax_mesh(4, 1)),
                   *jbatch(inp, "b16"))
    _, ll2 = step(b1, *jbatch(inp, "b16"))
    for r in ranks:
        np.testing.assert_allclose(r["p4step_ll"], [float(ll1), float(ll2)],
                                   rtol=1e-5)
        assert r["p4step_ll"][1] > r["p4step_ll"][0]
        for f in ("means", "log_var", "log_w", "log_A"):
            np.testing.assert_allclose(r[f"p4step_{f}"],
                                       np.asarray(getattr(b1, f)),
                                       **STATS_TOL, err_msg=f)


def test_state_sharded_estep_matches_jax(four):
    ranks, inp = four["ranks"], four["inp"]
    bank_p, s_orig = jmesh.pad_bank_states(four["jbank"], 2)
    estep = jmesh.make_state_sharded_estep(jax_mesh(2, 2), 5, 3)
    stats, logliks = estep(bank_p, *jbatch(inp, "b8"))
    assert s_orig == 15
    assert_stats(ranks, "s22", stats, s_orig)
    for r in ranks:
        assert r["s22_occ"].shape == (8,)
        np.testing.assert_allclose(r["s22_logliks"], np.asarray(logliks),
                                   rtol=1e-5)


def test_state_sharded_align_matches_jax(four):
    ranks, inp = four["ranks"], four["inp"]
    bank_p, _ = jmesh.pad_bank_states(four["jbank"], 2)
    align = jmesh.make_state_sharded_align(jax_mesh(2, 2), 5, 3)
    scores, label_pos = align(bank_p, *jbatch(inp, "b8"))
    assert (np.asarray(label_pos) >= 0).any()
    for r in ranks:
        np.testing.assert_array_equal(r["s22_label_pos"],
                                      np.asarray(label_pos))
        np.testing.assert_allclose(r["s22_align_scores"], np.asarray(scores),
                                   rtol=1e-5)


def test_state_sharded_train_step_matches_jax(four):
    ranks, inp = four["ranks"], four["inp"]
    bank_p, s_orig = jmesh.pad_bank_states(four["jbank"], 2)
    step = jmesh.make_state_sharded_train_step(jax_mesh(2, 2), 5, 3)
    new, ll = step(bank_p, *jbatch(inp, "b16"))
    new = jmesh.unpad_bank_states(new, s_orig)
    for r in ranks:
        assert int(r["s22step_rows"]) == 8      # S_padded / K on every rank
        np.testing.assert_allclose(float(r["s22step_ll"]), float(ll),
                                   rtol=1e-5)
        for f in tsb.FIELDS:
            np.testing.assert_allclose(r[f"s22step_{f}"],
                                       np.asarray(getattr(new, f)),
                                       **STATS_TOL, err_msg=f)


def fit_rows(ranks, key, f):
    return np.concatenate([ranks[0][f"{key}_{f}"], ranks[1][f"{key}_{f}"]])


def test_state_sharded_fit_matches_jax(four):
    """reinit=False: grouped EM of each shard's senones, held to JAX's."""
    ranks, inp = four["ranks"], four["inp"]
    from poccala_tpu.config import Config as JConfig

    cfg = JConfig()
    bank_p, _ = jmesh.pad_bank_states(four["jbank"], 2)
    fit = jmesh.make_state_sharded_fit(
        jax_mesh(2, 2), 2, 2, False, c_covariance=cfg.model.c_covariance,
        converge_delta=cfg.train.gmm_converge_delta,
        max_iters=cfg.train.max_em_iters)
    want = fit(jax.random.PRNGKey(0), jnp.asarray(inp["fit_frames"]),
               jnp.asarray(inp["fit_mask"]), bank_p.means, bank_p.log_var,
               bank_p.log_w, bank_p.mix_counts)
    for f, w in zip(("means", "log_var", "log_w", "mix_counts"), want):
        np.testing.assert_allclose(fit_rows(ranks, "fit0", f), np.asarray(w),
                                   **STATS_TOL, err_msg=f)
        for r in (0, 1):   # data rank 1 holds the same shards
            np.testing.assert_array_equal(ranks[r][f"fit0_{f}"],
                                          ranks[r + 2][f"fit0_{f}"])
    assert fit_rows(ranks, "fit0", "mix_counts")[3] == 2   # kept (pad 0)


def test_state_sharded_kmeans_fit_is_the_unsharded_fit(four):
    """reinit=True: each shard's rows equal the port's unsharded fit of
    those rows with the shard's generator (one draw of the caller's
    generator plus the state index)."""
    ranks, inp = four["ranks"], four["inp"]
    bank_p = tsb.bank_from_numpy(
        {f: np.asarray(getattr(jmesh.pad_bank_states(four["jbank"], 2)[0], f))
         for f in tsb.FIELDS}, device="cpu")
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=torch.Generator()
                             .manual_seed(int(inp["fit_seed"]))))
    for s in (0, 1):
        rows = slice(8 * s, 8 * s + 8)
        tr = Trainer(fit_config(), UnitInventory(["a"]), device="cpu")
        tr.bank = tsb.replace(bank_p, **{
            f: getattr(bank_p, f)[rows]
            for f in ("means", "log_var", "log_w", "mix_counts")})
        tr.generator = torch.Generator().manual_seed(seed + s)
        tr.fit_gmms(inp["fit_frames"][rows], inp["fit_mask"][rows],
                    reinit=True)
        for f in ("means", "log_var", "log_w", "mix_counts"):
            for d in (0, 2):
                np.testing.assert_allclose(
                    ranks[d + s][f"fit1_{f}"], getattr(tr.bank, f).numpy(),
                    rtol=1e-6, atol=1e-6, err_msg=f)
    assert not np.array_equal(ranks[0]["fit1_means"], ranks[0]["fit0_means"])


def test_sharded_decode_matches_jax_and_unsharded(four):
    ranks = four["ranks"]
    words, scores = jdecode.dryrun(jax_mesh(2, 2))
    for r in ranks:
        np.testing.assert_array_equal(r["dec_words"], words)
        np.testing.assert_allclose(r["dec_scores"], scores, rtol=1e-4)
        assert bool(r["dec_nbest_equal"])
        assert bool(r["global_equal"])
    assert [int(r["global_offset"]) for r in ranks] == [0, 0, 3, 3]
    assert words.tolist() == [1, 1, 1, 2]


def test_sharded_trainer_matches_unsharded(four):
    """tests/test_scheme1_sharded.py in the port: a scheme-1 round (Viterbi
    realignment, grouped EM, the transition epoch) on the 2 x 2 mesh gives
    the unsharded trainer's bank, and so does the next embedded epoch."""
    for r in four["ranks"]:
        ll_s, ll_r = r["tr_ll"]
        assert np.isclose(ll_s, ll_r, rtol=1e-4), (ll_s, ll_r)
        for f in ("means", "log_var", "log_w", "log_A", "mix_counts"):
            np.testing.assert_allclose(r[f"tr_s_{f}"], r[f"tr_r_{f}"],
                                       **STATS_TOL, err_msg=f)
        assert r["tr_s_means"].shape[0] == 15           # padding stripped
        assert np.isfinite(float(r["tr_ll_epoch"]))
        # the k-means + SMEM init round on the shards
        assert np.isfinite(float(r["tr3_ll"])) and int(r["tr3_rows"]) == 8
        assert int(r["tr3_smem"]) >= 0
    assert len({float(r["tr3_ll"]) for r in four["ranks"]}) == 1
    assert len({int(r["tr3_smem"]) for r in four["ranks"]}) == 1


def test_dryrun_multichip_config3_scale(four):
    """No rank holds more than S_padded / K rows of a GMM tensor during the
    state-sharded step (the statistics' scatter adds one spare row)."""
    summaries = [json.loads(str(r["dryrun"])) for r in four["ranks"]]
    for s in summaries:
        assert s["mesh"] == {"data": 2, "state": 2}
        assert (s["c3_senones"], s["c3_padded"], s["c3_local"]) == \
            (2049, 2050, 1025)
        assert s["step_max_gmm_rows"] <= 1026 < 2050
        assert s["shard_bytes"] == 1025 * (2 * 16 * 39 + 16 + 1) * 4
        assert np.isfinite(s["c3_loglik"]) and np.isfinite(s["toy_loglik"])
        assert s["decode_words"] == [1, 1, 1, 2]
    assert len({s["c3_loglik"] for s in summaries}) == 1


# ----------------------------------------------------------------------
# the command line: --distributed across four rank processes
# ----------------------------------------------------------------------

UNITS = ["n", "i3", "h", "ao3", "m", "a1"]


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    from poccala_tpu.io.corpus import UnitInventory as JInv
    from poccala_tpu.io.corpus import generate_synthetic_corpus
    from poccala_tpu.lexicon import PinYin, PronunciationLexicon

    tmp = tmp_path_factory.mktemp("clidist4")
    inv = JInv(UNITS)
    unit_file = str(tmp / "units.txt")
    inv.save(unit_file)
    audio, label = generate_synthetic_corpus(str(tmp / "corp"), inv,
                                             num_utts=8, seed=3)
    lex = PronunciationLexicon()
    lex.generate(["你好", "你", "马"],
                 PinYin({"你": ["ni3"], "好": ["hao3"], "马": ["ma1"]}))
    lex_path = str(tmp / "lex.pkl")
    lex.save(lex_path)
    common = ["--units", unit_file,
              "--set", f"paths.audio_file_path={audio}",
              "--set", f"paths.label_file_path={label}",
              "--set", "mesh.data_axis=2", "--set", "mesh.state_axis=2",
              "--set", "model.mix_level=1", "--set", "model.max_mix_level=1",
              "--set", "train.max_frames=256",
              "--set", "train.max_label_len=8",
              "--set", "train.batch_size=8",
              "--set", "frontend.cmvn=true",
              "--set", "train.differentiation=false"]
    wavs = sorted(os.path.join(audio, f) for f in os.listdir(audio))[:3]
    ckpt = str(tmp / "ckpt")

    def ranks(*argv):
        port = free_port()
        return run_ranks(lambda r: [
            sys.executable, "-m", "poccala_tpu_torch.cli", "--device", "cpu",
            *common, *argv, "--distributed", "--coordinator",
            f"127.0.0.1:{port}", "--num-processes", "4", "--process-id",
            str(r)], 4, WORLD_LIMIT_S)

    trained = ranks("train", "--mode", "2", "--epochs", "2",
                    "--checkpoint", ckpt)
    decoded = ranks("decode", "--decoder", "device", "--checkpoint", ckpt,
                    "--lexicon", lex_path, *wavs)
    wav_list = str(tmp / "wavs.txt")
    with open(wav_list, "w") as f:
        f.write("\n".join(wavs) + "\n")
    served = ranks("serve", "--checkpoint", ckpt, "--lexicon", lex_path,
                   "--list", wav_list, "--batch-size", "2",
                   "--frame-bucket", "32")
    return dict(common=common, ckpt=ckpt, wavs=wavs, lex=lex_path,
                trained=trained, decoded=decoded, served=served, tmp=tmp)


def test_cli_train_distributed_writes_a_checkpoint_jax_reads(cli_world):
    ckpt = cli_world["ckpt"]
    tbank, tman = tckpt.load_checkpoint(ckpt, device="cpu")
    jbank, jman = jckpt.load_checkpoint(ckpt)
    assert tman["round"] == jman["round"] == 2
    assert tbank.num_states == 18            # 6 units x 3, padding stripped
    for f in tsb.FIELDS:
        assert np.array_equal(np.asarray(getattr(jbank, f)),
                              getattr(tbank, f).numpy()), f
    assert np.isfinite(tbank.means.numpy()).all()


def test_cli_train_distributed_matches_jax(cli_world, capsys):
    """The same ``train --distributed`` through the JAX CLI (data 4 x state
    2 over the conftest's 8 CPU devices; the flat start is deterministic)
    gives the port's bank.  The JAX CLI writes a sharded bank in orbax's
    format (``poccala_tpu/train/checkpoint.py:87-88``), which the port does
    not read: it comes across through the JAX loader and the numpy
    converter."""
    from poccala_tpu import cli as jcli

    path = str(cli_world["tmp"] / "jax_ckpt")
    jcli.main([*cli_world["common"], "--set", "mesh.data_axis=4",
               "train", "--mode", "2", "--epochs", "2", "--checkpoint",
               path, "--distributed"])
    assert "mesh: {'data': 4, 'state': 2}" in capsys.readouterr().err
    jbank, jman = jckpt.load_checkpoint(path)
    assert jman["format"] == "orbax"
    want = tsb.bank_from_numpy({f: np.asarray(getattr(jbank, f))
                                for f in tsb.FIELDS}, device="cpu")
    got, _ = tckpt.load_checkpoint(cli_world["ckpt"], device="cpu")
    for f in tsb.FIELDS:
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=1e-3, atol=1e-3, msg=f)


def test_cli_train_distributed_matches_one_process(cli_world, capsys):
    """The four-rank training gives the bank of the same command in one
    process, without --distributed."""
    solo = str(cli_world["tmp"] / "solo")
    tcli.main(["--device", "cpu", *cli_world["common"], "train", "--mode",
               "2", "--epochs", "2", "--checkpoint", solo])
    capsys.readouterr()
    got, _ = tckpt.load_checkpoint(cli_world["ckpt"], device="cpu")
    want, _ = tckpt.load_checkpoint(solo, device="cpu")
    for f in tsb.FIELDS:
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   **STATS_TOL, msg=f)


def test_cli_decode_and_serve_distributed(cli_world, capsys):
    """Every rank decodes its rows, rank 0 prints every utterance, equal
    to a one-process decode; serve's follower ranks answer rank 0's
    batches with the same words."""
    lines = [json.loads(l) for l in cli_world["decoded"][0].splitlines()]
    assert [l["wav"] for l in lines] == cli_world["wavs"]
    assert all(cli_world["decoded"][r] == "" for r in (1, 2, 3))
    tcli.main(["--device", "cpu", *cli_world["common"], "decode",
               "--decoder", "device", "--checkpoint", cli_world["ckpt"],
               "--lexicon", cli_world["lex"], *cli_world["wavs"]])
    solo = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    for g, w in zip(lines, solo):
        assert g["nbest"] and [h["words"] for h in g["nbest"]] == \
            [h["words"] for h in w["nbest"]]
        np.testing.assert_allclose([h["score"] for h in g["nbest"]],
                                   [h["score"] for h in w["nbest"]],
                                   rtol=1e-5)
    served = [json.loads(l) for l in cli_world["served"][0].splitlines()]
    assert [s["wav"] for s in served] == cli_world["wavs"]
    for s, w in zip(served, solo):
        assert s["nbest"][0]["words"] == w["nbest"][0]["words"]
    assert all(cli_world["served"][r] == "" for r in (1, 2, 3))


def test_distributed_requires_device_tier(cli_world):
    """JAX's rule (``poccala_tpu/cli.py:223-224``), before any group or
    mesh is made."""
    for decoder in ("vector", "simple"):
        with pytest.raises(SystemExit, match="requires --decoder device"):
            tcli.main(["--device", "cpu", *cli_world["common"], "decode",
                       "--checkpoint", cli_world["ckpt"], "--lexicon",
                       cli_world["lex"], "--decoder", decoder,
                       "--distributed", cli_world["wavs"][0]])
    assert not dist.is_initialized()
