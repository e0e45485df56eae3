"""The rank bodies of ``tests/test_torch_parallel.py`` and of the parallel
tests of ``tests/test_torch_gpu.py``, and the launcher both use.  It
imports only torch, numpy and the port (no jax, nothing of
``poccala_tpu``), and holds no tests.

    python tests/test_torch_parallel_worker.py library RANK 4 PORT IN.npz OUT
    python tests/test_torch_parallel_worker.py cuda_step RANK 2 PORT - OUT

``library``: one process of a four-rank gloo world on the CPU.  Every
rank reads the same inputs from ``IN.npz`` (written by the test from the
JAX package's bank), runs the port's distributed functions on a ``4 x 1``
and a ``2 x 2`` mesh, and writes what it holds to ``OUT/rank{RANK}.npz``;
the test holds those against the JAX package.  ``cuda_step``: one process
of a two-rank gloo world on the card (CUDA tensors), a state-sharded train
step beside the one-rank step.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from poccala_tpu_torch.config import Config  # noqa: E402
from poccala_tpu_torch.io.corpus import Batch, UnitInventory  # noqa: E402
from poccala_tpu_torch.models import senone_bank as sb  # noqa: E402
from poccala_tpu_torch.parallel import decode as pdecode  # noqa: E402
from poccala_tpu_torch.parallel import dryrun  # noqa: E402
from poccala_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from poccala_tpu_torch.train import accumulators as acc  # noqa: E402
from poccala_tpu_torch.train.trainer import Trainer  # noqa: E402

STATE_NUM, MAX_L = 5, 3
ROOT = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(mode: str, n: int, inp: str, out_dir: str, limit: float):
    """Run this file's ``mode`` in ``n`` rank processes and wait for all of
    them; a failure of any rank, or the time limit, fails the caller after
    every process is stopped."""
    port = free_port()
    return run_ranks(lambda r: [sys.executable, __file__, mode, str(r),
                                str(n), str(port), inp, out_dir], n, limit)


def run_ranks(argv_of, n: int, limit: float) -> list[str]:
    """Start ``n`` processes (``argv_of(rank)``) with one thread each and
    wait for all of them; returns each one's stdout."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(argv_of(r), cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=limit)
            assert p.returncode == 0, f"rank {r} failed:\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def init_world(rank: int, world: int, port: int) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))


def batch_of(inp, key):
    return tuple(inp[f"{key}_{f}"] for f in ("labels", "lens", "xs", "masks"))


def put(out, prefix, stats):
    for f in acc.STATS_FIELDS:
        out[f"{prefix}_{f}"] = getattr(stats, f).numpy()


def put_bank(out, prefix, bank):
    for f in sb.FIELDS:
        out[f"{prefix}_{f}"] = getattr(bank, f).numpy()


def fit_config() -> Config:
    """The trainer configuration of the scheme-1 checks (the JAX test's,
    ``tests/test_scheme1_sharded.py:26-34``)."""
    cfg = Config()
    cfg.model.state_num = STATE_NUM
    cfg.model.mix_level = cfg.model.max_mix_level = 2
    cfg.frontend.dct_num = 2           # feat_dim 6 with double deltas
    cfg.train.max_label_len = MAX_L
    cfg.train.max_frames = 24
    cfg.train.smem = False
    return cfg


def library(rank: int, world: int, port: int, inp_path: str, out_dir: str):
    init_world(rank, world, port)
    inp = dict(np.load(inp_path))
    bank = sb.bank_from_numpy({f: inp[f"bank_{f}"] for f in sb.FIELDS},
                              device="cpu")
    out = {}

    # data 4 x 1: the replicated bank
    mesh4 = pmesh.make_mesh(data_axis=4, state_axis=1, device="cpu")
    bank_r = pmesh.replicate_bank(bank, mesh4)
    estep = pmesh.make_parallel_estep(mesh4, STATE_NUM, MAX_L)
    stats, logliks = estep(bank_r, *batch_of(inp, "b8"))
    put(out, "p4", stats)
    out["p4_logliks"] = logliks.numpy()
    padded, n = pmesh.pad_batch_for_mesh(batch_of(inp, "b5"), mesh4)
    stats, _ = estep(bank_r, *padded)
    put(out, "p4pad", stats)
    out["p4pad_n"] = np.asarray(n)
    step = pmesh.make_parallel_train_step(mesh4, STATE_NUM, MAX_L)
    b1, ll1 = step(bank_r, *batch_of(inp, "b16"))
    b2, ll2 = step(b1, *batch_of(inp, "b16"))
    put_bank(out, "p4step", b1)
    out["p4step_ll"] = np.asarray([float(ll1), float(ll2)])

    # data 2 x 2: the bank padded and sharded over senones
    mesh = pmesh.make_mesh(data_axis=2, state_axis=2, device="cpu")
    out["coords"] = np.asarray([mesh.get_local_rank("data"),
                                mesh.get_local_rank("state")])
    padded_bank, s_orig = pmesh.pad_bank_states(bank, 2)
    shard = pmesh.shard_bank_states(padded_bank, mesh)
    out["shard_rows"] = np.asarray(shard.num_states)
    put_bank(out, "shard", shard)
    estep = pmesh.make_state_sharded_estep(mesh, STATE_NUM, MAX_L)
    stats, logliks = estep(shard, *batch_of(inp, "b8"))
    put(out, "s22", stats)
    out["s22_logliks"] = logliks.numpy()
    align = pmesh.make_state_sharded_align(mesh, STATE_NUM, MAX_L)
    scores, label_pos = align(shard, *batch_of(inp, "b8"))
    out["s22_align_scores"] = scores.numpy()
    out["s22_label_pos"] = label_pos.numpy()
    step = pmesh.make_state_sharded_train_step(mesh, STATE_NUM, MAX_L)
    new_shard, ll = step(shard, *batch_of(inp, "b16"))
    whole = pmesh.unpad_bank_states(
        pmesh.unshard_bank_states(new_shard, mesh), s_orig)
    put_bank(out, "s22step", whole)
    out["s22step_ll"] = np.asarray(float(ll))
    out["s22step_rows"] = np.asarray(new_shard.num_states)

    # the grouped fit over the state shards: frames of every senone, this
    # rank's rows passed
    cfg = fit_config()
    lo = mesh.get_local_rank("state") * shard.num_states
    rows = slice(lo, lo + shard.num_states)
    frames, fmask = inp["fit_frames"][rows], inp["fit_mask"][rows]
    for reinit in (False, True):
        fit = pmesh.make_state_sharded_fit(
            mesh, 2, 2, reinit, c_covariance=cfg.model.c_covariance,
            converge_delta=cfg.train.gmm_converge_delta,
            max_iters=cfg.train.max_em_iters)
        gen = torch.Generator().manual_seed(int(inp["fit_seed"]))
        res = fit(gen, frames, fmask, shard.means, shard.log_var,
                  shard.log_w, shard.mix_counts)
        for f, t in zip(("means", "log_var", "log_w", "mix_counts"), res):
            out[f"fit{int(reinit)}_{f}"] = t.numpy()

    # decode: the toy world sharded over data, against the unsharded call
    words, dscores = pdecode.dryrun(mesh)
    out["dec_words"], out["dec_scores"] = words, dscores
    dec, utt = pdecode._toy_world(seed=1, device="cpu")
    seqs = [[0, 1, 2, 3], [4, 5], [0, 1], [4, 5, 0, 1], [4, 5]]
    feats = np.zeros((len(seqs), 48, 8), np.float32)
    nf = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        x = utt(s)
        feats[i, :len(x)], nf[i] = x, len(x)
    sharded = pdecode.decode_sharded(dec, feats, nf, mesh, return_nbest=3)
    solo = dec.decode_batch(feats, nf, return_nbest=3)
    out["dec_nbest_equal"] = np.asarray(
        [[(h.words, h.score) for h in u] for u in sharded]
        == [[(h.words, h.score) for h in u] for u in solo])
    # each data rank passes its own rows and gets them back with their
    # global offset; nothing is gathered
    d = mesh.get_local_rank("data")
    mine = slice(3 * d, 3 * d + 3)      # 6 rows: the batch padded by one
    feats6 = np.concatenate([feats, np.zeros_like(feats[:1])])
    nf6 = np.concatenate([nf, [0]]).astype(np.int32)
    f_loc, n_loc = pmesh.distribute_batch(mesh, (feats6[mine], nf6[mine]), 6)
    g_seqs, g_scores, offset = pdecode.decode_sharded_global(
        dec, f_loc, n_loc, mesh)
    full_seqs, full_scores = dec._run(feats6, nf6, dec._n_cand(1))
    out["global_offset"] = np.asarray(offset)
    out["global_equal"] = np.asarray(
        torch.equal(g_seqs, full_seqs[mine])
        and torch.equal(g_scores, full_scores[mine]))

    # trainers: the sharded scheme-1 round against the unsharded one on
    # the same bank and batches (tests/test_scheme1_sharded.py)
    inv = UnitInventory([f"u{i}" for i in range(5)])
    batches = [Batch(feats=inp["t_xs"], t_masks=inp["t_masks"],
                     labels=inp["t_labels"], label_lens=inp["t_lens"])]
    tr_s = Trainer(cfg, inv, mesh=mesh)
    tr_r = Trainer(cfg, inv, device="cpu")
    tr_s.use_bank(tr_r.bank)
    ll_r = tr_r.scheme1_round(batches, init=False, smem=False)
    ll_s = tr_s.scheme1_round(batches, init=False, smem=False)
    put_bank(out, "tr_s", tr_s.export_bank())
    put_bank(out, "tr_r", tr_r.bank)
    out["tr_ll"] = np.asarray([ll_s, ll_r])
    ll_e = tr_s.scheme2_epoch(batches)
    out["tr_ll_epoch"] = np.asarray(ll_e)
    # an init round with k-means and SMEM on the shards
    cfg3 = fit_config()
    cfg3.model.mix_level = cfg3.model.max_mix_level = 3
    cfg3.train.smem = True
    tr_3 = Trainer(cfg3, inv, mesh=mesh)
    ll_3 = tr_3.scheme1_round(batches, init=True)
    out["tr3_ll"] = np.asarray(ll_3)
    out["tr3_smem"] = np.asarray(tr_3.round_info.get("smem_accepted", -1))
    out["tr3_rows"] = np.asarray(tr_3.bank.num_states)

    # the multichip dry run, config-3 scale included
    summary = dryrun.dryrun_multichip(world, device="cpu")
    out["dryrun"] = np.asarray(json.dumps(summary))

    # a rank loads neither jax nor anything of the JAX package
    assert "jax" not in sys.modules, "a rank imported jax"
    assert not [m for m in sys.modules if m.split(".")[0] == "poccala_tpu"]
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


def cuda_step(rank: int, world: int, port: int, _: str, out_dir: str):
    """A ``1 x world`` mesh over gloo with CUDA tensors on one card: the
    state-sharded train step and alignment against the unsharded ones of
    the same rank, and the kernels' launch counts of the sharded calls."""
    from poccala_tpu_torch.config import ModelConfig
    from poccala_tpu_torch.ops.cuda import hmm_banded_cuda as hk
    from poccala_tpu_torch.train.alignment import align_batch

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_world(rank, world, port)
    rng = np.random.default_rng(3)
    cfg = ModelConfig(state_num=STATE_NUM, mix_level=4, max_mix_level=4)
    arrays = sb.bank_to_numpy(sb.create_bank(
        21, cfg, 13, generator=torch.Generator().manual_seed(3),
        device="cpu"))
    arrays["means"] = rng.normal(size=arrays["means"].shape).astype(
        np.float32)
    b, t_pad, max_l = 12, 50, 6
    labels = rng.integers(0, 21, size=(b, max_l)).astype(np.int32)
    lens = rng.integers(1, max_l + 1, size=b).astype(np.int32)
    xs = (rng.normal(size=(b, t_pad, 13)) * 1.5).astype(np.float32)
    masks = np.arange(t_pad)[None] < rng.integers(10, t_pad + 1,
                                                  size=b)[:, None]
    batch = (labels, lens, xs, masks)

    mesh = pmesh.make_mesh(data_axis=1, state_axis=world, device="cuda")
    whole = sb.bank_from_numpy(arrays, device="cuda")
    padded, s_orig = pmesh.pad_bank_states(whole, world)
    shard = pmesh.shard_bank_states(padded, mesh)
    for k in hk.KERNELS.values():
        k.launches = 0
    step = pmesh.make_state_sharded_train_step(mesh, STATE_NUM, max_l)
    new, ll = step(shard, *batch)
    scores, label_pos = pmesh.make_state_sharded_align(
        mesh, STATE_NUM, max_l)(shard, *batch)
    launches = {k: f.launches for k, f in hk.KERNELS.items()}
    got = pmesh.unpad_bank_states(pmesh.unshard_bank_states(new, mesh),
                                  s_orig)
    w_scores, w_label_pos = align_batch(whole, *batch, STATE_NUM, max_l)
    stats, _ = acc.batch_stats(whole, *batch, STATE_NUM, max_l)
    want = acc.apply_update(whole, stats)
    out = {f"got_{f}": getattr(got, f).cpu().numpy() for f in sb.FIELDS}
    out.update({f"want_{f}": getattr(want, f).cpu().numpy()
                for f in sb.FIELDS})
    out.update(ll=np.asarray([float(ll), float(stats.loglik)]),
               align_equal=np.asarray(torch.equal(label_pos, w_label_pos)
                                      and torch.equal(scores, w_scores)),
               rows=np.asarray(new.num_states),
               launches=np.asarray(json.dumps(launches)))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    {"library": library, "cuda_step": cuda_step}[sys.argv[1]](
        int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
        sys.argv[6])
