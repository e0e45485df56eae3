"""Rank meshes and collective reductions for distributed training (port of
``poccala_tpu/parallel/mesh.py``).

JAX runs one controller that drives a ``Mesh`` of devices and
``shard_map``s each step over it.  Here one process runs per rank under
``torch.distributed``, and the mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` with
``mesh_dim_names=("data", "state")``:

* **data parallelism over utterances**: each rank of the ``data`` axis
  takes its own contiguous block of the batch's rows (``P("data")``);
* **model parallelism over senones**: each rank of the ``state`` axis
  holds rows ``[k·S/K, (k+1)·S/K)`` of the GMM tensors (``P("state")``);
  only the ``[B, T, N_s]`` sentence score lattice is exchanged, by max.

The rank layout is ``rank = d · state_axis + s``, as
``np.asarray(devices).reshape(data_axis, state_axis)`` gives.  The
collectives are explicit: where JAX calls ``psum`` the port calls
``dist.all_reduce(SUM)``, where it calls ``pmax`` ``all_reduce(MAX)``,
each on the process group of that mesh dimension.  Only ``all_reduce``
and ``broadcast`` are used, the two collectives gloo carries for CUDA
tensors, so the same code runs on NCCL, on gloo with the card and on gloo
on the CPU.  A global ``[B]`` or ``[B, T]`` result is assembled by
filling a zero buffer with the rank's own rows and summing it over the
``data`` group (``x + 0`` is exact).

A function returned by ``make_*`` takes the **global** padded batch, as
the jitted ``shard_map`` does: every rank passes the same batch and the
function takes the rank's rows.  It returns what JAX returns: statistics
summed over ``data``, GMM statistics local to the rank's state shard, and
per-utterance logliks and ``label_pos`` for the global batch.  The bank
it takes is the rank's: replicated, or the state shard of
:func:`shard_bank_states`.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

try:
    from torch.distributed.tensor import Replicate, Shard
except ImportError:  # torch < 2.5
    from torch.distributed._tensor import Replicate, Shard

from poccala_tpu_torch.models import senone_bank as sb
from poccala_tpu_torch.train import accumulators as acc
from poccala_tpu_torch.utils.device import resolve
from poccala_tpu_torch.utils.logmath import NEG_INF

AXES = ("data", "state")


# ----------------------------------------------------------------------
# Collectives (each counts its calls and bytes, as the kernel wrappers
# count their launches)
# ----------------------------------------------------------------------

def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None):
    """``dist.all_reduce`` in place on ``t``; returns ``t``."""
    dist.all_reduce(t, op=op, group=group)
    all_reduce.calls += 1
    all_reduce.bytes += t.numel() * t.element_size()
    return t


def broadcast(t: torch.Tensor, src: int = 0, group=None):
    """``dist.broadcast`` in place on ``t`` from global rank ``src``."""
    dist.broadcast(t, src=src, group=group)
    broadcast.calls += 1
    broadcast.bytes += t.numel() * t.element_size()
    return t


all_reduce.calls = all_reduce.bytes = 0
broadcast.calls = broadcast.bytes = 0


def reset_traffic() -> None:
    """Set the collectives' call and byte counts to 0."""
    all_reduce.calls = all_reduce.bytes = 0
    broadcast.calls = broadcast.bytes = 0


# ----------------------------------------------------------------------
# The mesh
# ----------------------------------------------------------------------

def _start_one_rank(dev: torch.device) -> None:
    """A one-rank process group in this process (NCCL on the card, gloo
    on the CPU), as JAX's ``make_mesh`` works over one device without a
    cluster."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else torch.cuda.current_device())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(data_axis: int = -1, state_axis: int = 1, device=None,
              timeout: timedelta | None = None) -> DeviceMesh:
    """Build the ``(data, state)`` mesh over the world's ranks.

    :param data_axis: ranks on the utterance-batch axis (-1: all
        remaining ranks)
    :param state_axis: ranks sharding the senone bank
    :param device: where this rank computes (None = the card); without
        an initialised process group a one-rank group is started here
    :param timeout: of the axes' process groups (None = torch's default)
    """
    dev = resolve(device)
    if not dist.is_initialized():
        _start_one_rank(dev)
    n = dist.get_world_size()
    if data_axis == -1:
        assert n % state_axis == 0, (n, state_axis)
        data_axis = n // state_axis
    assert data_axis * state_axis == n, (data_axis, state_axis, n)
    layout = torch.arange(n).reshape(data_axis, state_axis)
    rank = dist.get_rank()
    groups = {}
    # every rank creates every group, in one order (new_group's rule)
    for name, rows in zip(AXES, (layout.T, layout)):
        for ranks in rows.tolist():
            g = dist.group.WORLD if len(ranks) == n else \
                dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                groups[name] = g
    return DeviceMesh.from_group([groups[a] for a in AXES], dev.type,
                                 mesh=layout, mesh_dim_names=AXES)


def mesh_shape(mesh: DeviceMesh) -> dict:
    """``{"data": n, "state": k}`` (JAX's ``dict(mesh.shape)``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, device=None) -> None:
    """Join the multi-process group (replaces the shared-directory machine
    coordination keyed by ``ENV_ID``, ``Controller.py:116-120``):
    ``tcp://coordinator`` with the given world size and rank, or, with no
    coordinator and ``WORLD_SIZE`` set, ``env://`` (torchrun).  Each rank
    first takes the card ``LOCAL_RANK % device_count`` (NCCL); with
    ``device="cpu"`` the group is gloo's."""
    dev = resolve(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        raise ValueError("init_multihost needs a coordinator address or "
                         "the torchrun environment (WORLD_SIZE)")


def state_offset(bank: sb.SenoneBank, mesh: DeviceMesh) -> int:
    """The global index of this rank's first senone row
    (``axis_index("state") * S_local``)."""
    return mesh.get_local_rank("state") * bank.num_states


def shard_generator(generator: torch.Generator,
                    mesh: DeviceMesh) -> torch.Generator:
    """A CPU generator for this rank's state shard, JAX's
    ``fold_in(key, axis_index("state"))``: seeded with one draw of
    ``generator`` plus the shard's state index.  Every rank draws once, so
    the callers' generators stay in step."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return torch.Generator().manual_seed(seed + mesh.get_local_rank("state"))


# ----------------------------------------------------------------------
# Placements
# ----------------------------------------------------------------------

def bank_pspec() -> dict:
    """Placements of a :class:`SenoneBank`'s fields over the ``state``
    axis: the GMM tensors ``Shard(0)`` (rows = senones), the transition
    tensors and the senone map ``Replicate()`` (they are tiny,
    ``[U, N, N]``)."""
    return dict(means=Shard(0), log_var=Shard(0), log_w=Shard(0),
                log_A=Replicate(), log_pi=Replicate(), mix_counts=Shard(0),
                senone_map=Replicate())


def replicate_bank(bank: sb.SenoneBank, mesh: DeviceMesh) -> sb.SenoneBank:
    """Every rank gets global rank 0's bank, on its own device (the
    fits-on-one-chip case)."""
    dev = mesh_device(mesh)
    out = {}
    for f in sb.FIELDS:
        t = getattr(bank, f).to(dev).contiguous().clone()
        out[f] = broadcast(t, src=0)
    return sb.SenoneBank(**out)


def shard_bank_states(bank: sb.SenoneBank, mesh: DeviceMesh) -> sb.SenoneBank:
    """This rank's state shard of a full (padded) bank: rows ``[k·S/K,
    (k+1)·S/K)`` of every ``Shard(0)`` field of :func:`bank_pspec`, the
    ``Replicate()`` fields whole, on the rank's device (BASELINE.json
    config 4: banks larger than one chip's memory)."""
    k = mesh_shape(mesh)["state"]
    s = bank.num_states
    if s % k:
        raise ValueError(f"{s} senones do not divide the state axis ({k}): "
                         f"pad the bank with pad_bank_states")
    lo = mesh.get_local_rank("state") * (s // k)
    dev = mesh_device(mesh)
    out = {}
    for f, place in bank_pspec().items():
        t = getattr(bank, f)
        if isinstance(place, Shard):
            t = t[lo: lo + s // k]
        out[f] = t.to(dev).clone()
    return sb.SenoneBank(**out)


def unshard_bank_states(bank: sb.SenoneBank,
                        mesh: DeviceMesh) -> sb.SenoneBank:
    """Inverse of :func:`shard_bank_states`: the full (padded) bank on
    every rank, each ``Shard(0)`` field a zero-filled full tensor holding
    this rank's rows, summed over the ``state`` group."""
    k = mesh_shape(mesh)["state"]
    s_local = bank.num_states
    lo = mesh.get_local_rank("state") * s_local
    group = mesh.get_group("state")
    out = {}
    for f, place in bank_pspec().items():
        t = getattr(bank, f)
        if isinstance(place, Shard):
            full = t.new_zeros((s_local * k,) + t.shape[1:])
            full[lo: lo + s_local] = t
            t = all_reduce(full, group=group)
        out[f] = t
    return sb.SenoneBank(**out)


def pad_bank_states(bank: sb.SenoneBank, n_shards: int):
    """Pad the bank's senone axis to a multiple of ``n_shards`` so the
    GMM tensors divide evenly over the ``state`` axis.  Padded senones
    have ``log_w = NEG_INF`` (they score NEG_INF and ``senone_map`` never
    names them) and ``mix_counts = 0``.

    :returns: (padded bank, original senone count)
    """
    s = bank.num_states
    pad = (-s) % n_shards
    if pad == 0:
        return bank, s

    def p(a, fill=0.0):
        return torch.cat([a, a.new_full((pad,) + a.shape[1:], fill)])

    return sb.replace(bank, means=p(bank.means), log_var=p(bank.log_var),
                      log_w=p(bank.log_w, NEG_INF),
                      mix_counts=p(bank.mix_counts, 0)), s


def unpad_bank_states(bank: sb.SenoneBank, s_orig: int) -> sb.SenoneBank:
    """Inverse of :func:`pad_bank_states`."""
    if bank.num_states == s_orig:
        return bank
    return sb.replace(bank, means=bank.means[:s_orig],
                      log_var=bank.log_var[:s_orig],
                      log_w=bank.log_w[:s_orig],
                      mix_counts=bank.mix_counts[:s_orig])


def row_counts(mesh: DeviceMesh, n_local: int) -> torch.Tensor:
    """Every data rank's row count ``[data_axis]`` (on the host)."""
    counts = torch.zeros(mesh_shape(mesh)["data"], dtype=torch.int64,
                         device=mesh_device(mesh))
    counts[mesh.get_local_rank("data")] = n_local
    return all_reduce(counts, group=mesh.get_group("data")).cpu()


def distribute_batch(mesh: DeviceMesh, arrays: tuple, global_batch: int):
    """Each process passes its own rows of the batch (multi-host: each
    host's ``pathInfo`` slice, ``Controller.py:79-106``); the row counts,
    summed over ``data``, must make ``global_batch``.  Returns the rows as
    tensors on the rank's device, in the order of the ranks' data index
    (:func:`poccala_tpu_torch.parallel.decode.decode_sharded_global` takes
    them)."""
    n_local = int(np.shape(arrays[0])[0])
    total = int(row_counts(mesh, n_local).sum())
    if total != global_batch:
        raise ValueError(f"the data ranks hold {total} rows, not the "
                         f"global batch of {global_batch}")
    dev = mesh_device(mesh)
    return tuple(torch.as_tensor(np.asarray(a), device=dev) for a in arrays)


def pad_batch_for_mesh(arrays: tuple, mesh: DeviceMesh):
    """Pad the leading (batch) dim of each array to a multiple of the
    ``data`` axis size; padded utterances get empty masks / zero label
    lengths so they contribute nothing to the summed statistics.  NumPy
    arrays are padded with ``np.pad`` (bit-equal to JAX's), tensors with
    zero rows on their device."""
    n_data = mesh_shape(mesh)["data"]
    b = arrays[0].shape[0]
    pad = (-b) % n_data
    if pad == 0:
        return arrays, b
    out = []
    for a in arrays:
        if isinstance(a, torch.Tensor):
            out.append(torch.cat([a, a.new_zeros((pad,) + a.shape[1:])]))
        else:
            widths = [(0, pad)] + [(0, 0)] * (np.ndim(a) - 1)
            out.append(np.pad(np.asarray(a), widths))
    return tuple(out), b


def data_rows(mesh: DeviceMesh, b: int) -> slice:
    """This rank's contiguous rows of a global batch of ``b`` (``P("data")``)."""
    n = mesh_shape(mesh)["data"]
    if b % n:
        raise ValueError(f"a batch of {b} does not divide the data axis "
                         f"({n}): pad it with pad_batch_for_mesh")
    d = mesh.get_local_rank("data")
    return slice(d * (b // n), (d + 1) * (b // n))


def gather_rows(local: torch.Tensor, mesh: DeviceMesh, b: int) -> torch.Tensor:
    """The global ``[b, ...]`` from each data rank's rows: a zero buffer
    holding this rank's rows, summed over the ``data`` group."""
    out = local.new_zeros((b,) + local.shape[1:])
    out[data_rows(mesh, b)] = local
    return all_reduce(out, group=mesh.get_group("data"))


def psum_stats(stats: acc.BwStats, group) -> acc.BwStats:
    """Sum the nine :class:`BwStats` fields over ``group`` as one flat
    buffer: one collective, not nine."""
    parts = [getattr(stats, f) for f in acc.STATS_FIELDS]
    flat = all_reduce(torch.cat([p.reshape(-1) for p in parts]), group=group)
    out, lo = {}, 0
    for f, p in zip(acc.STATS_FIELDS, parts):
        out[f] = flat[lo: lo + p.numel()].view(p.shape)
        lo += p.numel()
    return acc.BwStats(**out)


def _local_batch(mesh, labels, lens, xs, masks):
    """This rank's rows of the global batch (host rows are sliced before
    they move to the device) and the global batch size."""
    b = int(np.shape(labels)[0])
    rows = data_rows(mesh, b)
    return (labels[rows], lens[rows], xs[rows], masks[rows]), b


# ----------------------------------------------------------------------
# Parallel E-step (replicated bank)
# ----------------------------------------------------------------------

def make_parallel_estep(mesh: DeviceMesh, state_num: int, max_label_len: int,
                        normalizer: str = "textbook",
                        count_final_exit: bool = True,
                        bw_inner_iters: int = 1,
                        score_dtype: str = "float32"):
    """The data-parallel E-step: each rank computes its rows' embedded-BW
    statistics (:func:`~poccala_tpu_torch.train.accumulators.batch_stats`)
    against its replica of the bank; the statistics are summed over
    ``data`` (the reference's accumulator-file fold as one collective) and
    the logliks gathered.  Padded utterances (``label_len == 0``)
    contribute nothing.

    Returns ``(bank, labels, lens, xs, masks) -> (stats, logliks [B])``."""
    group = mesh.get_group("data")

    def estep(bank, labels, lens, xs, masks):
        local, b = _local_batch(mesh, labels, lens, xs, masks)
        stats, logliks = acc.batch_stats(
            bank, *local, state_num, max_label_len, normalizer=normalizer,
            count_final_exit=count_final_exit,
            bw_inner_iters=bw_inner_iters, score_dtype=score_dtype)
        return psum_stats(stats, group), gather_rows(logliks, mesh, b)

    return estep


def make_parallel_train_step(mesh: DeviceMesh, state_num: int,
                             max_label_len: int, c_covariance=1e-6,
                             normalizer: str = "textbook",
                             count_final_exit: bool = True,
                             bw_inner_iters: int = 1,
                             update_transmat: bool = True,
                             update_gmm: bool = True,
                             score_dtype: str = "float32"):
    """Full distributed EM step: parallel E-step + the M-step on every
    rank.  Returns ``(bank, labels, lens, xs, masks) -> (bank', loglik)``."""
    estep = make_parallel_estep(mesh, state_num, max_label_len, normalizer,
                                count_final_exit=count_final_exit,
                                bw_inner_iters=bw_inner_iters,
                                score_dtype=score_dtype)

    def step(bank, labels, lens, xs, masks):
        stats, _ = estep(bank, labels, lens, xs, masks)
        new_bank = acc.apply_update(bank, stats, c_covariance=c_covariance,
                                    update_transmat=update_transmat,
                                    update_gmm=update_gmm)
        return new_bank, stats.loglik

    return step


# ----------------------------------------------------------------------
# State-sharded E-step (model parallelism over senones)
# ----------------------------------------------------------------------

def make_state_sharded_estep(mesh: DeviceMesh, state_num: int,
                             max_label_len: int,
                             normalizer: str = "textbook",
                             count_final_exit: bool = True,
                             bw_inner_iters: int = 1,
                             score_dtype: str = "float32"):
    """The E-step with the senone bank sharded over ``state`` (BASELINE
    config 4; the reference's unit partitioning across machines,
    ``Controller.py:47-77``).  Each rank holds and scores only its
    ``S/K`` senone rows; the only exchange across the state axis is the
    max of the ``[B, T, N_s]`` sentence score lattice (``state_axis_name``
    of :func:`~poccala_tpu_torch.train.accumulators.batch_stats`), after
    which the forward and backward kernels run on every rank.  The GMM
    statistics stay local to the shard; memory and scoring work scale as
    1/K.  The bank's senone axis must divide the state axis: use
    :func:`pad_bank_states`."""
    data_group = mesh.get_group("data")
    state_group = mesh.get_group("state")

    def estep(bank, labels, lens, xs, masks):
        local, b = _local_batch(mesh, labels, lens, xs, masks)
        stats, logliks = acc.batch_stats(
            bank, *local, state_num, max_label_len, normalizer=normalizer,
            count_final_exit=count_final_exit,
            bw_inner_iters=bw_inner_iters, score_dtype=score_dtype,
            state_axis_name=state_group, s_offset=state_offset(bank, mesh))
        return psum_stats(stats, data_group), gather_rows(logliks, mesh, b)

    return estep


def make_state_sharded_align(mesh: DeviceMesh, state_num: int,
                             max_label_len: int,
                             normalizer: str = "textbook",
                             score_dtype: str = "float32"):
    """Viterbi forced alignment with the senone bank sharded over
    ``state`` (scheme 1 on BASELINE config-4 banks): each rank scores its
    local senones, the lattices are assembled by max, and the Viterbi
    kernel runs on every rank; the full-S GMM tensors exist nowhere.
    Returns ``(bank, labels, lens, xs, masks) -> (scores [B],
    label_pos [B, T])`` for the global batch."""
    from poccala_tpu_torch.train import alignment as align_mod

    state_group = mesh.get_group("state")

    def align(bank, labels, lens, xs, masks):
        local, b = _local_batch(mesh, labels, lens, xs, masks)
        scores, label_pos = align_mod.align_batch(
            bank, *local, state_num, max_label_len, normalizer=normalizer,
            score_dtype=score_dtype, state_axis_name=state_group,
            s_offset=state_offset(bank, mesh))
        return gather_rows(scores, mesh, b), gather_rows(label_pos, mesh, b)

    return align


def make_state_sharded_fit(mesh: DeviceMesh, mix: int, max_mix: int,
                           reinit: bool, c_covariance=1e-6,
                           converge_delta: float = 1.28, max_iters: int = 32,
                           normalizer: str = "textbook"):
    """Grouped k-means (re)init + EM with the senone axis sharded over
    ``state`` (the scheme-1 M-side of ``Trainer.fit_gmms``).  The grouped
    program is independent per senone, so each rank fits its own senones'
    GMMs on its own frame buckets: no collective, no full-S tensor.

    Returns ``(generator, frames, mask, means, log_var, log_w,
    mix_counts) -> (means, log_var, log_w, mix_counts)``, every senone-axis
    argument and result this rank's rows.  The k-means seeding draws from
    :func:`shard_generator` of ``generator``."""
    from poccala_tpu_torch.train.trainer import fit_grouped

    def fit(generator, frames, mask, means, log_var, log_w, mix_counts):
        dev = means.device
        out = fit_grouped(
            shard_generator(generator, mesh),
            torch.as_tensor(frames, dtype=torch.float32, device=dev),
            torch.as_tensor(mask, device=dev).to(torch.bool),
            means[:, :max_mix], log_var, log_w, mix_counts, mix, reinit,
            c_covariance=c_covariance, converge_delta=converge_delta,
            max_iters=max_iters, normalizer=normalizer)
        return out[:4]

    return fit


def make_state_sharded_train_step(mesh: DeviceMesh, state_num: int,
                                  max_label_len: int, c_covariance=1e-6,
                                  normalizer: str = "textbook",
                                  count_final_exit: bool = True,
                                  bw_inner_iters: int = 1,
                                  update_transmat: bool = True,
                                  update_gmm: bool = True,
                                  score_dtype: str = "float32"):
    """Full EM step with the senone bank sharded over ``state``: sharded
    E-step + the M-step on each rank's own rows (the GMM update is
    elementwise per senone; the small transition update is the same on
    every shard).  The bank is never whole on any rank during the step.
    Returns ``(bank, labels, lens, xs, masks) -> (bank', loglik)``."""
    estep = make_state_sharded_estep(
        mesh, state_num, max_label_len, normalizer,
        count_final_exit=count_final_exit, bw_inner_iters=bw_inner_iters,
        score_dtype=score_dtype)

    def step(bank, labels, lens, xs, masks):
        stats, _ = estep(bank, labels, lens, xs, masks)
        new_bank = acc.apply_update(bank, stats, c_covariance=c_covariance,
                                    update_transmat=update_transmat,
                                    update_gmm=update_gmm)
        return new_bank, stats.loglik

    return step
