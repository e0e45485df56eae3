"""Parallelism tier: rank meshes, sharded E-steps, multi-process init
(port of ``poccala_tpu/parallel``)."""

from poccala_tpu_torch.parallel.mesh import (
    bank_pspec,
    make_mesh,
    make_parallel_estep,
    make_parallel_train_step,
    make_state_sharded_estep,
    make_state_sharded_train_step,
    pad_bank_states,
    pad_batch_for_mesh,
    replicate_bank,
    shard_bank_states,
    unpad_bank_states,
)

__all__ = [
    "bank_pspec",
    "make_mesh",
    "make_parallel_estep",
    "make_parallel_train_step",
    "make_state_sharded_estep",
    "make_state_sharded_train_step",
    "pad_bank_states",
    "pad_batch_for_mesh",
    "replicate_bank",
    "shard_bank_states",
    "unpad_bank_states",
]
