"""Data, tensor and sequence parallelism over ``torch.distributed``.

Counterpart of ``hifigan_tpu/parallel``: one process per device (NCCL on
the card, gloo on the CPU; :mod:`hifigan_tpu_torch.parallel.launch`), the
JAX mesh's ``data`` and ``model`` axes as a ``DeviceMesh`` (:func:`make_mesh`),
XLA's automatic collectives as explicit ones: the gradient average of the
data-parallel step (:func:`make_sharded_train_step`), the tensor-parallel
layers (:func:`shard_params_tp`, :mod:`hifigan_tpu_torch.parallel.tensor`)
and the sequence-parallel Conformer (:func:`conformer_forward_seq_sharded`).
"""

from hifigan_tpu_torch.parallel.launch import init_from_env, single_process_group, spawn
from hifigan_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    make_sharded_train_step,
    replicate,
    shard_batch,
    shard_params_tp,
)
from hifigan_tpu_torch.parallel.sequence import conformer_forward_seq_sharded
from hifigan_tpu_torch.parallel.tensor import tp_spec_for

__all__ = [
    "batch_sharding",
    "conformer_forward_seq_sharded",
    "init_from_env",
    "make_mesh",
    "make_sharded_train_step",
    "replicate",
    "shard_batch",
    "shard_params_tp",
    "single_process_group",
    "spawn",
    "tp_spec_for",
]
