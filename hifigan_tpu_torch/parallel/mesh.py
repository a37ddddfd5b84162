"""The ``(data, model)`` mesh over the process group, and the sharded step.

Counterpart of ``hifigan_tpu/parallel/mesh.py``.  The vocoder is small, so
the main axis is data parallelism: every rank holds the parameters, takes
its rows of the global batch, and the gradients are averaged over ``data``
before each optimiser update.  An optional ``model`` axis shards the wide
layers by the JAX package's rules (:mod:`hifigan_tpu_torch.parallel.tensor`).
XLA inserts these collectives itself; here they are explicit: one flat
``all_reduce`` a dtype per optimiser update over ``data``, one over
``model`` for the biases that Megatron blocks use on a slice, and one for
the step's metrics.  On one process every collective is over a group of
one, and the numbers equal the plain step's.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from hifigan_tpu_torch.parallel import tensor as tp


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> DeviceMesh:
    """A ``(data, model)`` mesh over the process group's ranks, rank ``r`` at
    ``(r // n_model, r % n_model)`` (JAX's row-major reshape of the device
    list).  Default: every rank on ``data``."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    assert n_data * n_model == world, f"mesh {n_data}x{n_model} != {world} processes"
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=("data", "model"))


def batch_sharding(mesh: DeviceMesh) -> tuple:
    """The leading (batch) axis split over ``data``, replicated over
    ``model``."""
    return (Shard(0), Replicate())


def replicate(mesh: DeviceMesh) -> tuple:
    return (Replicate(), Replicate())


def shard_params_tp(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Shard ``module``'s parameters over ``mesh``'s ``model`` axis by the
    tensor-parallel rules (:func:`hifigan_tpu_torch.parallel.tensor.parallelize`);
    with a ``model`` axis of 1 it stays replicated.  In place; returns it."""
    if mesh["model"].size() > 1:
        tp.parallelize(module, mesh["model"])
    return module


def shard_batch(batch, mesh: DeviceMesh):
    """This rank's rows ``[r·B/n, (r+1)·B/n)`` of every array of the global
    ``batch`` (``r`` its ``data`` coordinate, ``n`` the axis size): JAX's
    leading-axis split over ``data``.  With one ``data`` rank the batch (or a
    device sampler's seed) passes as it is."""
    n = mesh["data"].size()
    if n == 1:
        return batch
    if not isinstance(batch, Mapping):
        raise TypeError(f"a batch split over {n} data ranks must be a dict of arrays, got {type(batch).__name__}")
    r = mesh["data"].get_local_rank()
    out = {}
    for key, value in batch.items():
        rows = value.shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows is not divisible over {n} data ranks")
        out[key] = value[r * rows // n: (r + 1) * rows // n]
    return out


def make_grad_sync(mesh: DeviceMesh) -> Callable:
    """``sync(optimiser)``, called before each optimiser update: sums over
    ``model`` the gradients of the biases used on a slice, averages every
    gradient over ``data`` (one flat ``all_reduce`` a dtype, counted in
    ``tensor.counts["grad_all_reduce"]``), and, when ``model`` shards some
    parameters, has the optimiser clip by the norm that counts each shard
    once."""
    data, model = mesh["data"], mesh["model"]
    n_data = data.size()

    def sync(opt) -> None:
        params = [p for p in opt.params if p.grad is not None]
        tp.sync_tp_grads(params)
        tp.counts["grad_all_reduce"] += tp.all_reduce_flat([p.grad for p in params], data.get_group(), 1.0 / n_data)
        if model.size() > 1 and any(hasattr(p, "tp_shard") for p in params):
            opt.global_norm = lambda ps: tp.global_norm(ps, model.get_group())

    return sync


def make_sharded_train_step(train_step, mesh: DeviceMesh):
    """``step(state, batch) → (state, metrics)`` over ``mesh``: each rank runs
    ``train_step`` (from :func:`hifigan_tpu_torch.train.make_train_step`, one
    optimiser step a call) on its rows of the global ``batch``, the
    gradients synchronised before each update (:func:`make_grad_sync`), and
    the metrics averaged over ``data`` (JAX's are the global batch's).  The
    state's vocoder is replicated or sharded beforehand
    (:func:`shard_params_tp`); every rank passes the same global batch."""
    sync = make_grad_sync(mesh)
    data = mesh["data"]

    def step(state, batch):
        state, metrics = train_step(state, shard_batch(batch, mesh), grad_sync=sync)
        keys = list(metrics)
        values = torch.stack([metrics[k].float() for k in keys])
        dist.all_reduce(values, group=data.get_group())
        values = values / data.size()
        return state, {k: v for k, v in zip(keys, values.unbind())}

    return step


def full_state_dict(state) -> dict:
    """``state.state_dict()`` with every sharded tensor whole: the vocoder's
    parameters (gathered by its state-dict hook) and the Adam moments of its
    sharded parameters.  A collective: every rank calls it; one rank
    writes."""
    sd = state.state_dict()
    for key in ("gen_opt", "disc_opt"):
        opt = getattr(state, key)
        moments = sd[key]["adam"]["state"]
        for i, p in enumerate(opt.params):
            if hasattr(p, "tp_shard") and i in moments:
                moments[i] = {k: tp.gather(v, p.tp_shard) if k in ("exp_avg", "exp_avg_sq") else v
                              for k, v in moments[i].items()}
    return sd


def load_full_state_dict(state, sd: dict) -> None:
    """Load a whole state dict (:func:`full_state_dict`, or a plain run's)
    into a state whose vocoder is sharded: each rank keeps its shards."""
    sd = dict(sd)
    for key in ("gen_opt", "disc_opt"):
        opt = getattr(state, key)
        adam = dict(sd[key]["adam"])
        moments = dict(adam["state"])
        for i, p in enumerate(opt.params):
            if hasattr(p, "tp_shard") and i in moments:
                moments[i] = {k: tp.local_slice(v, p.tp_shard) if k in ("exp_avg", "exp_avg_sq") else v
                              for k, v in moments[i].items()}
        adam["state"] = moments
        sd[key] = dict(sd[key], adam=adam)
    state.load_state_dict(sd)
