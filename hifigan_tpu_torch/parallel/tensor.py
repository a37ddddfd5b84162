"""Tensor parallelism in the forward, over the ``model`` axis of a mesh.

The JAX package places each parameter by ``_tp_spec_for``'s rules and lets
XLA partition the program.  Here each rank keeps only its shard of every
leaf the rules shard (:func:`parallelize`), and the forward says what XLA
would infer:

* **Megatron blocks.**  Where the rules shard an attention's q/k/v on the
  head axis and its ``out`` on the head axis, or an ``ffn1``/``ffn2`` pair
  on the hidden axis, each rank computes on its heads or hidden columns and
  one ``all_reduce`` over ``model`` sums the row-parallel product: one per
  attention block and one per FFN.  The replicated input gets the matching
  ``all_reduce`` in the backward (Megatron's f/g pair), and the biases
  used on a slice (q/k/v ``[H, hd]``, ``ffn1``) are marked to have their
  gradient summed over ``model`` (:func:`sync_tp_grads`).
* **Every other sharded leaf is gathered at use**, once per forward of the
  module :func:`parallelize` was given (generator convs, ODConv banks,
  projections, embeddings, the Conformer conv module, whose GLU splits its
  ``pw1`` output into halves and then normalises over all channels, so it
  cannot be split Megatron-style).  The gather is DTensor's Shard →
  Replicate redistribute, whose backward hands each rank the slice of the
  gradient that belongs to its shard: the compute that every ``model`` rank
  repeats is not summed over ranks.
* **Checkpoints hold full tensors.**  The module's ``state_dict`` gathers
  every shard (a collective: every rank calls it, whichever writes), and
  ``load_state_dict`` takes full tensors and keeps this rank's shard.

A sharded parameter carries ``tp_shard`` (its :class:`ShardInfo`); a
replicated bias used on a slice carries ``tp_grad_sum`` (the ``model``
group).
"""

from __future__ import annotations

import collections
import functools
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from hifigan_tpu_torch.models.layers import DenseGeneral, MultiHeadAttention

# collectives issued by the parallel code paths, by kind: "model_all_reduce"
# (a Megatron block's forward sum), "grad_all_reduce" (an optimiser
# update's data-parallel average)
counts: collections.Counter = collections.Counter()


def tp_spec_for(name: str, shape, model_axis: int):
    """The ``model``-axis placement of the parameter ``name`` (the port's
    dotted name; its last two parts are flax's leaf and parent names) of
    ``shape``: ``Shard(dim)`` or ``Replicate()``.  The rules of the JAX
    package's ``_tp_spec_for``, each applied only where the dim divides by
    ``model_axis`` and holds at least two rows a rank:

    - attention q/k/v kernels ``[D, H, hd]`` on the head axis (column), the
      ``out`` kernel ``[H, hd, D]`` on its head axis (row);
    - ``ffn1``/``pw1`` kernels on their output (column), ``ffn2``/``pw2`` on
      their input (row);
    - ODConv banks (``kernels``, 4-d) on their second-to-last axis, other
      ``kernels`` and every other ``kernel`` / ``embedding`` on the last;
    - everything else (biases, scales, norms, LoRA factors) replicated."""
    parts = name.split(".")
    leaf, parent = parts[-1], parts[-2] if len(parts) >= 2 else ""
    ndim = len(shape)

    def ok(dim: int) -> bool:
        return shape[dim] % model_axis == 0 and shape[dim] >= 2 * model_axis

    if leaf == "kernel":
        if parent in ("q", "k", "v") and ndim == 3 and ok(1):
            return Shard(1)
        if parent == "out" and ndim == 3 and ok(0):
            return Shard(0)
        if parent in ("ffn1", "pw1") and ndim == 2 and ok(1):
            return Shard(1)
        if parent in ("ffn2", "pw2") and ndim == 2 and ok(0):
            return Shard(0)
    if ndim >= 2 and ok(ndim - 1):
        if "kernels" in leaf:
            return Shard(ndim - 2) if ndim == 4 and ok(ndim - 2) else Shard(ndim - 1)
        if "kernel" in leaf or leaf == "embedding":
            return Shard(ndim - 1)
    return Replicate()


@dataclass(frozen=True)
class ShardInfo:
    """A sharded parameter's axis, full shape and ``model`` mesh."""

    dim: int
    shape: torch.Size
    mesh: DeviceMesh


def gather(local: torch.Tensor, info: ShardInfo) -> torch.Tensor:
    """The full tensor from this rank's shard (a collective over the
    ``model`` group); its backward keeps this rank's slice of the gradient."""
    stride = torch.empty(info.shape, device="meta").stride()
    return DTensor.from_local(local, info.mesh, [Shard(info.dim)], run_check=False, shape=info.shape,
                              stride=stride).full_tensor()


def local_slice(full: torch.Tensor, info: ShardInfo) -> torch.Tensor:
    """This rank's shard of ``full``, with no communication."""
    n = info.mesh.size()
    return full.chunk(n, info.dim)[info.mesh.get_local_rank()].clone()


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, ``all_reduce`` of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: ``all_reduce`` forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        counts["model_all_reduce"] += 1
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _column_forward(dense: DenseGeneral, group, rank: int, copy_input: bool, x: torch.Tensor) -> torch.Tensor:
    """``dense`` on this rank's output columns (``rank`` within ``model``):
    kernel ``[*in, out/n, ...]``, the replicated bias taken on the same rows
    of its first axis."""
    if copy_input:
        x = _CopyToModel.apply(x, group)
    dt, w = dense.dtype, dense.kernel
    out_local = w.shape[dense.n_in:]
    lo = rank * out_local[0]
    lead = x.shape[: x.dim() - dense.n_in]
    y = x.reshape(*lead, dense.fan_in).to(dt) @ w.reshape(dense.fan_in, -1).to(dt)
    return y.reshape(*lead, *out_local) + dense.bias[lo: lo + out_local[0]].to(dt)


def _row_forward(dense: DenseGeneral, group, x: torch.Tensor) -> torch.Tensor:
    """``dense`` on this rank's input rows (its heads or hidden columns), the
    partial products summed over ``model``, then the bias."""
    dt, w = dense.dtype, dense.kernel
    fan_local = math.prod(w.shape[: dense.n_in])
    lead = x.shape[: x.dim() - dense.n_in]
    y = x.reshape(*lead, fan_local).to(dt) @ w.reshape(fan_local, -1).to(dt)
    y = _ReduceFromModel.apply(y, group)
    return y.reshape(*lead, *dense.out_shape) + dense.bias.to(dt)


def _megatron_attention(mha: MultiHeadAttention, group, q_in, kv_in, mask=None, kv_gather=None):
    q_in2 = _CopyToModel.apply(q_in, group)
    kv_in2 = q_in2 if kv_in is q_in else _CopyToModel.apply(kv_in, group)
    return MultiHeadAttention.forward(mha, q_in2, kv_in2, mask, kv_gather)


def _gathering_forward(module: nn.Module, gathered: list, *args, **kwargs):
    """``module``'s own forward with every gathered-at-use leaf in place as
    its full tensor; the shards are put back afterwards."""
    full = [gather(p, p.tp_shard) for _, _, p in gathered]
    for (owner, attr, _), t in zip(gathered, full):
        owner._parameters[attr] = t
    try:
        return type(module).forward(module, *args, **kwargs)
    finally:
        for owner, attr, p in gathered:
            owner._parameters[attr] = p


def _megatron_sites(module: nn.Module, specs: dict) -> tuple[list, list]:
    """The attentions whose q/k/v and ``out`` are sharded on the head axis,
    and the ``(ffn1, ffn2)`` pairs sharded column/row, with their names."""
    def spec(prefix, leaf):
        return specs.get(f"{prefix}.{leaf}.kernel" if prefix else f"{leaf}.kernel")

    attentions, ffns = [], []
    for name, m in module.named_modules():
        if isinstance(m, MultiHeadAttention):
            if all(spec(name, x) == Shard(1) for x in "qkv") and spec(name, "out") == Shard(0):
                attentions.append((name, m))
        elif isinstance(getattr(m, "ffn1", None), DenseGeneral) and isinstance(getattr(m, "ffn2", None), DenseGeneral):
            if spec(name, "ffn1") == Shard(1) and spec(name, "ffn2") == Shard(0):
                ffns.append((name, m))
    return attentions, ffns


def parallelize(module: nn.Module, model_mesh: DeviceMesh) -> nn.Module:
    """Shard ``module``'s parameters over the 1-d ``model_mesh`` by
    :func:`tp_spec_for` (each rank keeps its shard, drawn from the full
    tensor by ``distribute_tensor``), make its Megatron blocks compute on
    their shards and gather every other sharded leaf at use in ``module``'s
    forward, and make its state dict hold full tensors.  In place; returns
    ``module``.  Call the module through its forward: another method reads
    the shards as they are."""
    n, rank = model_mesh.size(), model_mesh.get_local_rank()
    group = model_mesh.get_group()
    params = dict(module.named_parameters())
    specs = {name: tp_spec_for(name, p.shape, n) for name, p in params.items()}
    attentions, ffns = _megatron_sites(module, specs)
    megatron = set()
    sliced_biases = []
    for name, mha in attentions:
        for x in "qkv":
            dense = getattr(mha, x)
            dense.forward = functools.partial(_column_forward, dense, group, rank, False)
            sliced_biases.append(dense.bias)
        mha.out.forward = functools.partial(_row_forward, mha.out, group)
        mha.forward = functools.partial(_megatron_attention, mha, group)
        megatron.update(f"{name}.{x}.kernel" for x in ("q", "k", "v", "out"))
    for name, m in ffns:
        m.ffn1.forward = functools.partial(_column_forward, m.ffn1, group, rank, True)
        m.ffn2.forward = functools.partial(_row_forward, m.ffn2, group)
        sliced_biases.append(m.ffn1.bias)
        megatron.update(f"{name}.{x}.kernel" for x in ("ffn1", "ffn2"))
    for bias in sliced_biases:
        bias.tp_grad_sum = group

    gathered = []
    with torch.no_grad():
        for name, p in params.items():
            spec = specs[name]
            if not isinstance(spec, Shard):
                continue
            p.tp_shard = ShardInfo(spec.dim, p.shape, model_mesh)
            p.data = distribute_tensor(p.detach(), model_mesh, [spec]).to_local().clone()
            if name not in megatron:
                owner_name, _, attr = name.rpartition(".")
                gathered.append((module.get_submodule(owner_name), attr, p))
    module.forward = functools.partial(_gathering_forward, module, gathered)
    sharded = {name: p for name, p in params.items() if hasattr(p, "tp_shard")}
    module.register_state_dict_post_hook(functools.partial(_full_state_dict, sharded))
    module.register_load_state_dict_pre_hook(functools.partial(_local_state_dict, sharded))
    return module


def _full_state_dict(sharded: dict, module, state_dict, prefix, local_metadata) -> None:
    for name, p in sharded.items():
        key = prefix + name
        if key in state_dict:
            state_dict[key] = gather(p.detach(), p.tp_shard)


def _local_state_dict(sharded: dict, module, state_dict, prefix, *args) -> None:
    for name, p in sharded.items():
        key = prefix + name
        if key in state_dict and state_dict[key].shape == p.tp_shard.shape:
            state_dict[key] = local_slice(state_dict[key], p.tp_shard)


def sync_tp_grads(params) -> None:
    """Sum over ``model`` the gradients of the replicated biases used on a
    slice, in one ``all_reduce`` a group."""
    by_group = collections.defaultdict(list)
    for p in params:
        if p.grad is not None and getattr(p, "tp_grad_sum", None) is not None:
            by_group[p.tp_grad_sum].append(p.grad)
    for group, grads in by_group.items():
        all_reduce_flat(grads, group)


def all_reduce_flat(tensors: list[torch.Tensor], group, scale: float = 1.0) -> int:
    """Sum ``tensors`` over ``group`` in place, times ``scale``, through one
    flat buffer a dtype, copied in and back in a few launches (not one a
    tensor: a step has hundreds); returns the number of ``all_reduce``
    calls."""
    by_dtype = collections.defaultdict(list)
    for t in tensors:
        by_dtype[t.dtype].append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        if scale != 1.0:
            flat.mul_(scale)
        torch._foreach_copy_(same, [part.view_as(t) for t, part in zip(same, flat.split([t.numel() for t in same]))])
    return len(by_dtype)


def global_norm(params, group) -> torch.Tensor:
    """The global norm of ``params``' gradients with each shard counted once
    (summed over ``group``) and each replicated leaf once."""
    sharded = [p.grad for p in params if hasattr(p, "tp_shard")]
    replicated = [p.grad for p in params if not hasattr(p, "tp_shard")]

    def sq(grads):
        if not grads:
            return torch.zeros((), device=params[0].grad.device)
        return torch.stack(torch._foreach_norm(grads)).square().sum()

    total = sq(sharded)
    dist.all_reduce(total, group=group)
    return (total + sq(replicated)).sqrt()
