"""Sequence parallelism for the chunked Conformer encoder.

Counterpart of ``hifigan_tpu/parallel/sequence.py``: the time axis of one
long utterance is split over the ranks of a process group, and the
encoder's forward runs on each rank's frames with explicit collectives:

* **attention**: queries stay local; keys and values are all-gathered along
  time.  The chunk mask is block-causal (each chunk attends to every
  earlier chunk), so a rank needs the earlier ranks' keys and values; the
  mask is built from **global** positions, which reproduces the unsharded
  math;
* **causal depthwise conv** (k = 15): a halo of the ``k − 1`` frames before
  the shard, sent point to point by the ranks that hold them.  When shards
  are shorter than ``k − 1`` frames the halo spans several earlier ranks
  (one hop each); rank 0's halo is zeros, the unsharded left padding;
* everything else (FFN, LayerNorm, GLU, projections) is positionwise and
  runs on the rank's frames.  The sinusoidal positions start at the rank's
  offset.

The forward runs the port's own modules (:class:`ChunkedConformer`'s
layers, with the gather and the halo passed in), so one set of weights
serves the sharded and the unsharded encoder.  It is a forward pass, under
``no_grad``.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from hifigan_tpu_torch.models.conformer import ChunkedConformer


def _all_gather_time(x: torch.Tensor, group) -> torch.Tensor:
    """``x [B, T_local, ...]`` of every rank, concatenated along time in rank
    order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def _halo(h: torch.Tensor, group, need: int) -> torch.Tensor:
    """The ``need`` frames of the sequence that precede this rank's ``h [B,
    T_local, C]``, zeros before its start: hop ``j`` brings rank ``r − j``'s
    frames, as many hops as ``need`` takes."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    t_local = h.shape[1]
    hops = -(-need // t_local)
    received = [torch.zeros_like(h) for _ in range(hops)]  # received[i]: from rank r − (i + 1)
    ops = []
    for hop in range(1, hops + 1):
        if r + hop < n:
            ops.append(dist.P2POp(dist.isend, h.contiguous(), dist.get_global_rank(group, r + hop), group))
        if r - hop >= 0:
            ops.append(dist.P2POp(dist.irecv, received[hop - 1], dist.get_global_rank(group, r - hop), group))
    if ops:
        for request in dist.batch_isend_irecv(ops):
            request.wait()
    return torch.cat(received[::-1], dim=1)[:, -need:]


@torch.no_grad()
def conformer_forward_seq_sharded(model: ChunkedConformer, mel: torch.Tensor, *, group=None) -> torch.Tensor:
    """``model(mel, chunked=True)`` with the time axis split over ``group``'s
    ranks (the default group when None).  Every rank passes the whole
    ``mel [B, T, input_dim]``; each returns its time shard of the output,
    ``[B, T / n, hidden]``, frames ``[r·T/n, (r+1)·T/n)``."""
    group = group if group is not None else dist.group.WORLD
    n, r = dist.get_world_size(group), dist.get_rank(group)
    T = mel.shape[1]
    if T % n:
        raise ValueError(f"T={T} not divisible by {n} shards")
    t_local = T // n
    offset = r * t_local
    dt = model.dtype
    x = mel[:, offset: offset + t_local]
    h = model.input_proj(x.to(dt)) + model.positions[offset: offset + t_local].to(dt)
    q_blocks = (offset + torch.arange(t_local, device=mel.device)) // model.chunk_size
    k_blocks = torch.arange(T, device=mel.device) // model.chunk_size
    mask = (k_blocks[None, :] <= q_blocks[:, None])[None, None]
    gather = functools.partial(_all_gather_time, group=group)
    for i in range(model.num_layers):
        layer = getattr(model, f"layer_{i}")
        context = functools.partial(_halo, group=group, need=layer.conv.dw_kernel.shape[0] - 1)
        h = layer(h, mask, causal_conv=True, kv_gather=gather, conv_context=context)
    return model.output_proj(h)
