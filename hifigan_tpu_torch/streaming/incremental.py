"""Incremental (KV-cached) decoding of the simultaneous text decoder.

Counterpart of ``hifigan_tpu/streaming/incremental.py``, over the port's
``SimultaneousTextDecoder`` module:

* the self-attention K/V of every layer live in one fp32 buffer each,
  ``[n_layers, B, max_len, heads, head_dim]``, with a write index kept on
  the host as a Python ``int`` (no device read to slice by it);
* cross-attention K/V are projected once per policy call
  (:func:`cross_kv`): the encoder memory changes as audio arrives;
* :func:`prefill` runs a whole known prefix in one causal pass and writes
  its K/V, :func:`decode_step` runs one token against the cache;
* retraction lowers the index (:func:`with_index`); the rows past it are
  overwritten by the next steps and never attended to.

Writes go into the buffers in place, so a cache returned by
:func:`decode_step` or :func:`with_index` shares storage with the one
given.  The arithmetic is the JAX module's: fp32 products, softmax in fp32,
LayerNorm with the two-pass variance and epsilon 1e-6.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from hifigan_tpu_torch.models.streamspeech import SimultaneousTextDecoder


@dataclass
class DecoderCache:
    """Self-attention K/V ``[n_layers, B, max_len, heads, head_dim]`` and
    ``index``, the number of positions written (the next write slot)."""

    k: torch.Tensor
    v: torch.Tensor
    index: int = 0

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


@dataclass(frozen=True)
class DecoderSpec:
    """The decoder's sizes, for :func:`init_cache`."""

    num_layers: int
    num_heads: int
    hidden_dim: int
    vocab_size: int

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @classmethod
    def of(cls, decoder: SimultaneousTextDecoder) -> "DecoderSpec":
        return cls(decoder.num_layers, decoder.num_heads, decoder.hidden_dim,
                   decoder.output_proj.kernel.shape[1])


def _layer_norm(ln, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * ln.scale + ln.bias


def _attend(q, k, v, mask, out) -> torch.Tensor:
    """q ``[B, Tq, H, hd]``, k/v ``[B, Tk, H, hd]`` → ``out``'s ``[B, Tq, D]``."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    return out(torch.einsum("bhqk,bkhd->bqhd", probs, v))


def _layer(lp, x, self_k, self_v, self_mask, ck, cv, cross_mask) -> torch.Tensor:
    x = _layer_norm(lp.norm1, x + _attend(lp.self_mha.q(x), self_k, self_v, self_mask, lp.self_mha.out))
    x = _layer_norm(lp.norm2, x + _attend(lp.cross_mha.q(x), ck, cv, cross_mask, lp.cross_mha.out))
    f = lp.ffn2(torch.relu(lp.ffn1(x)))
    return _layer_norm(lp.norm3, x + f)


def cross_kv(decoder: SimultaneousTextDecoder, memory: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Encoder memory ``[B, S, D]`` → each layer's cross K/V, ``[n_layers,
    B, S, heads, head_dim]`` each."""
    memory = memory.float()
    layers = [decoder.layer(i).cross_mha for i in range(decoder.num_layers)]
    return torch.stack([m.k(memory) for m in layers]), torch.stack([m.v(memory) for m in layers])


def init_cache(spec: DecoderSpec, batch: int, max_len: int, device=None) -> DecoderCache:
    shape = (spec.num_layers, batch, max_len, spec.num_heads, spec.head_dim)
    return DecoderCache(torch.zeros(shape, device=device), torch.zeros(shape, device=device), 0)


def _embed(decoder: SimultaneousTextDecoder, tokens: torch.Tensor, start: int) -> torch.Tensor:
    emb = decoder.token_embedding(tokens) * math.sqrt(decoder.hidden_dim)
    return (emb + decoder.positions[start: start + tokens.shape[1]]).float()


def prefill(decoder: SimultaneousTextDecoder, ckv, tokens: torch.Tensor, cache: DecoderCache,
            cross_mask: torch.Tensor | None = None) -> tuple[torch.Tensor, DecoderCache]:
    """Causal pass over ``tokens [B, L]`` (L ≤ ``cache.max_len``): writes
    the K/V of positions 0..L−1 into ``cache`` and returns the logits
    ``[B, L, vocab]`` of every position.  The index is left as it was: the
    caller sets the number of valid positions with :func:`with_index`."""
    L = tokens.shape[1]
    x = _embed(decoder, tokens, 0)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()[None, None]
    ck, cv = ckv
    for i in range(decoder.num_layers):
        lp = decoder.layer(i)
        k, v = lp.self_mha.k(x), lp.self_mha.v(x)
        cache.k[i, :, :L] = k
        cache.v[i, :, :L] = v
        x = _layer(lp, x, k, v, causal, ck[i], cv[i], cross_mask)
    return decoder.output_proj(x), cache


def decode_step(decoder: SimultaneousTextDecoder, ckv, cache: DecoderCache, token: torch.Tensor,
                cross_mask: torch.Tensor | None = None, return_features: bool = False):
    """One token ``[B]`` at position ``cache.index``: writes its K/V there,
    attends to positions 0..index, and returns the next-token logits ``[B,
    vocab]`` and the cache advanced by one (plus the pre-projection
    features ``[B, D]`` when ``return_features``)."""
    idx = cache.index
    x = _embed(decoder, token[:, None], idx)
    ck, cv = ckv
    for i in range(decoder.num_layers):
        lp = decoder.layer(i)
        cache.k[i, :, idx] = lp.self_mha.k(x)[:, 0]
        cache.v[i, :, idx] = lp.self_mha.v(x)[:, 0]
        x = _layer(lp, x, cache.k[i, :, :idx + 1], cache.v[i, :, :idx + 1], None, ck[i], cv[i], cross_mask)
    logits = decoder.output_proj(x)[:, 0]
    cache = replace(cache, index=idx + 1)
    return (logits, cache, x[:, 0]) if return_features else (logits, cache)


def with_index(cache: DecoderCache, index: int) -> DecoderCache:
    """The cache with its write index set (retraction lowers it)."""
    return replace(cache, index=int(index))


def gather_beams(cache: DecoderCache, parent: torch.Tensor) -> DecoderCache:
    """Reorder the batch (beam) axis by ``parent`` (a copy)."""
    return replace(cache, k=cache.k[:, parent], v=cache.v[:, parent])
