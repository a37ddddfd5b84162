"""Building blocks with flax's semantics: ``Dense``, ``DenseGeneral``,
``Embed``, ``LayerNorm``, sinusoidal positions, multi-head attention, the
post-norm transformer encoder and decoder layers and their masks.

Counterpart of ``hifigan_tpu/models/layers.py`` and of the flax layers it
uses.  Parameters are fp32 and keep flax's names and layouts: Dense kernels
``[in, out]``, attention q/k/v kernels ``[d, heads, head_dim]``, its output
kernel ``[heads, head_dim, d]``, LayerNorm ``scale`` and ``bias``.  ``dtype``
is the compute dtype, as flax's ``dtype=`` beside ``param_dtype=float32``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def _normal(gen: torch.Generator, std: float, *shape: int) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=gen) * std)


def _const(value: float, *shape: int) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, float(value)))


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral``: contracts the last ``len(in_shape)`` dims of
    the input with ``kernel [*in_shape, *out_shape]`` and adds ``bias
    [*out_shape]``.  Input, kernel and bias are cast to ``dtype`` first, as
    flax does.  ``std`` defaults to lecun-normal's scale, 1/sqrt(fan_in)."""

    def __init__(self, in_shape, out_shape, gen: torch.Generator, *, std: float | None = None,
                 dtype=torch.float32):
        super().__init__()
        self.n_in, self.fan_in = len(in_shape), math.prod(in_shape)
        self.out_shape, self.dtype = tuple(out_shape), dtype
        self.kernel = _normal(gen, self.fan_in ** -0.5 if std is None else std, *in_shape, *out_shape)
        self.bias = _const(0.0, *out_shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        lead = x.shape[: x.dim() - self.n_in]
        y = x.reshape(*lead, self.fan_in).to(dt) @ self.kernel.reshape(self.fan_in, -1).to(dt)
        return y.reshape(*lead, *self.out_shape) + self.bias.to(dt)


class Dense(DenseGeneral):
    """flax ``nn.Dense``: ``x @ kernel + bias``, kernel ``[in, out]``."""

    def __init__(self, in_features: int, out_features: int, gen: torch.Generator, *,
                 std: float | None = None, dtype=torch.float32):
        super().__init__((in_features,), (out_features,), gen, std=std, dtype=dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: ``embedding [num, features]`` drawn as flax's
    default, N(0, 1/features); ids index its rows."""

    def __init__(self, num_embeddings: int, features: int, gen: torch.Generator):
        super().__init__()
        self.embedding = _normal(gen, features ** -0.5, num_embeddings, features)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last dim, as the JAX package uses it
    (``dtype=float32`` or none): statistics in fp32 by flax's fast variance,
    E[x²] − E[x]² clipped at 0, epsilon 1e-6 (torch's default is 1e-5).
    Returns fp32; each caller casts as the JAX code does."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = _const(1.0, features)
        self.bias = _const(0.0, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = (x.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + 1e-6) * self.scale) + self.bias


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """Standard sinusoidal positional encoding table ``[length, dim]``."""
    pos = np.arange(length)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-math.log(10000.0) / dim))
    table = np.zeros((length, dim), dtype=np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return table


class MultiHeadAttention(nn.Module):
    """Multi-head attention, written as the two products of the JAX code.

    ``mask`` broadcasts to ``[B, heads, Tq, Tk]``, True = attend.  Scores
    and softmax are fp32; masked scores are float32's most negative value
    (not -inf, so a fully masked row attends uniformly, as in JAX); the
    probabilities are cast to ``dtype`` before the second product.  The
    forward is a profiler range named ``attention``."""

    def __init__(self, features: int, num_heads: int, dtype=torch.float32, *, gen: torch.Generator):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"features {features} is not a multiple of num_heads {num_heads}")
        self.head_dim, self.dtype = features // num_heads, dtype
        heads = (num_heads, self.head_dim)
        self.q = DenseGeneral((features,), heads, gen, dtype=dtype)
        self.k = DenseGeneral((features,), heads, gen, dtype=dtype)
        self.v = DenseGeneral((features,), heads, gen, dtype=dtype)
        self.out = DenseGeneral(heads, (features,), gen, dtype=dtype)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        with torch.profiler.record_function("attention"):
            q, k, v = self.q(q_in), self.k(kv_in), self.v(kv_in)  # [B, T, heads, head_dim]
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(self.head_dim)
            if mask is not None:
                scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
            probs = torch.softmax(scores, dim=-1).to(self.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(self.dtype)
            return self.out(out)


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer: ``x = LN(x + MHA(x))``, ``x = LN(x +
    FFN(x))``, ReLU FFN, each LayerNorm's output cast to ``dtype``."""

    def __init__(self, features: int, num_heads: int, ffn_dim: int, dtype=torch.float32, *,
                 gen: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.mha = MultiHeadAttention(features, num_heads, dtype, gen=gen)
        self.norm1 = LayerNorm(features)
        self.ffn1 = Dense(features, ffn_dim, gen, dtype=dtype)
        self.ffn2 = Dense(ffn_dim, features, gen, dtype=dtype)
        self.norm2 = LayerNorm(features)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        x = self.norm1(x + self.mha(x, x, mask)).to(self.dtype)
        f = self.ffn2(torch.relu(self.ffn1(x)))
        return self.norm2(x + f).to(self.dtype)


class TransformerDecoderLayer(nn.Module):
    """Post-norm decoder layer: ``x = LN(x + MHA(x, x))`` under the
    self-attention mask, ``x = LN(x + MHA(x, memory))`` under the cross
    mask, ``x = LN(x + FFN(x))``; each LayerNorm's output cast to
    ``dtype``."""

    def __init__(self, features: int, num_heads: int, ffn_dim: int, dtype=torch.float32, *,
                 gen: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.self_mha = MultiHeadAttention(features, num_heads, dtype, gen=gen)
        self.norm1 = LayerNorm(features)
        self.cross_mha = MultiHeadAttention(features, num_heads, dtype, gen=gen)
        self.norm2 = LayerNorm(features)
        self.ffn1 = Dense(features, ffn_dim, gen, dtype=dtype)
        self.ffn2 = Dense(ffn_dim, features, gen, dtype=dtype)
        self.norm3 = LayerNorm(features)

    def forward(self, x: torch.Tensor, memory: torch.Tensor, self_mask: torch.Tensor | None = None,
                cross_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = self.norm1(x + self.self_mha(x, x, self_mask)).to(self.dtype)
        x = self.norm2(x + self.cross_mha(x, memory, cross_mask)).to(self.dtype)
        f = self.ffn2(torch.relu(self.ffn1(x)))
        return self.norm3(x + f).to(self.dtype)


def causal_mask(length: int, device=None) -> torch.Tensor:
    """``[1, 1, T, T]`` lower-triangular attention mask (True = attend)."""
    return torch.ones((length, length), dtype=torch.bool, device=device).tril()[None, None]


def chunk_mask(length: int, chunk_size: int, device=None) -> torch.Tensor:
    """``[1, 1, T, T]`` chunked-attention mask: position i attends to every
    position in its own chunk and in the chunks before it."""
    blocks = torch.arange(length, device=device) // chunk_size
    return (blocks[None, :] <= blocks[:, None])[None, None]
