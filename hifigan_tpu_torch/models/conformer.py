"""The chunked-attention Conformer encoder for streaming speech.

Counterpart of ``hifigan_tpu/models/conformer.py``: input projection →
sinusoidal positions → ``num_layers`` Conformer layers (attention, FFN and
the conv module, each a post-norm residual) → output projection.  The conv
module is pointwise (×2) → GLU → depthwise k = 15 → LayerNorm → ReLU →
pointwise.  ``chunked`` applies the chunked-causal attention mask and pads
the depthwise conv causally, ``(k − 1, 0)``, so that a prefix's output does
not depend on what follows it.
"""

from __future__ import annotations

import torch
from torch import nn

from hifigan_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    MultiHeadAttention,
    _const,
    _normal,
    chunk_mask,
    sinusoidal_positions,
)
from hifigan_tpu_torch.ops import conv as conv_ops


class ConformerConvModule(nn.Module):
    """pw1 → GLU → depthwise conv → LayerNorm (fp32) → ReLU → pw2."""

    def __init__(self, hidden_dim: int, depthwise_kernel: int = 15, dtype=torch.float32, *,
                 gen: torch.Generator):
        super().__init__()
        d = hidden_dim
        self.dtype = dtype
        self.pw1 = Dense(d, 2 * d, gen, dtype=dtype)
        self.dw_kernel = _normal(gen, 0.02, depthwise_kernel, 1, d)
        self.dw_bias = _const(0.0, d)
        self.norm = LayerNorm(d)
        self.pw2 = Dense(d, d, gen, dtype=dtype)

    def forward(self, x: torch.Tensor, causal: bool = False, context=None) -> torch.Tensor:
        """``causal``: the depthwise conv padded ``(k − 1, 0)``, else
        symmetrically.  ``context(h)``, with ``causal``, returns the ``k − 1``
        frames of the GLU output that precede ``h`` (the sequence-parallel
        encoder's halo), which take the place of the left padding."""
        a, b = self.pw1(x).chunk(2, dim=-1)
        h = a * torch.sigmoid(b)
        k = self.dw_kernel.shape[0]
        pad = (k - 1, 0) if causal else ((k - 1) // 2, (k - 1) // 2)
        if causal and context is not None:
            h, pad = torch.cat([context(h), h], dim=1), (0, 0)
        h = conv_ops.conv1d(h, self.dw_kernel.to(self.dtype), self.dw_bias, padding=pad, groups=h.shape[-1])
        h = torch.relu(self.norm(h).to(self.dtype))
        return self.pw2(h)


class ConformerLayer(nn.Module):
    """Attention → FFN (×4, ReLU) → conv module, each a post-norm residual."""

    def __init__(self, hidden_dim: int, num_heads: int, dtype=torch.float32, *, gen: torch.Generator):
        super().__init__()
        d = hidden_dim
        self.dtype = dtype
        self.mha = MultiHeadAttention(d, num_heads, dtype, gen=gen)
        self.attn_norm = LayerNorm(d)
        self.ffn1 = Dense(d, 4 * d, gen, dtype=dtype)
        self.ffn2 = Dense(4 * d, d, gen, dtype=dtype)
        self.ffn_norm = LayerNorm(d)
        self.conv = ConformerConvModule(d, dtype=dtype, gen=gen)
        self.conv_norm = LayerNorm(d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None, causal_conv: bool = False,
                kv_gather=None, conv_context=None) -> torch.Tensor:
        """``kv_gather`` goes to the attention, ``conv_context`` to the conv
        module (:func:`hifigan_tpu_torch.parallel.conformer_forward_seq_sharded`)."""
        x = self.attn_norm(x + self.mha(x, x, mask, kv_gather)).to(self.dtype)
        x = self.ffn_norm(x + self.ffn2(torch.relu(self.ffn1(x)))).to(self.dtype)
        return self.conv_norm(x + self.conv(x, causal_conv, conv_context)).to(self.dtype)


class ChunkedConformer(nn.Module):
    """``forward(x [B, T, input_dim], chunked=False, attn_mask=None) →
    [B, T, hidden_dim]``.  ``chunked``: each position attends within its
    chunk and all earlier chunks, and the depthwise convs are causal; else
    full attention (offline)."""

    def __init__(self, input_dim: int = 80, hidden_dim: int = 512, num_layers: int = 12, num_heads: int = 8,
                 chunk_size: int = 32, max_len: int = 8192, dtype=torch.float32, *, gen: torch.Generator):
        super().__init__()
        self.chunk_size, self.dtype = chunk_size, dtype
        self.input_proj = Dense(input_dim, hidden_dim, gen, dtype=dtype)
        self.register_buffer("positions", torch.from_numpy(sinusoidal_positions(max_len, hidden_dim)),
                             persistent=False)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", ConformerLayer(hidden_dim, num_heads, dtype=dtype, gen=gen))
        self.output_proj = Dense(hidden_dim, hidden_dim, gen, dtype=dtype)

    def forward(self, x: torch.Tensor, *, chunked: bool = False, attn_mask: torch.Tensor | None = None):
        T = x.shape[1]
        h = self.input_proj(x.to(self.dtype)) + self.positions[:T].to(self.dtype)
        mask = attn_mask
        if mask is None and chunked:
            mask = chunk_mask(T, self.chunk_size, x.device)
        for i in range(self.num_layers):
            h = getattr(self, f"layer_{i}")(h, mask, causal_conv=chunked)
        return self.output_proj(h)
