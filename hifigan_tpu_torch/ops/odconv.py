"""ODConv (omni-dimensional dynamic convolution) numerics.

Counterpart of ``hifigan_tpu/ops/odconv.py``: the K kernel banks are mixed
per sample by the kernel attention; the spatial, in-channel and
out-channel attentions scale the taps, the input and the output.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ODAttention(NamedTuple):
    """Per-sample omni-dimensional attention weights."""

    kernel: torch.Tensor  # [B, K]    softmax over kernel banks
    spatial: torch.Tensor  # [B, k]    softmax over filter taps
    in_channel: torch.Tensor  # [B, Cin]  sigmoid
    out_channel: torch.Tensor  # [B, Cout] sigmoid


def mix_kernels(kernels: torch.Tensor, kernel_attn: torch.Tensor, dtype=None) -> torch.Tensor:
    """``[K, ...] , [B, K] -> [B, ...]`` attention-weighted bank mix.

    Both operands are rounded to ``dtype`` and the products summed in
    fp32, then the result is rounded to ``dtype`` (the JAX einsum with
    ``preferred_element_type=float32``)."""
    dtype = dtype or kernels.dtype
    kflat = kernels.reshape(kernels.shape[0], -1).to(dtype).float()
    mixed = kernel_attn.to(dtype).float() @ kflat
    return mixed.reshape((kernel_attn.shape[0],) + tuple(kernels.shape[1:])).to(dtype)


def mix_bias(bias: torch.Tensor, kernel_attn: torch.Tensor) -> torch.Tensor:
    """``[K, Cout] , [B, K] -> [B, Cout]``: the bias rows mixed by the same
    kernel attention as the filters (not summed)."""
    return kernel_attn.float() @ bias.float()
