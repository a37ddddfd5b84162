"""Standalone building blocks: ``StandaloneGRCBlock`` and ``ParallelMRFBlock``.

Counterpart of ``hifigan_tpu/models/blocks.py``.  These are the standalone
variants, distinct from the generator's own GRC-LoRA blocks:

* :class:`StandaloneGRCBlock`: grouped conv (groups = min(in, out, 4)) ⊕
  the scaled whole-channel LoRA ``x·(A·B)`` → 1×1 projection → GroupNorm →
  SiLU → + residual (through a 1×1 projection when the channel count
  changes);
* :class:`ParallelMRFBlock`: GRC branches at dilations (1, 3, 5) over a
  channel split, concatenated → 1×1 fusion → GroupNorm → dropout →
  + residual.  The flagship generator runs its GRC blocks in sequence
  instead.

Activations ``[B, T, C]``; parameters fp32 under the JAX package's names
and layouts, so ``load_jax_params`` fills them from a flax tree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hifigan_tpu_torch.models.layers import _const, _normal
from hifigan_tpu_torch.ops import conv as conv_ops
from hifigan_tpu_torch.ops import grc_lora as lora_ops


class StandaloneGRCBlock(nn.Module):
    """Grouped conv + whole-channel LoRA + 1×1 projection + GroupNorm + SiLU
    + (projected) residual."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, dilation: int = 1,
                 lora_rank: int = 8, dtype=torch.float32, *, gen: torch.Generator):
        super().__init__()
        cin, cout = in_channels, out_channels
        self.groups = min(cin, cout, 4)
        self.kernel_size, self.dilation, self.dtype = kernel_size, dilation, dtype
        self.norm_groups = min(8, cout // 4) if cout >= 4 else 1
        self.grouped_kernel = _normal(gen, 0.02, kernel_size, cin // self.groups, cout)
        self.grouped_bias = _const(0.0, cout)
        self.lora_A = _normal(gen, 0.02, cin, lora_rank)
        self.lora_B = _const(0.0, lora_rank, cout)
        self.lora_scaling = _const(1.0, 1)
        self.proj_kernel = _normal(gen, 0.02, 1, cout, cout)
        self.proj_bias = _const(0.0, cout)
        self.norm_gamma = _const(1.0, cout)
        self.norm_beta = _const(0.0, cout)
        self.residual_proj = _normal(gen, 0.02, 1, cin, cout) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        pad = (self.kernel_size - 1) * self.dilation // 2
        h = conv_ops.conv1d(x, self.grouped_kernel.to(dt), self.grouped_bias, padding=pad,
                            dilation=self.dilation, groups=self.groups)
        lora = x.float() @ (self.lora_A @ self.lora_B)
        h = (h + self.lora_scaling * lora).to(dt)
        h = conv_ops.conv1d(h, self.proj_kernel.to(dt), self.proj_bias)
        h = lora_ops.group_norm(h, self.norm_gamma, self.norm_beta, self.norm_groups)
        h = F.silu(h.float()).to(dt)
        residual = x if self.residual_proj is None else conv_ops.conv1d(x, self.residual_proj.to(dt))
        return h + residual


class ParallelMRFBlock(nn.Module):
    """Channel-split parallel multi-receptive-field block.  ``forward(x,
    deterministic=False, gen=g)`` applies dropout at ``dropout_rate`` with
    draws from the ``torch.Generator`` ``g`` on ``x``'s device (flax's
    inverted dropout: kept values scaled by ``1 / (1 − rate)``)."""

    def __init__(self, channels: int, dilations: Tuple[int, ...] = (1, 3, 5), kernel_size: int = 3,
                 dropout_rate: float = 0.1, dtype=torch.float32, *, gen: torch.Generator):
        super().__init__()
        c, n = channels, len(dilations)
        self.channels, self.dilations, self.dropout_rate, self.dtype = c, tuple(dilations), dropout_rate, dtype
        self.split = c // n
        for i, d in enumerate(dilations):
            cin = self.split if i < n - 1 else c - self.split * (n - 1)
            self.add_module(f"grc_d{d}", StandaloneGRCBlock(cin, cin, kernel_size, d, dtype=dtype, gen=gen))
        self.fusion_kernel = _normal(gen, 0.02, 1, c, c)
        self.fusion_bias = _const(0.0, c)
        self.norm_gamma = _const(1.0, c)
        self.norm_beta = _const(0.0, c)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        dt, c, s = self.dtype, self.channels, self.split
        x = x.to(dt)
        n = len(self.dilations)
        outs = []
        for i, d in enumerate(self.dilations):
            hi = (i + 1) * s if i < n - 1 else c
            outs.append(getattr(self, f"grc_d{d}")(x[..., i * s: hi]))
        h = conv_ops.conv1d(torch.cat(outs, dim=-1), self.fusion_kernel.to(dt), self.fusion_bias)
        h = lora_ops.group_norm(h, self.norm_gamma, self.norm_beta, min(4, c))
        if not deterministic and self.dropout_rate > 0:
            if gen is None:
                raise ValueError("dropout needs a torch.Generator: pass gen= with deterministic=False")
            keep_prob = 1.0 - self.dropout_rate
            keep = torch.rand(h.shape, generator=gen, device=h.device) < keep_prob
            h = torch.where(keep, h / keep_prob, torch.zeros((), dtype=h.dtype, device=h.device))
        return h + x
