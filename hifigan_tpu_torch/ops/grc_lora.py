"""GRC-LoRA numerics: grouped residual conv with a shared low-rank path.

Counterpart of ``hifigan_tpu/ops/grc_lora.py``.  The grouped conv becomes a
dense block-diagonal kernel, the per-group shared LoRA update a dense
block-diagonal ``[C, C]`` matrix, and GroupNorm statistics are reduced
over time into ``[B, C]`` before they are summed per group.
"""

from __future__ import annotations

import torch


def lora_block_matrix(lora_a: torch.Tensor, lora_b: torch.Tensor, groups: int) -> torch.Tensor:
    """``lora_a [r, C/G]``, ``lora_b [C/G, r]`` → dense ``[C, C]``
    block-diagonal matrix with each block ``Aᵀ·Bᵀ``."""
    block = (lora_a.T @ lora_b.T).float()
    return torch.block_diag(*([block] * groups))


def blockdiag_conv_kernel(w: torch.Tensor, groups: int) -> torch.Tensor:
    """Scatter a grouped conv kernel ``[k, C/G, C]`` (WIO) into the
    equivalent dense ``[k, C, C]`` block-diagonal kernel."""
    k, cg, c = w.shape
    co_group = torch.arange(groups, device=w.device).repeat_interleave(c // groups)
    ci_group = torch.arange(groups, device=w.device).repeat_interleave(cg)
    keep = (ci_group[:, None] == co_group[None, :]).to(w.dtype)
    return w.repeat(1, groups, 1) * keep[None]


def group_stats(
    s1: torch.Tensor, s2: torch.Tensor, n: int, groups: int, eps: float = 1e-5
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and 1/std ``[B, C]`` from the per-channel fp32 sums
    Σx and Σx² ``[B, C]`` over ``n`` values per group.

    ``var = E[x²] − E[x]²``, exactly as the JAX package computes it."""
    B, C = s1.shape
    mean_g = s1.reshape(B, groups, C // groups).sum(-1) / n
    var_g = s2.reshape(B, groups, C // groups).sum(-1) / n - mean_g.square()
    inv_g = torch.rsqrt(var_g + eps)
    per = C // groups
    return mean_g.repeat_interleave(per, dim=1), inv_g.repeat_interleave(per, dim=1)


def group_norm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int, eps: float = 1e-5
) -> torch.Tensor:
    """GroupNorm over ``[B, T, C]`` with ``torch.nn.GroupNorm`` semantics,
    without leaving the channels-last layout."""
    B, T, C = x.shape
    xf = x.float()
    mean, inv = group_stats(xf.sum(1), xf.square().sum(1), T * (C // groups), groups, eps)
    y = (xf - mean[:, None, :]) * inv[:, None, :]
    return (y * gamma + beta).to(x.dtype)
