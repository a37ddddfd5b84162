"""FiLM (feature-wise linear modulation); counterpart of
``hifigan_tpu/ops/film.py``."""

from __future__ import annotations

import torch


def film(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``scale · x + shift`` with ``x [B, T, C]`` and ``scale, shift [B, C]``;
    the result keeps ``x``'s dtype."""
    return (scale[:, None, :] * x + shift[:, None, :]).to(x.dtype)
