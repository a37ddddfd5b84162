"""The MPD / MSD GAN discriminators.

Counterpart of ``hifigan_tpu/models/discriminators.py`` (its unfolded
path; ``folded=True`` packs time steps into the TPU's 128 lanes and has no
use here):

* **MPD** (periods 2, 3, 5, 7, 11): the waveform ``[B, T]``, zero-padded on
  the right to a multiple of ``p``, is split into ``p`` *contiguous* chunks,
  ``[B, p, T/p, 1]`` channels-last, and runs a 5-layer 3×3 conv2d stack
  1→32→64→128→256→1 with LeakyReLU(0.1).
* **MSD** (scales 1, 2, 4): average pooling by the scale, then a 5-layer
  k=15 conv1d stack 1→32→64→128→256→1.

Each head returns its final output and the LeakyReLU maps after its first
four layers (for deep feature matching).  Parameters are fp32 and carry
the JAX names and layouts (``mpd.period_2.conv_0_kernel`` ``[3, 3, 1,
32]``, ``msd.scale_1.conv_0_kernel`` ``[15, 1, 32]``), so
:func:`hifigan_tpu_torch.weights.load_jax_params` carries them across;
``dtype`` is the compute dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hifigan_tpu_torch.models.layers import _const, _normal
from hifigan_tpu_torch.ops import conv as conv_ops

_STACK_CHANNELS = (32, 64, 128, 256, 1)


class _ConvStack(nn.Module):
    """The five conv layers' parameters, ``conv_{i}_kernel [*taps, Cin,
    Cout]`` (normal 0.01) and ``conv_{i}_bias`` (zeros)."""

    def __init__(self, taps: tuple[int, ...], leaky_slope: float, dtype, gen: torch.Generator):
        super().__init__()
        self.leaky_slope, self.dtype = leaky_slope, dtype
        ch_in = 1
        for i, ch_out in enumerate(_STACK_CHANNELS):
            setattr(self, f"conv_{i}_kernel", _normal(gen, 0.01, *taps, ch_in, ch_out))
            setattr(self, f"conv_{i}_bias", _const(0.0, ch_out))
            ch_in = ch_out

    def run(self, x: torch.Tensor, conv) -> tuple[torch.Tensor, list[torch.Tensor]]:
        feats = []
        for i in range(len(_STACK_CHANNELS)):
            x = conv(x, getattr(self, f"conv_{i}_kernel").to(self.dtype), getattr(self, f"conv_{i}_bias"))
            if i < len(_STACK_CHANNELS) - 1:
                x = conv_ops.leaky_relu(x, self.leaky_slope)
                feats.append(x)
        return x, feats


class PeriodDiscriminator(_ConvStack):
    """One period head: ``forward(wav [B, T]) → (out [B, p, ⌈T/p⌉, 1], feats)``."""

    def __init__(self, period: int, leaky_slope: float = 0.1, dtype=torch.float32, *, gen: torch.Generator):
        super().__init__((3, 3), leaky_slope, dtype, gen)
        self.period = period

    def forward(self, wav: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        B, T = wav.shape
        p = self.period
        if T % p:
            wav = F.pad(wav, (0, p - T % p))
        x = wav.reshape(B, p, -1, 1).to(self.dtype)
        return self.run(x, lambda x, w, b: conv_ops.conv2d(x, w, b, padding=1))


class ScaleDiscriminator(_ConvStack):
    """One scale head: ``forward(wav [B, T]) → (out [B, T/scale, 1], feats)``."""

    def __init__(self, scale: int, leaky_slope: float = 0.1, dtype=torch.float32, *, gen: torch.Generator):
        super().__init__((15,), leaky_slope, dtype, gen)
        self.scale = scale

    def forward(self, wav: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        x = wav[:, :, None].to(self.dtype)
        if self.scale > 1:
            x = conv_ops.avg_pool1d(x, self.scale, self.scale)
        return self.run(x, lambda x, w, b: conv_ops.conv1d(x, w, b, padding=7))


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11), dtype=torch.float32, *, gen: torch.Generator):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module(f"period_{p}", PeriodDiscriminator(p, dtype=dtype, gen=gen))

    def forward(self, wav):
        heads = [getattr(self, f"period_{p}")(wav) for p in self.periods]
        return [o for o, _ in heads], [f for _, f in heads]


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, scales: Sequence[int] = (1, 2, 4), dtype=torch.float32, *, gen: torch.Generator):
        super().__init__()
        self.scales = tuple(scales)
        for s in self.scales:
            self.add_module(f"scale_{s}", ScaleDiscriminator(s, dtype=dtype, gen=gen))

    def forward(self, wav):
        heads = [getattr(self, f"scale_{s}")(wav) for s in self.scales]
        return [o for o, _ in heads], [f for _, f in heads]


class Discriminators(nn.Module):
    """The MPD + MSD ensemble: ``forward(wav [B, 1, T] or [B, T])`` → dict
    of ``mpd_outputs``, ``mpd_features``, ``msd_outputs`` and
    ``msd_features``, one entry per head."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11), scales: Sequence[int] = (1, 2, 4),
                 dtype=torch.float32, *, gen: torch.Generator):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator(periods, dtype, gen=gen)
        self.msd = MultiScaleDiscriminator(scales, dtype, gen=gen)

    def forward(self, wav: torch.Tensor) -> dict:
        if wav.dim() == 3:
            wav = wav[:, 0, :] if wav.shape[1] == 1 else wav[:, :, 0]
        mpd_out, mpd_feat = self.mpd(wav)
        msd_out, msd_feat = self.msd(wav)
        return {"mpd_outputs": mpd_out, "mpd_features": mpd_feat,
                "msd_outputs": msd_out, "msd_features": msd_feat}
