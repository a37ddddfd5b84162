"""The unit-sequence vocoder (CodeHiFiGAN) with duration prediction.

Counterpart of ``hifigan_tpu/models/code_vocoder.py``: unit embedding →
``VariancePredictor`` log-durations → durations → frames expanded by them
→ optional f0 and speaker channels → HiFi-GAN V1.  Returns ``(wav, dur,
n_samples)``, so that a streaming caller can emit only the new
duration-aligned tail of the waveform.

Frames are expanded to a fixed maximum length (``U · max_duration_per_unit``)
with a gather over the duration cumsum and a validity mask, the JAX
package's formula: padded frames stay zero, and the waveform comes back
``max_frames · ratio`` samples long with its valid-sample count.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from hifigan_tpu_torch.models.generator import HiFiGANV1Generator
from hifigan_tpu_torch.models.layers import Dense, Embed, LayerNorm, _const, _normal
from hifigan_tpu_torch.ops import conv as conv_ops


class VariancePredictor(nn.Module):
    """conv → ReLU → LayerNorm, twice, → fp32 Dense to one scalar a unit."""

    def __init__(self, in_features: int, hidden: int = 256, kernel_size: int = 3, dtype=torch.float32, *,
                 gen: torch.Generator):
        super().__init__()
        self.kernel_size, self.dtype = kernel_size, dtype
        for i, cin in enumerate((in_features, hidden)):
            setattr(self, f"conv_{i}_kernel", _normal(gen, 0.02, kernel_size, cin, hidden))
            setattr(self, f"conv_{i}_bias", _const(0.0, hidden))
            self.add_module(f"ln_{i}", LayerNorm(hidden))
        self.proj = Dense(hidden, 1, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        for i in range(2):
            x = conv_ops.conv1d(x.to(dt), getattr(self, f"conv_{i}_kernel").to(dt), getattr(self, f"conv_{i}_bias"),
                                padding=(self.kernel_size - 1) // 2)
            x = getattr(self, f"ln_{i}")(torch.relu(x)).to(dt)
        return self.proj(x.float())[..., 0]


def expand_by_durations(frames: torch.Tensor, durations: torch.Tensor, max_len: int):
    """Static-shape ``repeat_interleave``: ``frames [B, U, D]``, ``durations
    [B, U]`` (ints ≥ 0) → (expanded ``[B, max_len, D]``, valid mask ``[B,
    max_len]``, total lengths ``[B]``).  Output frame t belongs to the unit
    ``Σ_u (cum[u] ≤ t)``, clipped to the last; frames past the total are 0."""
    cum = durations.cumsum(-1)
    total = cum[:, -1]
    t = torch.arange(max_len, device=frames.device)[None, :]
    idx = (cum[:, None, :] <= t[:, :, None]).sum(-1).clamp(0, frames.shape[1] - 1)
    expanded = torch.gather(frames, 1, idx[..., None].expand(-1, -1, frames.shape[-1]))
    mask = t < total[:, None]
    return expanded * mask[..., None].to(frames.dtype), mask, total


@dataclass(frozen=True)
class CodeVocoderConfig:
    """The JAX package's ``CodeVocoderConfig``.  ``speaker_dim > 0`` adds a
    speaker-embedding channel, ``f0`` a raw f0 channel, or with
    ``f0_quant_bins > 0`` an embedding of quantised f0 bins."""

    unit_vocab_size: int = 1000
    embed_dim: int = 128
    upsample_factors: Tuple[int, ...] = (8, 8, 2, 2)
    hidden_channels: int = 512
    max_duration_per_unit: int = 8
    speaker_dim: int = 0
    dur_prediction: bool = True
    f0: bool = False
    f0_quant_bins: int = 0

    @property
    def upsample_ratio(self) -> int:
        r = 1
        for f in self.upsample_factors:
            r *= f
        return r


class CodeVocoder(nn.Module):
    """``forward(units [B, U], speaker_emb?, durations?, f0?) → (wav [B, 1,
    U·max_duration_per_unit·ratio], durations [B, U], n_samples [B])``.

    The generator's input channels are fixed when the module is built: the
    embedding, the f0 channel(s) when ``config.f0``, and the speaker
    embedding when ``config.speaker_dim > 0``, which must then be passed."""

    def __init__(self, config: CodeVocoderConfig = CodeVocoderConfig(), dtype=torch.float32, *,
                 gen: torch.Generator):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.unit_embedding = Embed(cfg.unit_vocab_size, cfg.embed_dim, gen)
        if cfg.dur_prediction:
            self.duration_predictor = VariancePredictor(cfg.embed_dim, dtype=dtype, gen=gen)
        channels = cfg.embed_dim
        if cfg.f0:
            if cfg.f0_quant_bins > 0:
                self.f0_quant_embedding = Embed(cfg.f0_quant_bins, cfg.embed_dim, gen)
                channels += cfg.embed_dim
            else:
                channels += 1
        channels += cfg.speaker_dim
        self.generator = HiFiGANV1Generator(channels, cfg.hidden_channels, cfg.upsample_factors, dtype=dtype,
                                            gen=gen)

    def forward(self, units: torch.Tensor, speaker_emb: Optional[torch.Tensor] = None,
                durations: Optional[torch.Tensor] = None, f0: Optional[torch.Tensor] = None,
                return_log_dur: bool = False):
        """``durations``: teacher durations; the predictor still runs, and
        ``return_log_dur`` appends its log-durations to the result."""
        cfg = self.config
        emb = self.unit_embedding(units)
        log_dur = self.duration_predictor(emb) if cfg.dur_prediction else None
        if durations is None and log_dur is not None:
            durations = torch.round(torch.exp(log_dur) - 1).to(torch.int64).clamp(1, cfg.max_duration_per_unit)
        elif durations is None:
            durations = torch.ones(units.shape, dtype=torch.int64, device=units.device)
        max_frames = units.shape[1] * cfg.max_duration_per_unit
        frames, mask, total = expand_by_durations(emb, durations, max_frames)
        if cfg.f0:
            if f0 is None:
                raise ValueError("config.f0 is set: an f0 input is required")
            f0_feat = self.f0_quant_embedding(f0.long()) if cfg.f0_quant_bins > 0 else f0[..., None]
            t_f0 = f0_feat.shape[1]
            if t_f0 != max_frames:
                if max_frames % t_f0:
                    raise ValueError(f"f0 length {t_f0} must divide the frame budget {max_frames}")
                f0_feat = f0_feat.repeat_interleave(max_frames // t_f0, dim=1)
            frames = torch.cat([frames, f0_feat.to(frames.dtype) * mask[..., None].to(frames.dtype)], dim=-1)
        if cfg.speaker_dim:
            if speaker_emb is None:
                raise ValueError("config.speaker_dim is set: a speaker embedding is required")
            spk = speaker_emb[:, None, :].expand(*frames.shape[:2], speaker_emb.shape[-1])
            frames = torch.cat([frames, spk.to(frames.dtype)], dim=-1)
        wav = self.generator(frames.transpose(1, 2))
        n_samples = total * cfg.upsample_ratio
        sample_mask = torch.arange(wav.shape[-1], device=wav.device)[None] < n_samples[:, None]
        wav = wav * sample_mask[:, None, :]
        if return_log_dur:
            return wav, durations, n_samples, log_dur
        return wav, durations, n_samples
