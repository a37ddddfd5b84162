"""STFT and mel-spectrogram ops, in fp32 (cuFFT on the card).

Counterpart of ``hifigan_tpu/ops/stft.py``: reflect-padded framing, the
periodic Hann window, ``|rfft|`` with 1e-9 inside the square root (so
the gradient is finite at a zero bin; ``torch.stft(...).abs()`` is another
function there), the Slaney mel filterbank (the port's own numpy copy) and
the multi-resolution STFT loss.  Shapes: audio ``[B, T]``, spectrograms
``[B, frames, bins]``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class MelConfig:
    """Audio analysis: 16 kHz, n_fft 1024, hop 256, window 1024, 80 mels
    up to 8 kHz, centred frames, log floor 1e-5 (the JAX package's)."""

    sample_rate: int = 16_000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float | None = 8000.0
    center: bool = True
    log_eps: float = 1e-5


def _hann(win_length: int) -> np.ndarray:
    """Periodic Hann window (``torch.hann_window``'s and librosa's default)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


@functools.cache
def _window(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    """The Hann window of ``win_length`` centred in ``n_fft`` zeros."""
    lo = (n_fft - win_length) // 2
    window = np.pad(_hann(win_length), (lo, n_fft - win_length - lo))
    return torch.from_numpy(window).to(device)


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``numpy.pad(x, pad, mode="reflect")`` on the last dim of ``[B, T]``,
    also where ``pad >= T`` (the signal reflected again at each new edge).
    Built from slices and flips, so its backward adds no atomics."""
    while pad > 0:
        n = min(pad, x.shape[-1] - 1)
        x = torch.cat([x[:, 1:n + 1].flip(-1), x, x[:, -n - 1:-1].flip(-1)], dim=-1)
        pad -= n
    return x


def frame_signal(x: torch.Tensor, n_fft: int, hop: int, *, center: bool = True) -> torch.Tensor:
    """Slice ``[B, T]`` audio into ``[B, 1 + (T' - n_fft) // hop, n_fft]``
    frames, ``T'`` the length after reflect padding by ``n_fft // 2`` on
    each side when ``center``."""
    if center:
        x = _reflect_pad(x, n_fft // 2)
    return x.unfold(-1, n_fft, hop)


def stft_magnitude(
    x: torch.Tensor,
    n_fft: int,
    hop: int,
    win_length: int | None = None,
    *,
    center: bool = True,
) -> torch.Tensor:
    """``[B, T] → [B, frames, n_fft // 2 + 1]``: ``sqrt(re² + im² + 1e-9)``
    of the windowed frames' rfft, in fp32."""
    frames = frame_signal(x.float(), n_fft, hop, center=center)
    spec = torch.fft.rfft(frames * _window(n_fft, win_length or n_fft, x.device), n=n_fft, dim=-1)
    return torch.sqrt(spec.real.square() + spec.imag.square() + 1e-9)


def _hz_to_mel(f) -> np.ndarray:
    """Slaney mel scale (librosa's default)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank ``[n_fft // 2 + 1,
    n_mels]`` (librosa ``filters.mel``, transposed for a right matmul)."""
    fmax = fmax or sample_rate / 2
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    weights = np.zeros((n_mels, n_freqs))
    for i in range(n_mels):
        weights[i] = np.maximum(0, np.minimum(-ramps[i] / fdiff[i], ramps[i + 2] / fdiff[i + 1]))
    weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.T.astype(np.float32)


@functools.cache
def _filterbank(cfg: MelConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)).to(device)


def mel_spectrogram(x: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """``[B, T] → [B, frames, n_mels]``, the magnitude (power 1) mel spectrogram."""
    mag = stft_magnitude(x, cfg.n_fft, cfg.hop_length, cfg.win_length, center=cfg.center)
    return mag @ _filterbank(cfg, x.device)


def log_mel_spectrogram(x: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    return torch.log(mel_spectrogram(x, cfg).clamp_min(cfg.log_eps))


def spectral_convergence(mag_fake: torch.Tensor, mag_real: torch.Tensor) -> torch.Tensor:
    num = torch.linalg.norm(mag_real - mag_fake, dim=(-2, -1))
    den = torch.linalg.norm(mag_real, dim=(-2, -1)) + 1e-9
    return (num / den).mean()


def log_stft_magnitude_loss(mag_fake: torch.Tensor, mag_real: torch.Tensor) -> torch.Tensor:
    return (torch.log(mag_real + 1e-7) - torch.log(mag_fake + 1e-7)).abs().mean()


def multi_resolution_stft_loss(
    fake: torch.Tensor,
    real: torch.Tensor,
    resolutions: tuple[tuple[int, int, int], ...] = ((1024, 256, 1024), (2048, 512, 2048), (512, 128, 512)),
) -> torch.Tensor:
    """Mean over ``(n_fft, hop, win)`` of spectral convergence + log-magnitude
    L1, on ``fake, real [B, T]``."""
    loss = 0.0
    for n_fft, hop, win in resolutions:
        mf = stft_magnitude(fake, n_fft, hop, win)
        mr = stft_magnitude(real, n_fft, hop, win)
        loss = loss + spectral_convergence(mf, mr) + log_stft_magnitude_loss(mf, mr)
    return loss / len(resolutions)
