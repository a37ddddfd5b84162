"""Incremental log-mel filterbank features for streaming input.

Counterpart of ``hifigan_tpu/streaming/features.py``: 80 mels, 25 ms Hann
window, 10 ms shift, ``rfft`` at the next power of two (512 for 400
samples), power through the Slaney filterbank from 20 Hz to half the rate,
``log(max(·, 1e-10))``; linear resampling on the host, and per-utterance
(or global) CMVN.  The frames are computed on ``device``, in fp32; the
frame count is padded up to one of ``BUCKETS`` so a stream reuses a few
shapes, which changes no frame.
"""

from __future__ import annotations

import functools
import wave
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from hifigan_tpu_torch.ops.stft import _hann, mel_filterbank


@dataclass(frozen=True)
class FbankConfig:
    sample_rate: int = 16_000
    shift_ms: int = 10
    window_ms: int = 25
    n_mels: int = 80
    cmvn: str = "utterance"  # "utterance" | "global" | "none"
    global_mean: Optional[tuple] = None
    global_std: Optional[tuple] = None

    @property
    def hop(self) -> int:
        return self.sample_rate * self.shift_ms // 1000

    @property
    def win(self) -> int:
        return self.sample_rate * self.window_ms // 1000

    @property
    def n_fft(self) -> int:
        return int(2 ** np.ceil(np.log2(self.win)))


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """(samples as fp32 in [-1, 1), sample rate) of a mono 16- or 32-bit
    PCM WAV file."""
    with wave.open(path, "rb") as w:
        sr, width, raw = w.getframerate(), w.getsampwidth(), w.readframes(w.getnframes())
    if width == 2:
        return np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0, sr
    if width == 4:
        return np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0, sr
    raise ValueError(f"unsupported sample width {width}")


def resample_linear(audio: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Linear resampling on the host."""
    if src_rate == dst_rate:
        return audio
    n_out = int(round(len(audio) * dst_rate / src_rate))
    x_old = np.linspace(0.0, 1.0, num=len(audio), endpoint=False)
    x_new = np.linspace(0.0, 1.0, num=n_out, endpoint=False)
    return np.interp(x_new, x_old, audio).astype(np.float32)


@functools.cache
def _analysis(cfg: FbankConfig, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(Hann window ``[win]``, filterbank ``[n_fft // 2 + 1, n_mels]``) on ``device``."""
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, 20.0, cfg.sample_rate / 2)
    return torch.from_numpy(_hann(cfg.win)).to(device), torch.from_numpy(fb).to(device)


def fbank(samples: torch.Tensor, cfg: FbankConfig) -> torch.Tensor:
    """``[(n − 1)·hop + win]`` samples → ``[n, n_mels]`` log-mel frames."""
    window, fb = _analysis(cfg, samples.device)
    frames = samples.unfold(0, cfg.win, cfg.hop) * window
    spec = torch.fft.rfft(frames, n=cfg.n_fft, dim=-1)
    power = spec.real.square() + spec.imag.square()
    return torch.log(torch.clamp_min(power @ fb, 1e-10))


class OnlineFbank:
    """``push(samples) → new frames``: a frame is emitted once its whole
    window has arrived, and the rest is kept for the next push.
    ``frames()`` returns every frame so far with CMVN applied (utterance
    CMVN over the whole prefix, at each call).  The frames are computed on
    ``device``, the card unless the caller asks for the CPU."""

    BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)

    def __init__(self, cfg: FbankConfig = FbankConfig(), src_rate: Optional[int] = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.src_rate = src_rate or cfg.sample_rate
        self.device = torch.device(device)
        self._tail = np.zeros((0,), np.float32)
        self._frames: list[np.ndarray] = []

    def push(self, samples: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        samples = resample_linear(np.asarray(samples, np.float32).reshape(-1), self.src_rate, cfg.sample_rate)
        buf = np.concatenate([self._tail, samples])
        n_frames = (len(buf) - cfg.win) // cfg.hop + 1 if len(buf) >= cfg.win else 0
        if n_frames == 0:
            self._tail = buf
            return np.zeros((0, cfg.n_mels), np.float32)
        bucket = next((b for b in self.BUCKETS if b >= n_frames), n_frames)
        need = (bucket - 1) * cfg.hop + cfg.win
        padded = np.pad(buf, (0, max(0, need - len(buf))))[:need]
        mel = fbank(torch.from_numpy(padded).to(self.device), cfg)[:n_frames].cpu().numpy()
        self._frames.append(mel)
        self._tail = buf[n_frames * cfg.hop:]
        return mel

    def frames(self) -> np.ndarray:
        cfg = self.cfg
        if not self._frames:
            return np.zeros((0, cfg.n_mels), np.float32)
        mel = np.concatenate(self._frames, axis=0)
        if cfg.cmvn == "utterance":
            mean = mel.mean(axis=0, keepdims=True)
            std = mel.std(axis=0, keepdims=True) + 1e-5
            mel = (mel - mean) / std
        elif cfg.cmvn == "global" and cfg.global_mean is not None:
            mean = np.asarray(cfg.global_mean, np.float32)
            std = np.asarray(cfg.global_std, np.float32) + 1e-5
            mel = (mel - mean) / std
        return mel

    @property
    def num_frames(self) -> int:
        return sum(f.shape[0] for f in self._frames)

    def reset(self):
        self._tail = np.zeros((0,), np.float32)
        self._frames.clear()
