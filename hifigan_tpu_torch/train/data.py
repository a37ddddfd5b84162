"""Host-side training data: a directory of wav files with augmentation,
synthetic pseudo-speech and a shuffled batch loader.

The port's own copy of ``hifigan_tpu/train/data.py`` (numpy and the
standard library; the same crops, rows and batches for the same seeds and
the same ``random.Random``).  Augmentation follows the reference training
config's block: pitch ±2 semitones and stretch 0.9–1.1 by linear
resampling, additive noise of std 0.01, each with probability 0.5.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

from hifigan_tpu_torch.streaming.features import read_wav, resample_linear


@dataclass
class AugmentConfig:
    """The reference training config's augmentation block."""

    pitch_semitones: float = 2.0
    stretch_min: float = 0.9
    stretch_max: float = 1.1
    noise_std: float = 0.01
    probability: float = 0.5


def augment(audio: np.ndarray, cfg: AugmentConfig, rng: random.Random) -> np.ndarray:
    """Pitch shift, time stretch (both by resampling 16 kHz audio) and
    additive Gaussian noise, each drawn with ``cfg.probability`` from
    ``rng``; the noise comes from a numpy generator seeded by ``rng``."""
    if rng.random() < cfg.probability:
        semis = rng.uniform(-cfg.pitch_semitones, cfg.pitch_semitones)
        audio = resample_linear(audio, int(16000 * 2.0 ** (semis / 12.0)), 16000)
    if rng.random() < cfg.probability:
        stretch = rng.uniform(cfg.stretch_min, cfg.stretch_max)
        audio = resample_linear(audio, 16000, int(16000 * stretch))
    if cfg.noise_std > 0 and rng.random() < cfg.probability:
        noise = np.random.default_rng(rng.randrange(1 << 31)).normal(0, cfg.noise_std, len(audio))
        audio = audio + noise.astype(np.float32)
    return audio.astype(np.float32)


class WavDirectoryDataset:
    """Every ``*.wav`` under ``root`` (walked recursively, names sorted in
    each directory); item ``i`` is file ``i`` resampled to
    ``sample_rate``, augmented when ``augment_cfg`` is given, zero-padded
    to ``segment_samples`` when shorter, and cropped at a random offset.
    One ``random.Random(seed)`` draws the augmentation and the crops."""

    def __init__(self, root: str, *, segment_samples: int = 8192, sample_rate: int = 16_000,
                 augment_cfg: Optional[AugmentConfig] = None, seed: int = 0):
        self.files: List[str] = []
        for dirpath, _, names in os.walk(root):
            for n in sorted(names):
                if n.lower().endswith(".wav"):
                    self.files.append(os.path.join(dirpath, n))
        if not self.files:
            raise FileNotFoundError(f"no .wav files under {root}")
        self.segment_samples = segment_samples
        self.sample_rate = sample_rate
        self.augment_cfg = augment_cfg
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        audio, sr = read_wav(self.files[idx % len(self.files)])
        if sr != self.sample_rate:
            audio = resample_linear(audio, sr, self.sample_rate)
        if self.augment_cfg:
            audio = augment(audio, self.augment_cfg, self._rng)
        seg = self.segment_samples
        if len(audio) < seg:
            audio = np.pad(audio, (0, seg - len(audio)))
        start = self._rng.randrange(0, len(audio) - seg + 1)
        return audio[start: start + seg].astype(np.float32)


class SyntheticSpeechDataset:
    """Harmonic + noise pseudo-speech; row ``i`` is drawn from seed ``i``."""

    def __init__(self, *, segment_samples: int = 8192, sample_rate: int = 16_000, size: int = 1024):
        self.segment_samples = segment_samples
        self.sample_rate = sample_rate
        self.size = size

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(idx)
        t = np.arange(self.segment_samples) / self.sample_rate
        f0 = rng.uniform(80, 250)
        sig = np.zeros_like(t, dtype=np.float64)
        for h in range(1, 6):
            sig += rng.uniform(0.1, 1.0) / h * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(1, 4) * t))
        sig = sig * env + rng.normal(0, 0.01, len(t))
        return (0.5 * sig / (np.abs(sig).max() + 1e-9)).astype(np.float32)


class BatchLoader:
    """Shuffled epochs of ``{"audio": [B, T]}`` batches.  ``num_chunks > 1``
    splits the dataset into sequential chunks (incremental training)."""

    def __init__(self, dataset, batch_size: int = 16, *, seed: int = 0, num_chunks: int = 1,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_chunks = num_chunks
        self.drop_last = drop_last

    def epoch(self, epoch_idx: int = 0, chunk: int = 0) -> Iterator[dict]:
        idx = list(range(len(self.dataset)))
        if self.num_chunks > 1:
            per = max(1, len(idx) // self.num_chunks)
            idx = idx[chunk * per: (chunk + 1) * per]
        random.Random(self.seed + epoch_idx).shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            batch_idx = idx[i: i + self.batch_size]
            if self.drop_last and len(batch_idx) < self.batch_size:
                break
            yield {"audio": np.stack([self.dataset[j] for j in batch_idx])}
