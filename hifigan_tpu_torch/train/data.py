"""Host-side training data: synthetic pseudo-speech and a shuffled batch
loader.

The port's own copy of ``SyntheticSpeechDataset`` and ``BatchLoader`` from
``hifigan_tpu/train/data.py`` (numpy and the standard library; the same
rows and batches for the same seeds).
"""

from __future__ import annotations

import random
from typing import Iterator

import numpy as np


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
