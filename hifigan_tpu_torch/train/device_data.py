"""On-device training data: the whole corpus lives in device memory and
each step's crops are drawn there.

Counterpart of ``hifigan_tpu/train/device_data.py``.  The draws come from a
``torch.Generator`` on the bank's device, not JAX's PRNG; the semantics are
the JAX package's: a uniform utterance, then an offset that keeps the crop
within that utterance's true length, and offset 0 for utterances shorter
than the crop (which then runs on over the row's zero padding).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def build_audio_bank(dataset, *, pad_to_multiple: int = 128) -> tuple[np.ndarray, np.ndarray]:
    """Every utterance of ``dataset`` (its ``_utterance(i)`` where it has
    one, as the formant corpus does, else ``dataset[i]``) in one
    zero-padded ``[N, L]`` float32 array, with the true lengths ``[N]``."""
    get = dataset._utterance if hasattr(dataset, "_utterance") else dataset.__getitem__
    utts = [np.asarray(get(i), np.float32) for i in range(len(dataset))]
    lengths = np.array([len(u) for u in utts], np.int32)
    L = -(-int(lengths.max()) // pad_to_multiple) * pad_to_multiple
    bank = np.zeros((len(utts), L), np.float32)
    for i, u in enumerate(utts):
        bank[i, : len(u)] = u
    return bank, lengths


def make_device_sampler(
    bank: torch.Tensor,
    lengths: torch.Tensor,
    segment_samples: int,
    batch_size: int,
) -> Callable[[torch.Generator], torch.Tensor]:
    """``sample(gen) → [batch_size, segment_samples]``: random crops of the
    rows of ``bank [N, L]`` (true lengths ``lengths [N]``), drawn with
    ``gen``, a ``torch.Generator`` on the bank's device."""
    n, L = bank.shape
    if L < segment_samples:
        raise ValueError(f"the bank's rows ({L} samples) are shorter than a crop ({segment_samples})")
    lengths = lengths.to(device=bank.device, dtype=torch.int64)
    steps = torch.arange(segment_samples, device=bank.device)

    def sample(gen: torch.Generator) -> torch.Tensor:
        utt = torch.randint(0, n, (batch_size,), generator=gen, device=bank.device)
        span = (lengths[utt] - segment_samples).clamp_min(1)
        off = (torch.rand(batch_size, generator=gen, device=bank.device) * span).long()
        return bank[utt[:, None], off[:, None] + steps]

    return sample
