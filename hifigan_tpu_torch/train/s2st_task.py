"""The S2ST task's token spaces, toy translation and batched fbank.

Counterpart of the inference half of ``hifigan_tpu/train/s2st_task.py``:
what the CTC judge (:class:`hifigan_tpu_torch.eval.asr.CTCTranscriber`)
and the S2ST evaluation read.  The formant corpus knows its own phone plan,
and a deterministic toy translation defines a target language: within each
pause-delimited word the phone sequence is reversed and mapped through a
fixed phone permutation.

Token space: ``0`` = CTC blank / pad, ``1`` = BOS, ``2`` = EOS,
``3 + (phone_id - 1)`` = phone tokens (pau never surfaces as a token).
Unit space: ``0`` = blank / pad, ``1 + perm(phone) - 1`` = unit ids.

The bank (``build_s2st_bank``), the train state and the train step are not
ported yet.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from hifigan_tpu_torch.ops.stft import _hann, mel_filterbank
from hifigan_tpu_torch.train.corpus import PHONES

BLANK = 0
BOS = 1
EOS = 2
TOKEN_OFFSET = 3
N_PHONES = len(PHONES)  # includes pau at id 0


def phone_permutation(seed: int = 1234) -> np.ndarray:
    """Fixed permutation over non-pau phone ids 1..N-1 (index 0 unused)."""
    rng = np.random.default_rng(seed)
    perm = np.zeros(N_PHONES, np.int32)
    perm[1:] = rng.permutation(np.arange(1, N_PHONES))
    return perm


_PERM = phone_permutation()


def source_tokens(phone_ids: np.ndarray) -> np.ndarray:
    """ASR transcript: non-pau phones → token ids."""
    p = phone_ids[phone_ids != 0]
    return (TOKEN_OFFSET + p - 1).astype(np.int32)


def translate(phone_ids: np.ndarray) -> np.ndarray:
    """Toy translation: per pause-delimited word, reverse the phone order
    and map through the fixed permutation."""
    out: list[int] = []
    word: list[int] = []
    for p in phone_ids:
        if p == 0:
            out.extend(TOKEN_OFFSET + _PERM[q] - 1 for q in reversed(word))
            word = []
        else:
            word.append(int(p))
    out.extend(TOKEN_OFFSET + _PERM[q] - 1 for q in reversed(word))
    return np.array(out, np.int32)


def target_units(phone_ids: np.ndarray) -> np.ndarray:
    """Unit sequence: translated phones in unit space (1-based)."""
    toks = translate(phone_ids)
    return (toks - TOKEN_OFFSET + 1).astype(np.int32)


@dataclass(frozen=True)
class S2STTaskConfig:
    n_utterances: int = 512
    n_speakers: int = 32
    max_seconds: float = 4.0
    max_src_tokens: int = 56
    max_tgt_tokens: int = 56
    batch_size: int = 16
    learning_rate: float = 3e-4
    warmup_steps: int = 500
    prefix_mask_prob: float = 0.5
    # lower bound of the sampled source-prefix fraction on masked rows
    prefix_min_frac: float = 0.25
    # fbank (the streaming extractor's: 25 ms window / 10 ms shift)
    sample_rate: int = 16_000
    hop: int = 160
    win: int = 400

    @property
    def n_frames(self) -> int:
        return int(self.max_seconds * self.sample_rate) // self.hop

    @property
    def n_samples(self) -> int:
        return (self.n_frames - 1) * self.hop + self.win


def batched_fbank(audio: torch.Tensor, n_frames_total: int, hop: int, win: int, n_mels: int = 80,
                  sample_rate: int = 16_000, valid_frames: torch.Tensor | None = None) -> torch.Tensor:
    """``[B, S] → [B, T, n_mels]`` log-fbank with per-utterance CMVN.

    ``T = n_frames_total`` frames of ``win`` samples every ``hop``, not
    centred (``S`` must hold ``(T - 1)·hop + win`` samples), a periodic
    Hann window, ``rfft`` at the next power of two, power through the
    Slaney filterbank from 20 Hz to half the rate, ``log(max(·, 1e-10))``.
    CMVN with the population std floored at 1e-5: over all ``T`` frames
    without ``valid_frames``; else over each row's first ``valid_frames``
    frames only, and the frames past them are set to 0."""
    need = (n_frames_total - 1) * hop + win
    if audio.shape[-1] < need:
        raise ValueError(f"{n_frames_total} frames need {need} samples, got {audio.shape[-1]}")
    dev = audio.device
    n_fft = int(2 ** np.ceil(np.log2(win)))
    frames = audio[:, :need].unfold(-1, win, hop) * torch.from_numpy(_hann(win)).to(dev)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    power = spec.real.square() + spec.imag.square()
    fb = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels, 20.0, sample_rate / 2)).to(dev)
    mel = torch.log(torch.clamp_min(power @ fb, 1e-10))
    if valid_frames is None:
        mean = mel.mean(dim=1, keepdim=True)
        std = mel.std(dim=1, keepdim=True, correction=0)
        return (mel - mean) / torch.clamp_min(std, 1e-5)
    mask = (torch.arange(n_frames_total, device=dev)[None, :] < valid_frames.to(dev)[:, None])
    m = mask[..., None].to(mel.dtype)
    denom = torch.clamp_min(m.sum(dim=1, keepdim=True), 1.0)
    mean = (mel * m).sum(dim=1, keepdim=True) / denom
    var = ((mel - mean).square() * m).sum(dim=1, keepdim=True) / denom
    mel = (mel - mean) / torch.clamp_min(var.sqrt(), 1e-5)
    return mel * m


def token_f1(hyp, ref) -> float:
    """Bag-of-tokens F1 (the 'nontrivially accurate text' metric)."""
    h, r = Counter(list(map(int, hyp))), Counter(list(map(int, ref)))
    overlap = sum((h & r).values())
    if overlap == 0:
        return 0.0
    prec = overlap / max(sum(h.values()), 1)
    rec = overlap / max(sum(r.values()), 1)
    return 2 * prec * rec / (prec + rec)
