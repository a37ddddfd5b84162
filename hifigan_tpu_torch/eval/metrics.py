"""Evaluation metrics: cosine similarity of speaker and emotion
embeddings with the 0.7 speaker-verification threshold, Average Lagging,
the real-time factor, corpus BLEU and ASR-BLEU, mel-L1 and mel-cepstral
distortion.

Counterpart of ``hifigan_tpu/eval/metrics.py``.  The similarity metrics
take embedding functions that run on the device (``mel → [B, D]``); BLEU
runs on the host (sacrebleu when it is installed, else a self-contained
corpus BLEU).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Callable, Sequence

import numpy as np
import torch

SPEAKER_VERIFICATION_THRESHOLD = 0.7


def cosine_similarity(a, b, axis: int = -1) -> torch.Tensor:
    """Cosine similarity along ``axis``, in fp32: ``Σ a·b / max(‖a‖·‖b‖,
    1e-9)``.  The floor is on the *product* of the norms (``F.cosine_similarity``
    floors each norm, another function near zero)."""
    a = torch.as_tensor(a).float()
    b = torch.as_tensor(b).float()
    num = (a * b).sum(dim=axis)
    den = torch.linalg.vector_norm(a, dim=axis) * torch.linalg.vector_norm(b, dim=axis)
    return num / den.clamp_min(1e-9)


def speaker_similarity(embed_fn: Callable, source_mel, generated_mel) -> torch.Tensor:
    """Cosine similarity of the speaker embeddings of source and generated
    audio; ``embed_fn``: ``mel → [B, D]`` speaker encoder."""
    return cosine_similarity(embed_fn(source_mel), embed_fn(generated_mel))


def emotion_similarity(embed_fn: Callable, source_mel, generated_mel) -> torch.Tensor:
    """Cosine similarity of the emotion embeddings."""
    return cosine_similarity(embed_fn(source_mel), embed_fn(generated_mel))


def verify_speaker(emb_a, emb_b, threshold: float = SPEAKER_VERIFICATION_THRESHOLD):
    """Same-speaker decision: ``(cosine ≥ threshold, cosine)``."""
    sim = cosine_similarity(emb_a, emb_b)
    return sim >= threshold, sim


def average_lagging(source_timestamps: Sequence[float], target_timestamps: Sequence[float]) -> float:
    """Average Lagging: the mean delay ``target − source`` over the aligned
    positions (the shorter sequence's length); 0 when either is empty."""
    n = min(len(source_timestamps), len(target_timestamps))
    if n == 0:
        return 0.0
    src = np.asarray(source_timestamps[:n], dtype=np.float64)
    tgt = np.asarray(target_timestamps[:n], dtype=np.float64)
    return float(np.mean(tgt - src))


def real_time_factor(audio_seconds: float, wall_seconds: float) -> float:
    """Audio seconds generated per wall-clock second (higher is faster).
    The inverse of the S2ST session's real-time factor in PERF.md, wall
    seconds per source second."""
    return audio_seconds / max(wall_seconds, 1e-12)


# --------------------------------------------------------------------------
# BLEU (host side)
# --------------------------------------------------------------------------


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i: i + n]) for i in range(len(tokens) - n + 1))


def _bleu_fallback(hypotheses: Sequence[str], references: Sequence[str], max_n: int = 4) -> float:
    """Self-contained corpus BLEU (uniform 4-gram weights, closest-length
    brevity penalty) for installations without sacrebleu."""
    clipped = [0] * max_n
    total = [0] * max_n
    hyp_len = ref_len = 0
    for hyp, ref in zip(hypotheses, references):
        h = hyp.split()
        r = ref.split()
        hyp_len += len(h)
        ref_len += len(r)
        for n in range(1, max_n + 1):
            hc = _ngrams(h, n)
            rc = _ngrams(r, n)
            total[n - 1] += max(0, len(h) - n + 1)
            clipped[n - 1] += sum(min(c, rc[g]) for g, c in hc.items())
    if min(total) == 0 or min(clipped) == 0:
        return 0.0
    log_p = sum(math.log(c / t) for c, t in zip(clipped, total)) / max_n
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    return 100.0 * bp * math.exp(log_p)


def corpus_bleu(hypotheses: Sequence[str], references: Sequence[str]) -> float:
    """Corpus BLEU: sacrebleu's where it is installed, else
    :func:`_bleu_fallback`."""
    try:
        import sacrebleu

        return float(sacrebleu.corpus_bleu(list(hypotheses), [list(references)]).score)
    except Exception:
        return _bleu_fallback(hypotheses, references)


def asr_bleu(transcribe_fn: Callable[[np.ndarray], str], generated_audio: Sequence[np.ndarray],
             reference_texts: Sequence[str]) -> float:
    """ASR-BLEU: transcribe the generated audio and score it against the
    references (both stripped and lower-cased); ``transcribe_fn``: audio →
    text (:mod:`hifigan_tpu_torch.eval.asr`)."""
    hyps = [transcribe_fn(a).strip().lower() for a in generated_audio]
    refs = [t.strip().lower() for t in reference_texts]
    return corpus_bleu(hyps, refs)


# --------------------------------------------------------------------------
# Fidelity
# --------------------------------------------------------------------------


def mel_l1(mel_a, mel_b) -> float:
    """Mean absolute difference of two mels, in fp32."""
    return float(torch.mean(torch.abs(torch.as_tensor(mel_a).float() - torch.as_tensor(mel_b).float())))


def mcd(log_mel_a: np.ndarray, log_mel_b: np.ndarray) -> float:
    """Mel-cepstral distortion (dB) between two aligned log-mel
    spectrograms ``[frames, n_mels]``, from DCT cepstra 1..13."""
    from scipy.fftpack import dct

    ca = dct(np.asarray(log_mel_a), axis=-1, norm="ortho")[..., 1:14]
    cb = dct(np.asarray(log_mel_b), axis=-1, norm="ortho")[..., 1:14]
    diff = ca - cb
    return float(np.mean(np.sqrt(np.sum(diff ** 2, axis=-1))) * (10.0 / np.log(10)) * np.sqrt(2.0))
