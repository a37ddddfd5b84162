"""Evaluation and metrics: speaker and emotion similarity, Average
Lagging, ASR-BLEU with the self-trained CTC judge, the batch and streaming
evaluators and their PASS/FAIL report, and the voice-cloning transfer grid
(:mod:`hifigan_tpu_torch.eval.cloning_eval`)."""

from hifigan_tpu_torch.eval.evaluator import RealTimeEvaluator, StreamEvaluator, create_evaluation_report
from hifigan_tpu_torch.eval.metrics import (
    average_lagging,
    corpus_bleu,
    cosine_similarity,
    emotion_similarity,
    speaker_similarity,
    verify_speaker,
)

__all__ = [
    "cosine_similarity",
    "speaker_similarity",
    "emotion_similarity",
    "average_lagging",
    "verify_speaker",
    "corpus_bleu",
    "StreamEvaluator",
    "RealTimeEvaluator",
    "create_evaluation_report",
]
