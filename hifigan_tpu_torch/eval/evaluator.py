"""Batch and streaming evaluators, and the PASS/FAIL report.

Counterpart of ``hifigan_tpu/eval/evaluator.py``:

* :class:`StreamEvaluator`: per sample, synthesise, then speaker and
  emotion SIM, mel-L1 and MCD over the valid frames, the processing time
  and real-time factor, and ASR-BLEU when a transcriber is given;
* :class:`RealTimeEvaluator`: per chunk of a stream, the processing time
  and the source and emission times, summarised with Average Lagging;
* :func:`create_evaluation_report`: the JSON report scored against the
  literature benchmarks: speaker SIM 0.73 (Wang et al., 2023) with
  threshold 0.70, ASR-BLEU 27.25 (Zhang et al., 2024) with threshold 20.0,
  emotion SIM threshold 0.70.  A metric never computed is SKIPPED.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from hifigan_tpu_torch.eval.metrics import asr_bleu, average_lagging, cosine_similarity, mcd, mel_l1, real_time_factor

BENCHMARKS = {
    "speaker_similarity": {
        "benchmark": 0.73,
        "benchmark_source": "Wang et al. (2023)",
        "threshold": 0.70,
    },
    "emotion_similarity": {
        "benchmark": None,
        "benchmark_source": None,
        "threshold": 0.70,
    },
    "asr_bleu": {
        "benchmark": 27.25,
        "benchmark_source": "Zhang et al. (2024)",
        "threshold": 20.0,
    },
}


def _stats(values: Sequence[float]) -> Dict[str, float]:
    v = np.asarray([x for x in values if x is not None], dtype=np.float64)
    if v.size == 0:
        return {"mean": float("nan"), "std": float("nan"),
                "min": float("nan"), "max": float("nan"), "count": 0}
    return {
        "mean": float(v.mean()), "std": float(v.std()),
        "min": float(v.min()), "max": float(v.max()), "count": int(v.size),
    }


def aggregate_statistics(results: Sequence[dict]) -> Dict[str, dict]:
    """Mean / std / min / max / count per metric key across per-sample
    result dicts."""
    keys = set().union(*(r.keys() for r in results)) if results else set()
    return {k: _stats([r.get(k) for r in results]) for k in sorted(keys)}


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class StreamEvaluator:
    """End-to-end evaluator over (mel, reference text) samples.

    Args:
      synthesize_fn: ``mel [1, n_mels, T] → wav [1, 1, T·hop]`` on the device.
      speaker_embed_fn / emotion_embed_fn: ``mel → [1, D]``.
      mel_fn: ``wav [1, S] → mel [1, n_mels, S // hop]`` (to embed the
        generated audio).
      transcribe_fn: optional host ASR (``audio → text``) for ASR-BLEU.
    """

    def __init__(self, synthesize_fn: Callable, speaker_embed_fn: Callable, emotion_embed_fn: Callable,
                 mel_fn: Callable, transcribe_fn: Optional[Callable] = None):
        self.synthesize_fn = synthesize_fn
        self.speaker_embed_fn = speaker_embed_fn
        self.emotion_embed_fn = emotion_embed_fn
        self.mel_fn = mel_fn
        self.transcribe_fn = transcribe_fn
        self._warm_shapes: set = set()

    def evaluate_single_sample(self, mel, reference_text: Optional[str] = None,
                               valid_frames: Optional[int] = None) -> dict:
        """The sample's metrics.  ``processing_time`` is the synthesis call
        and the waveform's copy to the host, which waits for the device;
        one untimed call per input shape comes first (the kernel library's
        first build and cuDNN's algorithm search fall there).  The fidelity
        metrics are scored over the first ``valid_frames`` frames only:
        a shared bucket's zero padding would otherwise move them both ways
        (shared silence inflates the embeddings' cosines; a noisy generated
        tail can collapse the pooled emotion embedding)."""
        shape = tuple(mel.shape)
        if shape not in self._warm_shapes:
            _host(self.synthesize_fn(mel))
            self._warm_shapes.add(shape)
        t0 = time.perf_counter()
        wav = self.synthesize_fn(mel)
        wav_np = _host(wav)
        wall = time.perf_counter() - t0
        gen_mel = self.mel_fn(wav[:, 0, :])
        frames = min(mel.shape[-1], gen_mel.shape[-1])
        if valid_frames is not None:
            frames = min(frames, int(valid_frames))
        mel_v, gen_v = mel[..., :frames], gen_mel[..., :frames]
        spk_sim = float(cosine_similarity(self.speaker_embed_fn(mel_v), self.speaker_embed_fn(gen_v))[0])
        emo_sim = float(cosine_similarity(self.emotion_embed_fn(mel_v), self.emotion_embed_fn(gen_v))[0])
        result = {
            "speaker_similarity": spk_sim,
            "emotion_similarity": emo_sim,
            "mel_l1": mel_l1(mel_v, gen_v),
            "mcd": mcd(_host(mel)[0, :, :frames].T, _host(gen_mel)[0, :, :frames].T),
            "processing_time": wall,
            "rtf": real_time_factor(wav_np.shape[-1] / 16_000, wall),
        }
        if self.transcribe_fn is not None and reference_text is not None:
            result["asr_bleu"] = asr_bleu(self.transcribe_fn, [wav_np[0, 0]], [reference_text])
        return result

    def evaluate_batch(self, samples: Sequence[dict]) -> List[dict]:
        return [self.evaluate_single_sample(s["mel"], s.get("reference_text"), s.get("valid_frames"))
                for s in samples]

    def compute_statistics(self, results: Sequence[dict]) -> Dict[str, dict]:
        return aggregate_statistics(results)


class RealTimeEvaluator:
    """Streaming evaluator: feed chunks, record each chunk's wall time and
    its source and emission times, then summarise latency and AL."""

    def __init__(self, streaming_fn: Callable, chunk_duration_s: float):
        self.streaming_fn = streaming_fn
        self.chunk_duration_s = chunk_duration_s
        self.records: List[dict] = []
        self._elapsed_source = 0.0

    def process_chunk(self, chunk, **kwargs) -> dict:
        t0 = time.perf_counter()
        out = self.streaming_fn(chunk, **kwargs)
        # copy every array to the host, so that the wall time covers the device's work
        _ = [_host(v) for v in out.values() if hasattr(v, "shape")]
        wall = time.perf_counter() - t0
        self._elapsed_source += self.chunk_duration_s
        rec = {
            "source_time": self._elapsed_source,
            "processing_time": wall,
            "emit_time": self._elapsed_source + wall,
        }
        self.records.append(rec)
        return {**out, **rec}

    def compute_streaming_metrics(self) -> dict:
        if not self.records:
            return {"avg_processing_time": 0.0, "average_lagging": 0.0, "chunks": 0}
        proc = [r["processing_time"] for r in self.records]
        al = average_lagging([r["source_time"] for r in self.records], [r["emit_time"] for r in self.records])
        return {
            "avg_processing_time": float(np.mean(proc)),
            "max_processing_time": float(np.max(proc)),
            "average_lagging": al,
            "real_time_factor": real_time_factor(self.chunk_duration_s * len(proc), float(np.sum(proc))),
            "chunks": len(proc),
        }

    def reset(self):
        self.records.clear()
        self._elapsed_source = 0.0


def create_evaluation_report(results: Sequence[dict], output_path: Optional[str] = None,
                             extra: Optional[dict] = None) -> dict:
    """The JSON report: raw results, statistics, and each benchmark's
    status (PASS / FAIL against its threshold, SKIPPED when the metric was
    never computed), with ``extra``'s keys; written to ``output_path``
    when given."""
    stats = aggregate_statistics(results)
    benchmarks = {}
    for metric, spec in BENCHMARKS.items():
        mean = stats.get(metric, {}).get("mean")
        missing = mean is None or np.isnan(mean)
        benchmarks[metric] = {
            **spec,
            "achieved": None if missing else mean,
            "status": ("SKIPPED" if missing else "PASS" if mean >= spec["threshold"] else "FAIL"),
        }
    report = {
        "num_samples": len(results),
        "raw_results": list(results),
        "statistics": stats,
        "benchmarks": benchmarks,
        **(extra or {}),
    }
    if output_path:
        with open(output_path, "w") as f:
            json.dump(report, f, indent=2, default=float)
    return report
