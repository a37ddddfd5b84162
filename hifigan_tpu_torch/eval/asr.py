"""ASR transcription backends for ASR-BLEU.

Counterpart of ``hifigan_tpu/eval/asr.py``:

* :class:`CTCTranscriber`: the self-trained offline judge.  The source CTC
  head of a StreamSpeech model trained on the formant corpus's phone
  transcripts turns audio into phone-name strings, so ASR-BLEU runs
  without any download.  It reads a :func:`hifigan_tpu_torch.weights.save_ctc_judge`
  file (the JAX package's trainer writes orbax run directories, which the
  port does not read; ``load_jax_params`` carries them over).
* :func:`judge_competence` / :func:`load_competent_ctc`: a judge must
  transcribe a few ground-truth clips within a phone error rate before its
  BLEU is trusted; a rejected judge shows in the report.
* :class:`HFTranscriber`: a HuggingFace wav2vec2-CTC model (greedy), from
  the local cache only unless ``HIFIGAN_TPU_ALLOW_DOWNLOADS`` is set;
  ``transformers`` is imported when one is built.
* :class:`NullTranscriber`: an injected transcript table.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from hifigan_tpu_torch.entry import resolve_device
from hifigan_tpu_torch.streaming.decode import ctc_greedy_collapse
from hifigan_tpu_torch.train.corpus import PHONES
from hifigan_tpu_torch.train.s2st_task import TOKEN_OFFSET, S2STTaskConfig, batched_fbank
from hifigan_tpu_torch.weights import load_ctc_judge

log = logging.getLogger("hifigan_tpu_torch")

# per-language HF checkpoints (en: the LV-60 self-trained wav2vec2)
ASR_MODEL_REGISTRY = {
    "en": "facebook/wav2vec2-large-960h-lv60-self",
    "es": "jonatasgrosman/wav2vec2-large-xlsr-53-spanish",
    "fr": "jonatasgrosman/wav2vec2-large-xlsr-53-french",
    "de": "jonatasgrosman/wav2vec2-large-xlsr-53-german",
    "zh": "jonatasgrosman/wav2vec2-large-xlsr-53-chinese-zh-cn",
}

DEFAULT_JUDGE = "runs/s2st/ctc_judge.pt"


class HFTranscriber:
    """HuggingFace wav2vec2-CTC transcriber, greedy, on ``device``."""

    def __init__(self, lang: str = "en", model_name: Optional[str] = None, sample_rate: int = 16_000,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        from transformers import Wav2Vec2ForCTC, Wav2Vec2Processor

        kw = ({} if os.environ.get("HIFIGAN_TPU_ALLOW_DOWNLOADS", "").lower() in ("1", "true")
              else {"local_files_only": True})
        name = model_name or ASR_MODEL_REGISTRY[lang]
        self.processor = Wav2Vec2Processor.from_pretrained(name, **kw)
        self.model = Wav2Vec2ForCTC.from_pretrained(name, **kw).to(self.device)
        self.model.eval()
        self.sample_rate = sample_rate

    def __call__(self, audio: np.ndarray) -> str:
        audio = np.asarray(audio, dtype=np.float32).reshape(-1)
        peak = np.abs(audio).max()
        if peak > 0:
            audio = audio / peak
        inputs = self.processor(audio, sampling_rate=self.sample_rate, return_tensors="pt")
        with torch.no_grad():
            logits = self.model(inputs.input_values.to(self.device)).logits
        ids = logits.argmax(dim=-1).cpu()
        return self.processor.batch_decode(ids)[0].strip().lower()


class NullTranscriber:
    """Returns the injected transcript of the n-th call (``table[n]``), or
    the empty string."""

    def __init__(self, table: Optional[dict] = None):
        self.table = table or {}
        self._count = 0

    def __call__(self, audio: np.ndarray) -> str:
        key = self._count
        self._count += 1
        return self.table.get(key, "")


class CTCTranscriber:
    """The CTC judge of ``checkpoint`` (a ``save_ctc_judge`` file) on
    ``device``: ``audio → "phone phone ..."``.

    The audio's ``frames = (len − 400) // 160 + 1`` fbank frames are padded
    up to the first of :attr:`BUCKETS` that holds them (past 1024, the next
    multiple of 128), the fbank's CMVN runs over the valid frames only,
    then the chunked encoder, the source CTC head and its argmax; on the
    host, the valid frames' ids are collapsed and the tokens named through
    ``TOKEN_OFFSET``."""

    BUCKETS = (128, 256, 400, 512, 768, 1024)

    def __init__(self, checkpoint: str = DEFAULT_JUDGE, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model, self.step = load_ctc_judge(checkpoint, self.device)
        self.model_cfg = self.model.config
        self.task_cfg = S2STTaskConfig()

    @torch.no_grad()
    def _ids(self, buf: np.ndarray, frames: int, bucket: int) -> np.ndarray:
        audio = torch.from_numpy(buf[None]).to(self.device)
        valid = torch.tensor([frames], device=self.device)
        feats = batched_fbank(audio, bucket, self.task_cfg.hop, self.task_cfg.win, valid_frames=valid)
        enc = self.model.encoder(feats, chunked=True)
        return self.model.source_ctc(enc).argmax(dim=-1)[0, :frames].cpu().numpy()

    def __call__(self, audio: np.ndarray) -> str:
        hop, win = self.task_cfg.hop, self.task_cfg.win
        frames = max(1, (len(audio) - win) // hop + 1)
        bucket = next((b for b in self.BUCKETS if b >= frames), ((frames + 127) // 128) * 128)
        buf = np.zeros(((bucket - 1) * hop + win,), np.float32)
        buf[: len(audio)] = audio[: len(buf)]
        tokens, _frames = ctc_greedy_collapse(self._ids(buf, frames, bucket), 0)
        names = []
        for t in tokens:
            p = t - TOKEN_OFFSET + 1
            if 1 <= p < len(PHONES):
                names.append(PHONES[p])
        return " ".join(names)


def phone_cer(hyp: str, ref: str) -> float:
    """Token-level character-error-rate analogue over space-separated phone
    strings: Levenshtein distance in tokens / reference length."""
    h, r = hyp.split(), ref.split()
    if not r:
        return 0.0 if not h else 1.0
    prev = list(range(len(h) + 1))
    for i, rt in enumerate(r, 1):
        cur = [i]
        for j, ht in enumerate(h, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (rt != ht)))
        prev = cur
    return prev[-1] / len(r)


def judge_competence(transcriber, clips, refs, max_cer: float = 0.4) -> dict:
    """Gate an ASR judge on ground-truth audio before trusting its BLEU:
    its mean phone CER over ``clips`` must be at most ``max_cer``."""
    cers = [phone_cer(transcriber(np.asarray(c)), r) for c, r in zip(clips, refs)]
    mean = float(np.mean(cers)) if cers else 1.0
    return {"ground_truth_cer": round(mean, 4), "n_clips": len(cers),
            "max_cer": max_cer, "competent": bool(mean <= max_cer)}


def load_competent_ctc(candidates, clips, refs, max_cer: float = 0.4, device: str | torch.device = "cuda"):
    """The first CTC judge among the ``candidates`` files that passes
    :func:`judge_competence` on the ground-truth clips.

    Returns ``(transcriber or None, report)``; the report records every
    candidate's CER (under ``"dir"``, the candidate's path, the JAX
    report's key), or the error that kept it from loading, so that a
    rejected judge shows in the evaluation's JSON."""
    report = {"candidates": [], "selected": None, "max_cer": max_cer}
    for path in candidates:
        if not path or not os.path.isfile(path):
            continue
        try:
            t = CTCTranscriber(path, device)
        except Exception as e:  # noqa: BLE001 - recorded in the report
            report["candidates"].append({"dir": path, "error": repr(e)[:200]})
            continue
        gate = judge_competence(t, clips, refs, max_cer)
        report["candidates"].append({"dir": path, "step": t.step, **gate})
        if gate["competent"]:
            report["selected"] = path
            log.info("ASR judge %s (step %d) passes the competence gate (CER %.3f <= %.2f)", path, t.step,
                     gate["ground_truth_cer"], max_cer)
            return t, report
        log.warning("ASR judge %s (step %d) REJECTED: ground-truth CER %.3f > %.2f", path, t.step,
                    gate["ground_truth_cer"], max_cer)
    return None, report


def make_transcriber(lang: str = "en", model_name: Optional[str] = None, device: str | torch.device = "cuda"):
    """Best-effort transcriber: the CTC judge at :data:`DEFAULT_JUDGE` for
    the corpus's phone language; for a natural language the HF model when
    its weights are reachable, else that CTC judge when its file exists,
    else None."""
    if lang in ("formant", "phone"):
        try:
            return CTCTranscriber(device=device)
        except Exception:
            return None
    try:
        return HFTranscriber(lang, model_name, device=device)
    except Exception:
        log.warning("no HF ASR model for %s; falling back to the CTC judge %s", lang, DEFAULT_JUDGE)
        if os.path.isfile(DEFAULT_JUDGE):
            try:
                return CTCTranscriber(device=device)
            except Exception:
                return None
        return None
