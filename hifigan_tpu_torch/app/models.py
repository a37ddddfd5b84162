"""Cascade-stage model wrappers: ASR, MT and TTS.

Counterpart of ``hifigan_tpu/app/models.py``:

* :class:`ASRModel` (wav2vec2-CTC through the port's
  ``eval/asr.py::HFTranscriber``), :class:`StreamingASR` (transcribe every
  N chunks) and :class:`ASRModelFactory`;
* :class:`TranslationModel` (MarianMT, beam 5, no-repeat n-gram 2),
  :class:`TranslationPipeline` (both directions of a pair) and
  :class:`StreamingTranslator` (translate every N text chunks);
* :class:`TTSModel`: SpeechT5's text → mel stage, then the port's own
  vocoder (``vocoder_synth``, from :func:`~hifigan_tpu_torch.app.engine.make_vocoder_synth`)
  when one is given, else SpeechT5's HiFi-GAN; :class:`StreamingTTS`; and
  :class:`AudioPostProcessor`.

The HF models are read from local files only unless
``HIFIGAN_TPU_ALLOW_DOWNLOADS`` is set, and each stage degrades as the JAX
package's does when its model cannot be loaded: ASR returns "", MT echoes
the source, TTS returns silence.  They run on ``device``, the card unless
the caller passes ``"cpu"``.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from hifigan_tpu_torch.streaming.features import resample_linear

log = logging.getLogger(__name__)


def _hf_kwargs() -> dict:
    """Offline-first loading: the network only when the user opts in
    (``HIFIGAN_TPU_ALLOW_DOWNLOADS=1``); without network an attempt hangs,
    ``local_files_only`` fails fast."""
    if os.environ.get("HIFIGAN_TPU_ALLOW_DOWNLOADS", "").lower() in ("1", "true"):
        return {}
    return {"local_files_only": True}


class ASRModel:
    """wav2vec2-CTC transcription (greedy), "" when the model is missing."""

    def __init__(self, model_name: str, sample_rate: int = 16_000, device: str | torch.device = "cuda"):
        self.model_name = model_name
        self.sample_rate = sample_rate
        self._backend = None
        try:
            from hifigan_tpu_torch.eval.asr import HFTranscriber

            self._backend = HFTranscriber(model_name=model_name, sample_rate=sample_rate, device=device)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # graceful degradation
            log.warning("ASR model %s unavailable (%s); transcribe → ''", model_name, e)

    @property
    def available(self) -> bool:
        return self._backend is not None

    def transcribe(self, audio: np.ndarray, src_rate: Optional[int] = None) -> str:
        if self._backend is None:
            return ""
        if src_rate and src_rate != self.sample_rate:
            audio = resample_linear(audio, src_rate, self.sample_rate)
        try:
            return self._backend(audio)
        except Exception:
            log.exception("ASR failed")
            return ""


class StreamingASR:
    """Buffer N chunks, then transcribe their concatenation."""

    def __init__(self, asr: ASRModel, buffer_chunks: int = 5):
        self.asr = asr
        self.buffer_chunks = buffer_chunks
        self._chunks: List[np.ndarray] = []

    def add_audio_chunk(self, chunk: np.ndarray) -> Optional[str]:
        self._chunks.append(np.asarray(chunk, np.float32).reshape(-1))
        if len(self._chunks) >= self.buffer_chunks:
            return self.flush()
        return None

    def flush(self) -> Optional[str]:
        if not self._chunks:
            return None
        audio = np.concatenate(self._chunks)
        self._chunks = []
        return self.asr.transcribe(audio)


class ASRModelFactory:
    REGISTRY = {
        "en": "facebook/wav2vec2-large-960h-lv60-self",
        "es": "facebook/wav2vec2-large-960h-lv60-self",
    }

    @classmethod
    def create(cls, lang: str, device: str | torch.device = "cuda") -> ASRModel:
        return ASRModel(cls.REGISTRY.get(lang, cls.REGISTRY["en"]), device=device)


class TranslationModel:
    """MarianMT text translation; the source text when the model is missing."""

    def __init__(self, model_name: str, *, beam_size: int = 5, no_repeat_ngram: int = 2,
                 device: str | torch.device = "cuda"):
        self.model_name = model_name
        self.beam_size = beam_size
        self.no_repeat_ngram = no_repeat_ngram
        self.device = torch.device(device)
        self._model = self._tok = None
        try:
            from transformers import MarianMTModel, MarianTokenizer

            self._tok = MarianTokenizer.from_pretrained(model_name, **_hf_kwargs())
            self._model = MarianMTModel.from_pretrained(model_name, **_hf_kwargs()).to(self.device).eval()
        except Exception as e:
            log.warning("MT model %s unavailable (%s); translate → identity", model_name, e)

    @property
    def available(self) -> bool:
        return self._model is not None

    def translate(self, text: str) -> str:
        if not text.strip():
            return ""
        if self._model is None:
            return text
        try:
            batch = self._tok([text], return_tensors="pt", padding=True).to(self.device)
            with torch.no_grad():
                out = self._model.generate(**batch, num_beams=self.beam_size,
                                           no_repeat_ngram_size=self.no_repeat_ngram)
            return self._tok.batch_decode(out, skip_special_tokens=True)[0]
        except Exception:
            log.exception("MT failed")
            return text


class TranslationPipeline:
    """Both directions of a language pair."""

    PAIRS = {
        ("en", "es"): "Helsinki-NLP/opus-mt-en-es",
        ("es", "en"): "Helsinki-NLP/opus-mt-es-en",
        ("en", "fr"): "Helsinki-NLP/opus-mt-en-fr",
        ("fr", "en"): "Helsinki-NLP/opus-mt-fr-en",
    }

    def __init__(self, source_lang: str = "en", target_lang: str = "es", **kw):
        self.source_lang, self.target_lang = source_lang, target_lang
        self.forward = TranslationModel(self.PAIRS.get((source_lang, target_lang), self.PAIRS[("en", "es")]), **kw)
        self.backward = TranslationModel(self.PAIRS.get((target_lang, source_lang), self.PAIRS[("es", "en")]), **kw)

    def translate(self, text: str, reverse: bool = False) -> str:
        return (self.backward if reverse else self.forward).translate(text)


class StreamingTranslator:
    """Buffer text chunks, translate when full."""

    def __init__(self, model: TranslationModel, buffer_chunks: int = 3):
        self.model = model
        self.buffer_chunks = buffer_chunks
        self._chunks: List[str] = []

    def add_text_chunk(self, text: str) -> Optional[str]:
        if text.strip():
            self._chunks.append(text.strip())
        if len(self._chunks) >= self.buffer_chunks:
            return self.flush()
        return None

    def flush(self) -> Optional[str]:
        if not self._chunks:
            return None
        text = " ".join(self._chunks)
        self._chunks = []
        return self.model.translate(text)


class TTSModel:
    """Text → speech: SpeechT5's mel (:attr:`text_to_mel`, ``text → [T,
    80]`` numpy; None when SpeechT5 cannot be loaded) through
    ``vocoder_synth`` (``mel [1, 80, T] → wav``) when one is given, else
    through SpeechT5's HiFi-GAN; silence when there is no text or no
    SpeechT5."""

    def __init__(self, model_name: str = "microsoft/speecht5_tts",
                 vocoder_synth: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 sample_rate: int = 16_000, device: str | torch.device = "cuda"):
        self.model_name = model_name
        self.vocoder_synth = vocoder_synth
        self.sample_rate = sample_rate
        self.device = torch.device(device)
        self.text_to_mel: Optional[Callable[[str], np.ndarray]] = None
        try:
            from transformers import SpeechT5ForTextToSpeech, SpeechT5HifiGan, SpeechT5Processor

            self._processor = SpeechT5Processor.from_pretrained(model_name, **_hf_kwargs())
            self._model = SpeechT5ForTextToSpeech.from_pretrained(model_name, **_hf_kwargs()).to(self.device).eval()
            self._hf_vocoder = SpeechT5HifiGan.from_pretrained(
                "microsoft/speecht5_hifigan", **_hf_kwargs()).to(self.device).eval()
            self.text_to_mel = self._speecht5_mel
        except Exception as e:
            log.warning("TTS model %s unavailable (%s); synthesize → silence", model_name, e)

    @property
    def available(self) -> bool:
        return self.text_to_mel is not None

    def _speecht5_mel(self, text: str) -> np.ndarray:
        inputs = self._processor(text=text, return_tensors="pt")
        spk = torch.zeros((1, 512), device=self.device)
        with torch.no_grad():
            return self._model.generate_speech(inputs["input_ids"].to(self.device), spk).cpu().numpy()

    def synthesize(self, text: str) -> np.ndarray:
        if not text.strip() or self.text_to_mel is None:
            return np.zeros(0, np.float32)
        try:
            mel = np.asarray(self.text_to_mel(text), np.float32)  # [T, 80]
            if self.vocoder_synth is not None:
                return np.asarray(self.vocoder_synth(mel.T[None]))  # [1, 80, T]
            with torch.no_grad():
                wav = self._hf_vocoder(torch.from_numpy(mel).to(self.device))
            return wav.cpu().numpy().reshape(-1)
        except Exception:
            log.exception("TTS failed")
            return np.zeros(0, np.float32)


class StreamingTTS:
    """Buffer text chunks, then synthesize."""

    def __init__(self, tts: TTSModel, buffer_chunks: int = 2):
        self.tts = tts
        self.buffer_chunks = buffer_chunks
        self._chunks: List[str] = []

    def add_text_chunk(self, text: str) -> Optional[np.ndarray]:
        if text.strip():
            self._chunks.append(text.strip())
        if len(self._chunks) >= self.buffer_chunks:
            return self.flush()
        return None

    def flush(self) -> Optional[np.ndarray]:
        if not self._chunks:
            return None
        text = " ".join(self._chunks)
        self._chunks = []
        return self.tts.synthesize(text)


class AudioPostProcessor:
    """Resample, normalise, trim; WAV bytes."""

    def __init__(self, sample_rate: int = 16_000):
        self.sample_rate = sample_rate

    def process(self, audio: np.ndarray, src_rate: Optional[int] = None) -> np.ndarray:
        from hifigan_tpu_torch.app.audio import AudioProcessor

        return AudioProcessor(self.sample_rate).preprocess(audio, src_rate)

    def to_wav_bytes(self, audio: np.ndarray) -> bytes:
        from hifigan_tpu_torch.app.audio import float_to_wav_bytes

        return float_to_wav_bytes(audio, self.sample_rate)
