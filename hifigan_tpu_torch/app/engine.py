"""The cascade translation engine (ASR → MT → TTS → vocoder).

Counterpart of ``hifigan_tpu/app/engine.py``: :class:`TranslationResult`,
:class:`TranslationMode`, the full-utterance cascade ``translate_audio``
with per-stage callbacks and wall-clock timing, ``translate_text``,
``synthesize_text``, the streaming cascade ``process_streaming_audio`` over
the three stage buffers, ``flush_streaming_buffers``, ``switch_languages``,
``get_model_info`` and :class:`TranslationEngineFactory`.

The TTS stage's mel goes through the port's own vocoder
(:func:`make_vocoder_synth`: the trained generator of a train-state
directory, bf16 by default, the GRC kernel on the card) when the engine is
given ``vocoder_checkpoint``.  Everything runs on ``device``, the card
unless the caller passes ``"cpu"``.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from hifigan_tpu_torch.app.audio import AudioProcessor
from hifigan_tpu_torch.app.models import (
    ASRModelFactory,
    AudioPostProcessor,
    StreamingASR,
    StreamingTranslator,
    StreamingTTS,
    TranslationPipeline,
    TTSModel,
)
from hifigan_tpu_torch.entry import resolve_device
from hifigan_tpu_torch.ops.cuda.grc_kernel import grc_step


class TranslationMode(enum.Enum):
    FULL = "full"
    STREAMING = "streaming"
    TEXT_ONLY = "text_only"


@dataclass
class TranslationResult:
    source_text: str = ""
    translated_text: str = ""
    audio: Optional[np.ndarray] = None
    source_lang: str = "en"
    target_lang: str = "es"
    processing_time: float = 0.0
    mode: TranslationMode = TranslationMode.FULL


class VocoderSynth:
    """``mel [B, 80, T]`` numpy → the first row's waveform ``[256·T]`` fp32
    numpy, through ``generator`` with zero speaker and emotion embeddings.
    ``step`` is the GRC chain step (the kernel by default)."""

    def __init__(self, generator):
        self.generator = generator
        self.device = next(generator.parameters()).device

    def __call__(self, mel_np: np.ndarray, *, step=grc_step) -> np.ndarray:
        cfg = self.generator.config
        mel = torch.as_tensor(np.asarray(mel_np, np.float32), device=self.device)
        b = mel.shape[0]
        spk = torch.zeros((b, cfg.speaker_dim), device=self.device)
        emo = torch.zeros((b, cfg.emotion_dim), device=self.device)
        with torch.no_grad():
            wav = self.generator(mel, spk, emo, step=step)
        return wav[0, 0].cpu().numpy()


def make_vocoder_synth(checkpoint_dir: Optional[str] = None, dtype: Optional[torch.dtype] = None,
                       device: str | torch.device = "cuda") -> Optional[VocoderSynth]:
    """The mel → wav synth of the newest ``<step>.pt`` train state in
    ``checkpoint_dir`` (``create_train_state(TrainConfig())``'s, as
    :class:`~hifigan_tpu_torch.train.checkpoint.CheckpointManager` writes
    it): its generator, computing in ``dtype`` (bf16 by default) on
    ``device``.  Only the generator's weights are read from the file.  None
    without a directory (the TTS then uses SpeechT5's own vocoder); a
    directory with no checkpoint raises ``FileNotFoundError``."""
    if checkpoint_dir is None:
        return None
    from hifigan_tpu_torch.models.generator import Generator
    from hifigan_tpu_torch.train import TrainConfig
    from hifigan_tpu_torch.train.checkpoint import CheckpointManager

    device = resolve_device(device)
    saved = CheckpointManager(checkpoint_dir).load(map_location="cpu")["vocoder"]
    prefix = "generator."
    model = Generator(TrainConfig().generator, dtype or torch.bfloat16, gen=torch.Generator().manual_seed(0))
    model.load_state_dict({k[len(prefix):]: v for k, v in saved.items() if k.startswith(prefix)})
    return VocoderSynth(model.to(device).eval())


class RealTimeTranslationEngine:
    def __init__(
        self,
        source_lang: str = "en",
        target_lang: str = "es",
        *,
        vocoder_checkpoint: Optional[str] = None,
        load_models: bool = True,
        asr_buffer: int = 5,
        mt_buffer: int = 3,
        tts_buffer: int = 2,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.source_lang = source_lang
        self.target_lang = target_lang
        self.audio_processor = AudioProcessor()
        self.post = AudioPostProcessor()
        self._buffers = (asr_buffer, mt_buffer, tts_buffer)
        self._vocoder_checkpoint = vocoder_checkpoint
        self._vocoder_synth: Optional[VocoderSynth] = None
        if load_models:
            self._load_models()

    def _load_models(self):
        self.asr = ASRModelFactory.create(self.source_lang, self.device)
        self.mt = TranslationPipeline(self.source_lang, self.target_lang, device=self.device)
        if self._vocoder_synth is None:  # built once: it does not depend on the languages
            self._vocoder_synth = make_vocoder_synth(self._vocoder_checkpoint, device=self.device)
        self.tts = TTSModel(vocoder_synth=self._vocoder_synth, device=self.device)
        a, m, t = self._buffers
        self.streaming_asr = StreamingASR(self.asr, a)
        self.streaming_mt = StreamingTranslator(self.mt.forward, m)
        self.streaming_tts = StreamingTTS(self.tts, t)

    # ---- full-utterance cascade ----

    def translate_audio(
        self,
        audio: np.ndarray,
        src_rate: Optional[int] = None,
        on_transcript: Optional[Callable[[str], None]] = None,
        on_translation: Optional[Callable[[str], None]] = None,
    ) -> TranslationResult:
        t0 = time.time()
        clean = self.audio_processor.preprocess(audio, src_rate)
        text = self.asr.transcribe(clean)
        if on_transcript:
            on_transcript(text)
        translated = self.mt.translate(text) if text else ""
        if on_translation:
            on_translation(translated)
        wav = self.tts.synthesize(translated) if translated else np.zeros(0, np.float32)
        if wav.size:
            wav = self.post.process(wav)
        return TranslationResult(
            source_text=text,
            translated_text=translated,
            audio=wav,
            source_lang=self.source_lang,
            target_lang=self.target_lang,
            processing_time=time.time() - t0,
            mode=TranslationMode.FULL,
        )

    def translate_text(self, text: str) -> TranslationResult:
        t0 = time.time()
        translated = self.mt.translate(text)
        return TranslationResult(
            source_text=text,
            translated_text=translated,
            source_lang=self.source_lang,
            target_lang=self.target_lang,
            processing_time=time.time() - t0,
            mode=TranslationMode.TEXT_ONLY,
        )

    def synthesize_text(self, text: str) -> TranslationResult:
        t0 = time.time()
        wav = self.tts.synthesize(text)
        return TranslationResult(
            translated_text=text,
            audio=wav,
            processing_time=time.time() - t0,
            mode=TranslationMode.FULL,
        )

    # ---- streaming cascade ----

    def process_streaming_audio(self, chunk: np.ndarray) -> TranslationResult:
        t0 = time.time()
        result = TranslationResult(source_lang=self.source_lang, target_lang=self.target_lang,
                                   mode=TranslationMode.STREAMING)
        text = self.streaming_asr.add_audio_chunk(chunk)
        if text:
            result.source_text = text
            translated = self.streaming_mt.add_text_chunk(text)
            if translated:
                result.translated_text = translated
                wav = self.streaming_tts.add_text_chunk(translated)
                if wav is not None and wav.size:
                    result.audio = wav
        result.processing_time = time.time() - t0
        return result

    def flush_streaming_buffers(self) -> TranslationResult:
        t0 = time.time()
        result = TranslationResult(source_lang=self.source_lang, target_lang=self.target_lang,
                                   mode=TranslationMode.STREAMING)
        text = self.streaming_asr.flush()
        if text:
            result.source_text = text
            translated = self.streaming_mt.model.translate(text)
            if translated:
                result.translated_text = translated
        pending = self.streaming_mt.flush()
        if pending:
            result.translated_text = (result.translated_text + " " + pending).strip()
        if result.translated_text:
            wav = self.streaming_tts.tts.synthesize(result.translated_text)
            if wav.size:
                result.audio = wav
        leftover = self.streaming_tts.flush()
        if leftover is not None and leftover.size and result.audio is None:
            result.audio = leftover
        result.processing_time = time.time() - t0
        return result

    def switch_languages(self):
        """Swap the direction and reload the models (the vocoder is kept)."""
        self.source_lang, self.target_lang = self.target_lang, self.source_lang
        self._load_models()

    def get_model_info(self) -> dict:
        return {
            "source_lang": self.source_lang,
            "target_lang": self.target_lang,
            "asr": {"model": self.asr.model_name, "available": self.asr.available},
            "mt": {"model": self.mt.forward.model_name, "available": self.mt.forward.available},
            "tts": {"model": self.tts.model_name, "available": self.tts.available,
                    "uses_framework_vocoder": self.tts.vocoder_synth is not None},
        }


class TranslationEngineFactory:
    _cache: dict = {}

    @classmethod
    def create(cls, source_lang: str = "en", target_lang: str = "es", **kw):
        key = (source_lang, target_lang, tuple(sorted(kw.items())))
        if key not in cls._cache:
            cls._cache[key] = RealTimeTranslationEngine(source_lang, target_lang, **kw)
        return cls._cache[key]
