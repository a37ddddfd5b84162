"""Audio processing: VAD-gated utterance segmentation, preprocessing, WAV
codecs, a real-time ring buffer and chunking helpers.

Counterpart of ``hifigan_tpu/app/audio.py``, host numpy as there: an
energy and zero-crossing VAD over 30 ms frames whose speech/silence state
machine releases a buffered utterance after at least 0.5 s of speech
followed by at least 0.5 s of silence; preprocessing (linear resampling,
peak normalisation to 0.95, trimming of silent 10 ms frames); 16-bit PCM
WAV bytes to and from float; a fixed-capacity chunk ring buffer.
"""

from __future__ import annotations

import io
import wave
from collections import deque
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from hifigan_tpu_torch.streaming.features import resample_linear


@dataclass
class VADConfig:
    frame_ms: int = 30
    energy_threshold_db: float = -35.0
    zcr_threshold: float = 0.25
    min_speech_s: float = 0.5
    min_silence_s: float = 0.5


class AudioProcessor:
    """Utterance segmentation + preprocessing."""

    def __init__(self, sample_rate: int = 16_000, vad: VADConfig = VADConfig(),
                 max_duration_s: float = 30.0):
        self.sample_rate = sample_rate
        self.vad = vad
        self.max_duration_s = max_duration_s
        self._buffer: List[np.ndarray] = []
        self._speech_frames = 0
        self._silence_frames = 0
        self._in_speech = False

    # ---- VAD ----

    def is_speech_frame(self, frame: np.ndarray) -> bool:
        rms = float(np.sqrt(np.mean(frame.astype(np.float64) ** 2) + 1e-12))
        db = 20 * np.log10(rms + 1e-12)
        zcr = float(np.mean(np.abs(np.diff(np.signbit(frame).astype(np.int8)))))
        return db > self.vad.energy_threshold_db and zcr < self.vad.zcr_threshold

    def process_chunk(self, chunk: np.ndarray) -> Optional[np.ndarray]:
        """Feed samples; returns a complete utterance when the
        speech→silence state machine fires, else None."""
        frame_len = self.sample_rate * self.vad.frame_ms // 1000
        self._buffer.append(np.asarray(chunk, np.float32).reshape(-1))
        buf = np.concatenate(self._buffer)
        n_frames = len(buf) // frame_len
        min_speech = int(self.vad.min_speech_s * 1000 / self.vad.frame_ms)
        min_silence = int(self.vad.min_silence_s * 1000 / self.vad.frame_ms)
        speech = silence = 0
        for i in range(n_frames):
            if self.is_speech_frame(buf[i * frame_len : (i + 1) * frame_len]):
                speech += 1
                silence = 0
            else:
                silence += 1
        self._speech_frames = speech
        self._silence_frames = silence
        if speech >= min_speech and silence >= min_silence:
            self._buffer = []
            return self.preprocess(buf)
        if len(buf) > self.max_duration_s * self.sample_rate:
            self._buffer = []
            return self.preprocess(buf)
        return None

    # ---- preprocessing ----

    def preprocess(self, audio: np.ndarray, src_rate: Optional[int] = None) -> np.ndarray:
        """resample → peak-normalise → trim leading/trailing silence."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        if src_rate and src_rate != self.sample_rate:
            audio = resample_linear(audio, src_rate, self.sample_rate)
        peak = np.abs(audio).max()
        if peak > 0:
            audio = audio * (0.95 / peak)
        return self.trim_silence(audio)

    def trim_silence(self, audio: np.ndarray, threshold_db: float = -45.0) -> np.ndarray:
        frame = max(1, self.sample_rate // 100)
        n = len(audio) // frame
        if n == 0:
            return audio
        frames = audio[: n * frame].reshape(n, frame)
        db = 20 * np.log10(np.sqrt(np.mean(frames**2, axis=1)) + 1e-12)
        keep = np.where(db > threshold_db)[0]
        if keep.size == 0:
            return audio
        return audio[keep[0] * frame : (keep[-1] + 1) * frame]

    def reset(self):
        self._buffer = []
        self._speech_frames = self._silence_frames = 0


# ---- WAV codecs (stdlib) ----


def float_to_wav_bytes(audio: np.ndarray, sample_rate: int = 16_000) -> bytes:
    audio = np.clip(np.asarray(audio, np.float32).reshape(-1), -1, 1)
    pcm = (audio * 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def wav_bytes_to_float(data: bytes):
    with wave.open(io.BytesIO(data), "rb") as w:
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
        width = w.getsampwidth()
        channels = w.getnchannels()
    if width == 2:
        audio = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        audio = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        audio = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported width {width}")
    if channels > 1:
        audio = audio.reshape(-1, channels).mean(axis=1)
    return audio, sr


class RealTimeAudioStream:
    """Fixed-capacity chunk ring buffer (reference ``:215-263``)."""

    def __init__(self, max_chunks: int = 64):
        self._chunks: deque = deque(maxlen=max_chunks)

    def add_chunk(self, chunk: np.ndarray):
        self._chunks.append(np.asarray(chunk, np.float32).reshape(-1))

    def get_audio(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros(0, np.float32)
        return np.concatenate(list(self._chunks))

    def clear(self):
        self._chunks.clear()

    def __len__(self):
        return len(self._chunks)


def chunk_audio(audio: np.ndarray, chunk_size: int) -> List[np.ndarray]:
    """Split audio into fixed-size chunks (last one may be shorter)."""
    audio = np.asarray(audio).reshape(-1)
    return [audio[i : i + chunk_size] for i in range(0, len(audio), chunk_size)]
