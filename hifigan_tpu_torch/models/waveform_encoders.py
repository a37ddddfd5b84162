"""Waveform-input conditioning encoders and speaker-verification helpers.

Counterpart of ``hifigan_tpu/models/waveform_encoders.py``:

* :func:`extract_mel_features`: peak-normalised audio → ``[frames, n_mels]``
  log-mel (the port's ``ops/stft.py``);
* :class:`WaveformEcapaTdnn`: 5 dilated TDNN convs (hidden 1024), each
  with ReLU and LayerNorm, softmax attention pooling → a 192-d
  L2-normalised embedding;
* :class:`SpeakerEncoder`: audio → speaker embedding, from the port's own
  checkpoint file (:func:`hifigan_tpu_torch.weights.save_jax_speaker_encoder`
  writes one from JAX's params), else SpeechBrain's pretrained ECAPA where
  ``speechbrain`` imports, else a seeded native encoder;
* :func:`calculate_speaker_similarity` and :func:`verify_speaker_identity`
  (cosine, 0.7 threshold);
* :class:`Wav2Vec2Emotion`: a frozen HF wav2vec2 backbone → mean-pool → an
  8-way emotion classifier and a 384-d projection, read from local files
  only unless ``HIFIGAN_TPU_ALLOW_DOWNLOADS`` is set; without the weights,
  the native mel-input ``Emotion2Vec`` with its classifier head.

The encoders run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from hifigan_tpu_torch.entry import resolve_device
from hifigan_tpu_torch.models.embeddings import Emotion2Vec
from hifigan_tpu_torch.models.layers import Dense, LayerNorm, _const, _normal
from hifigan_tpu_torch.ops import conv as conv_ops
from hifigan_tpu_torch.ops.stft import MelConfig, log_mel_spectrogram

log = logging.getLogger(__name__)

EMOTION_LABELS = (
    "neutral", "happy", "sad", "angry",
    "fearful", "disgusted", "surprised", "excited",
)

TDNN_SPECS = ((5, 1), (3, 2), (3, 3), (1, 1), (1, 1))  # (kernel, dilation) of each TDNN layer


def extract_mel_features(audio: np.ndarray, sample_rate: int = 16_000, cfg: Optional[MelConfig] = None,
                         device: str | torch.device = "cuda") -> np.ndarray:
    """``waveform → [n_frames, n_mels]`` fp32 log-mel of the peak-normalised
    audio, computed on ``device``."""
    cfg = cfg or MelConfig(sample_rate=sample_rate)
    audio = np.asarray(audio, np.float32).reshape(1, -1)
    peak = np.abs(audio).max()
    if peak > 0:
        audio = audio / peak
    mel = log_mel_spectrogram(torch.from_numpy(audio).to(resolve_device(device)), cfg)
    return mel[0].cpu().numpy()


class WaveformEcapaTdnn(nn.Module):
    """TDNN speaker encoder over mel features: ``mel [B, T, n_mels]`` or
    ``[B, n_mels, T]`` → ``[B, embedding_dim]`` fp32, unit norm."""

    def __init__(self, n_mels: int = 80, hidden: int = 1024, embedding_dim: int = 192, dtype=torch.float32,
                 *, gen: torch.Generator):
        super().__init__()
        self.n_mels, self.dtype = n_mels, dtype
        ch = n_mels
        for i, (k, _) in enumerate(TDNN_SPECS):
            setattr(self, f"tdnn_{i}_kernel", _normal(gen, 0.02, k, ch, hidden))
            setattr(self, f"tdnn_{i}_bias", _const(0.0, hidden))
            self.add_module(f"ln_{i}", LayerNorm(hidden))
            ch = hidden
        self.att = Dense(hidden, 1, gen)
        self.proj = Dense(hidden, embedding_dim, gen)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        if mel.shape[1] == self.n_mels and mel.shape[-1] != self.n_mels:
            mel = mel.transpose(1, 2)
        dt = self.dtype
        x = mel.to(dt)
        for i, (k, d) in enumerate(TDNN_SPECS):
            x = torch.relu(conv_ops.conv1d(x, getattr(self, f"tdnn_{i}_kernel").to(dt),
                                           getattr(self, f"tdnn_{i}_bias"), padding=(k - 1) * d // 2, dilation=d))
            x = getattr(self, f"ln_{i}")(x).to(dt)
        xf = x.float()
        weights = torch.softmax(self.att(xf), dim=1)
        emb = self.proj((weights * xf).sum(dim=1))
        return emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-9)


class SpeakerEncoder:
    """Waveform → 192-d unit speaker embedding (numpy), with the JAX
    package's preference: the checkpoint file at ``checkpoint_path`` →
    SpeechBrain's pretrained ECAPA → the seeded native encoder."""

    def __init__(self, checkpoint_path: Optional[str] = None, mel_cfg: Optional[MelConfig] = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.mel_cfg = mel_cfg or MelConfig()
        self.backend = "native"
        self._sb_model = None
        if checkpoint_path and os.path.exists(checkpoint_path):
            self._init_native(seed, checkpoint_path)
        else:
            try:
                from speechbrain.pretrained import EncoderClassifier

                self._sb_model = EncoderClassifier.from_hparams(source="speechbrain/spkrec-ecapa-voxceleb",
                                                                run_opts={"device": str(self.device)})
                self.backend = "speechbrain"
            except Exception:  # speechbrain missing or its weights unreachable: the native encoder
                self._init_native(seed, None)

    def _init_native(self, seed: int, checkpoint_path: Optional[str]) -> None:
        self.model = WaveformEcapaTdnn(n_mels=self.mel_cfg.n_mels, gen=torch.Generator().manual_seed(seed))
        if checkpoint_path:
            from hifigan_tpu_torch.weights import load_speaker_encoder_checkpoint

            try:
                self.model = load_speaker_encoder_checkpoint(checkpoint_path, "cpu")
            except Exception as e:  # an unreadable or mismatched file: the seeded encoder, as in JAX
                log.warning("speaker checkpoint %s failed (%s); random init", checkpoint_path, e)
        self.model = self.model.to(self.device).eval()

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        if self._sb_model is not None:
            emb = self._sb_model.encode_batch(torch.from_numpy(np.asarray(audio, np.float32))[None].to(self.device))
            e = emb.squeeze().cpu().numpy()
            return e / (np.linalg.norm(e) + 1e-9)
        mel = extract_mel_features(audio, self.mel_cfg.sample_rate, self.mel_cfg, self.device)
        with torch.no_grad():
            return self.model(torch.from_numpy(mel[None]).to(self.device))[0].cpu().numpy()

    def extract_batch(self, audios: List[np.ndarray]) -> np.ndarray:
        return np.stack([self(a) for a in audios])


def calculate_speaker_similarity(emb_a: np.ndarray, emb_b: np.ndarray) -> float:
    """Cosine similarity of two embeddings."""
    a, b = np.asarray(emb_a).reshape(-1), np.asarray(emb_b).reshape(-1)
    return float(a @ b / ((np.linalg.norm(a) * np.linalg.norm(b)) + 1e-9))


def verify_speaker_identity(emb_a: np.ndarray, emb_b: np.ndarray, threshold: float = 0.7) -> Tuple[bool, float]:
    """``(same speaker, cosine)``: the same speaker at a cosine of at least
    ``threshold``."""
    sim = calculate_speaker_similarity(emb_a, emb_b)
    return sim >= threshold, sim


def _allow_downloads() -> bool:
    return os.environ.get("HIFIGAN_TPU_ALLOW_DOWNLOADS", "").lower() in ("1", "true")


class Wav2Vec2Emotion:
    """wav2vec2-backed emotion encoder: frozen backbone → mean-pool → 8-way
    classifier and ``embedding_dim`` projection (seeded numpy heads).
    Without the HF weights, the native ``Emotion2Vec`` (embedding
    ``embedding_dim``, 8 emotions) over the audio's log-mel."""

    def __init__(self, model_name: str = "facebook/wav2vec2-base", embedding_dim: int = 384, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.embedding_dim = embedding_dim
        self.backend = "native"
        self._hf = None
        try:
            from transformers import Wav2Vec2Model

            kw = {} if _allow_downloads() else {"local_files_only": True}
            self._hf = Wav2Vec2Model.from_pretrained(model_name, **kw).to(self.device).eval()
            hidden = self._hf.config.hidden_size
            g = np.random.default_rng(seed)
            self._cls_w = g.normal(0, 0.02, (hidden, len(EMOTION_LABELS))).astype(np.float32)
            self._proj_w = g.normal(0, 0.02, (hidden, embedding_dim)).astype(np.float32)
            self.backend = "wav2vec2"
        except Exception:  # transformers missing or the weights unreachable: the native encoder
            self._model = Emotion2Vec(embedding_dim=embedding_dim, num_emotions=len(EMOTION_LABELS),
                                      gen=torch.Generator().manual_seed(seed)).to(self.device).eval()

    def __call__(self, audio: np.ndarray) -> dict:
        """→ ``{"embedding": [embedding_dim], "logits": [8], "label": str}``."""
        if self._hf is not None:
            with torch.no_grad():
                h = self._hf(torch.from_numpy(np.asarray(audio, np.float32))[None].to(self.device)).last_hidden_state
            pooled = h.mean(dim=1).cpu().numpy()[0]
            logits = pooled @ self._cls_w
            emb = pooled @ self._proj_w
        else:
            mel = extract_mel_features(audio, device=self.device)
            with torch.no_grad():
                emb_t, logits_t = self._model(torch.from_numpy(mel.T[None]).to(self.device), train=True)
            emb, logits = emb_t[0].cpu().numpy(), logits_t[0].cpu().numpy()
            if emb.shape[-1] != self.embedding_dim:
                emb = np.resize(emb, self.embedding_dim)
        emb = emb / (np.linalg.norm(emb) + 1e-9)
        return {"embedding": emb, "logits": logits, "label": EMOTION_LABELS[int(np.argmax(logits))]}

    def extract_batch(self, audios: List[np.ndarray]) -> np.ndarray:
        return np.stack([self(a)["embedding"] for a in audios])


def load_speaker_encoder(checkpoint_path: Optional[str] = None, device: str | torch.device = "cuda") -> SpeakerEncoder:
    return SpeakerEncoder(checkpoint_path, device=device)


def load_emotion2vec_model(model_name: str = "facebook/wav2vec2-base",
                           device: str | torch.device = "cuda") -> Wav2Vec2Emotion:
    return Wav2Vec2Emotion(model_name, device=device)


def extract_speaker_embeddings(encoder: SpeakerEncoder, audios: List[np.ndarray]) -> np.ndarray:
    return encoder.extract_batch(audios)


def extract_emotion_embeddings(model: Wav2Vec2Emotion, audios: List[np.ndarray]) -> np.ndarray:
    return model.extract_batch(audios)
