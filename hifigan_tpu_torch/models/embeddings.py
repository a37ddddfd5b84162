"""Conditioning encoders: ECAPA-TDNN (speaker, 192-d) and Emotion2Vec
(emotion, 256-d), and the extractor that runs both on one mel.

Counterpart of ``hifigan_tpu/models/embeddings.py``.  The classifier heads
are optional submodules named ``classifier`` (JAX's leaf paths): ECAPA-TDNN
has one when built with ``num_speakers``, Emotion2Vec when built with
``num_emotions``, and ``forward(..., train=True)`` returns their logits as
the JAX modules' ``train=True`` does.  Activations run channels-last ``[B, T, C]``; ``dtype``
is the compute dtype, and the parts the JAX package runs in fp32 (the SE
gate, attentive statistics pooling, the embedding heads and their
LayerNorm) run in fp32 here too.  The convolutions, matmuls and attention
are plain PyTorch calls, as they are plain XLA ops in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hifigan_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    TransformerEncoderLayer,
    _const,
    _normal,
    sinusoidal_positions,
)
from hifigan_tpu_torch.ops import conv as conv_ops

MAX_POSITIONS = 4096  # rows of Emotion2Vec's positional table, the JAX default


def _channels_last(mel: torch.Tensor, n_mels: int) -> torch.Tensor:
    """``[B, n_mels, T]`` → ``[B, T, n_mels]``; a mel whose last dim is
    ``n_mels`` (``T == n_mels`` included) is taken as channels-last already,
    the JAX package's rule."""
    if mel.shape[1] == n_mels and mel.shape[-1] != n_mels:
        return mel.transpose(1, 2)
    return mel


class SEModule(nn.Module):
    """Squeeze-excitation: the time-mean in fp32 → fp32 Dense → ReLU → fp32
    Dense → sigmoid gate, applied in fp32 and cast back to ``x.dtype``."""

    def __init__(self, channels: int, bottleneck: int = 128, *, gen: torch.Generator):
        super().__init__()
        self.fc1 = Dense(channels, bottleneck, gen)
        self.fc2 = Dense(bottleneck, channels, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean(dim=1)
        gate = torch.sigmoid(self.fc2(torch.relu(self.fc1(s))))[:, None, :]
        return (x.float() * gate).to(x.dtype)


class SERes2Block(nn.Module):
    """SE-Res2Net block: 1×1 → ReLU → LayerNorm → Res2Net split-scale conv
    chain → 1×1 → ReLU → LayerNorm → SE → + residual.

    The channels split into ``scale`` groups; group i ≥ 1 is convolved with
    ``res2_kernel_{i}`` ``[k, width, width]`` after adding group i−1's
    output (group 1 alone); group 0 passes through."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: int = 1, scale: int = 8,
                 dtype=torch.float32, *, gen: torch.Generator):
        super().__init__()
        width = channels // scale
        self.scale, self.dilation, self.dtype = scale, dilation, dtype
        self.pad = (kernel_size - 1) * dilation // 2
        self.conv1x1_in = Dense(channels, channels, gen, dtype=dtype)
        self.norm_in = LayerNorm(channels)
        for i in range(1, scale):
            setattr(self, f"res2_kernel_{i}", _normal(gen, 0.02, kernel_size, width, width))
            setattr(self, f"res2_bias_{i}", _const(0.0, width))
        self.conv1x1_out = Dense(channels, channels, gen, dtype=dtype)
        self.norm_out = LayerNorm(channels)
        self.se = SEModule(channels, gen=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = self.norm_in(torch.relu(self.conv1x1_in(x))).to(dt)
        splits = h.chunk(self.scale, dim=-1)
        outs, prev = [splits[0]], None
        for i in range(1, self.scale):
            inp = splits[i] if prev is None else splits[i] + prev
            prev = torch.relu(conv_ops.conv1d(inp, getattr(self, f"res2_kernel_{i}"),
                                              getattr(self, f"res2_bias_{i}"),
                                              padding=self.pad, dilation=self.dilation))
            outs.append(prev)
        h = self.norm_out(torch.relu(self.conv1x1_out(torch.cat(outs, dim=-1)))).to(dt)
        return self.se(h) + x


class AttentiveStatsPooling(nn.Module):
    """Softmax attention over time, per channel, in fp32; returns
    ``concat(weighted mean, weighted std)``, the variance clipped at 1e-9."""

    def __init__(self, channels: int, attention_channels: int = 128, *, gen: torch.Generator):
        super().__init__()
        self.att1 = Dense(channels, attention_channels, gen)
        self.att2 = Dense(attention_channels, channels, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        w = torch.softmax(self.att2(torch.tanh(self.att1(xf))), dim=1)
        mean = (w * xf).sum(dim=1)
        var = (w * xf.square()).sum(dim=1) - mean.square()
        return torch.cat([mean, var.clamp_min(1e-9).sqrt()], dim=-1)


class EcapaTdnn(nn.Module):
    """Mel-input ECAPA-TDNN speaker encoder → L2-normalised embedding.

    ``forward(mel)``: ``[B, n_mels, T]`` or ``[B, T, n_mels]`` (see
    :func:`_channels_last`) → ``[B, embedding_dim]`` fp32;
    ``forward(mel, train=True)`` with a head (``num_speakers``) → ``(emb,
    logits [B, num_speakers])``, the fp32 Dense on the unit embedding."""

    def __init__(self, n_mels: int = 80, channels: int = 512, embedding_dim: int = 192,
                 dtype=torch.float32, *, gen: torch.Generator, num_speakers: int | None = None):
        super().__init__()
        self.n_mels, self.dtype = n_mels, dtype
        self.stem_kernel = _normal(gen, 0.02, 5, n_mels, channels)
        self.stem_bias = _const(0.0, channels)
        self.stem_norm = LayerNorm(channels)
        for i, d in enumerate((2, 3, 4)):
            self.add_module(f"block_{i}", SERes2Block(channels, 3, d, dtype=dtype, gen=gen))
        self.expand = Dense(3 * channels, 3 * channels, gen, dtype=dtype)
        self.asp = AttentiveStatsPooling(3 * channels, gen=gen)
        self.embed = Dense(6 * channels, embedding_dim, gen)
        self.embed_norm = LayerNorm(embedding_dim)
        self.classifier = Dense(embedding_dim, num_speakers, gen) if num_speakers else None

    def forward(self, mel: torch.Tensor, train: bool = False):
        dt = self.dtype
        x = _channels_last(mel, self.n_mels).to(dt)
        x = torch.relu(conv_ops.conv1d(x, self.stem_kernel, self.stem_bias, padding=2))
        x = self.stem_norm(x).to(dt)
        feats = []
        for i in range(3):
            x = getattr(self, f"block_{i}")(x)
            feats.append(x)
        x = torch.relu(self.expand(torch.cat(feats, dim=-1)))
        emb = self.embed_norm(self.embed(self.asp(x)))
        emb = emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-9)
        if train and self.classifier is not None:
            return emb, self.classifier(emb)
        return emb


class Emotion2Vec(nn.Module):
    """Mel-input Emotion2Vec emotion encoder → L2-normalised utterance
    embedding ``[B, embedding_dim]`` fp32.

    Per-utterance CMVN over time and mels (population std) → 3 convs
    (k = 3) with tanh-approximated GELU → per-frame normalisation → + 0.3 ·
    sinusoidal positions → ``num_layers`` post-norm encoder layers → fp32
    frame projection → time mean → L2 normalisation.  ``return_frames``
    adds the projected frames ``[B, T, embedding_dim]`` after the utterance
    embedding; ``train=True`` (a head: ``num_emotions``) adds the logits of
    the fp32 Dense on the utterance embedding last."""

    def __init__(self, n_mels: int = 80, hidden_dim: int = 512, embedding_dim: int = 256,
                 num_layers: int = 6, num_heads: int = 8, dtype=torch.float32, *, gen: torch.Generator,
                 num_emotions: int | None = None):
        super().__init__()
        self.n_mels, self.num_layers, self.dtype = n_mels, num_layers, dtype
        cin = n_mels
        for i, ch in enumerate((256, 384, hidden_dim)):
            setattr(self, f"fe_{i}_kernel", _normal(gen, 0.02, 3, cin, ch))
            setattr(self, f"fe_{i}_bias", _const(0.0, ch))
            cin = ch
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(
                hidden_dim, num_heads, 4 * hidden_dim, dtype, gen=gen))
        self.frame_proj = Dense(hidden_dim, embedding_dim, gen)
        self.classifier = Dense(embedding_dim, num_emotions, gen) if num_emotions else None
        self.register_buffer("positions", torch.from_numpy(sinusoidal_positions(MAX_POSITIONS, hidden_dim)),
                             persistent=False)

    def forward(self, mel: torch.Tensor, train: bool = False, return_frames: bool = False):
        dt = self.dtype
        mf = _channels_last(mel, self.n_mels).float()
        sd = mf.std(dim=(1, 2), keepdim=True, correction=0).clamp_min(1e-5)
        x = ((mf - mf.mean(dim=(1, 2), keepdim=True)) / sd).to(dt)
        for i in range(3):
            x = conv_ops.conv1d(x, getattr(self, f"fe_{i}_kernel"), getattr(self, f"fe_{i}_bias"), padding=1)
            x = F.gelu(x, approximate="tanh")
        xf = x.float()
        fsd = xf.std(dim=-1, keepdim=True, correction=0).clamp_min(1e-5)
        x = ((xf - xf.mean(dim=-1, keepdim=True)) / fsd).to(dt)
        x = x + 0.3 * self.positions[: x.shape[1]].to(dt)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        frames = self.frame_proj(x.float())
        utt = frames.mean(dim=1)
        utt = utt / utt.norm(dim=-1, keepdim=True).clamp_min(1e-9)
        out = (utt, frames) if return_frames else (utt,)
        if train:
            if self.classifier is None:
                raise ValueError("train=True needs the classifier head: build Emotion2Vec with num_emotions")
            out += (self.classifier(utt),)
        return out if len(out) > 1 else utt


class EmbeddingExtractor(nn.Module):
    """``mel → (speaker [B, speaker_dim], emotion [B, emotion_dim])``."""

    def __init__(self, speaker_dim: int = 192, emotion_dim: int = 256, n_mels: int = 80,
                 ecapa_channels: int = 512, emo_hidden: int = 512, emo_layers: int = 6,
                 emo_heads: int = 8, dtype=torch.float32, *, gen: torch.Generator):
        super().__init__()
        self.ecapa = EcapaTdnn(n_mels, ecapa_channels, speaker_dim, dtype, gen=gen)
        self.emotion2vec = Emotion2Vec(n_mels, emo_hidden, emotion_dim, emo_layers, emo_heads, dtype, gen=gen)

    def forward(self, mel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.ecapa(mel), self.emotion2vec(mel)
