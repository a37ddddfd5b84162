"""The simultaneous S2ST model: chunked Conformer, two CTC heads, the
simultaneous text decoder, the text-to-unit encoder, the learned READ/WRITE
transition head and the modified vocoder.

Counterpart of ``hifigan_tpu/models/streamspeech.py``, with its parameter
names.  Two optional parts follow the parameter trees the JAX package
makes: a model initialised by its S2ST trainer has the transition head and
no vocoder (``with_vocoder=False``), one initialised by ``cli simulate``
without a checkpoint has the vocoder and no transition head
(``with_transition_head=False``).  The streaming runtime calls neither.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from hifigan_tpu_torch.models.conformer import ChunkedConformer
from hifigan_tpu_torch.models.generator import GeneratorConfig
from hifigan_tpu_torch.models.layers import (
    Dense,
    Embed,
    TransformerDecoderLayer,
    _const,
    _normal,
    causal_mask,
    sinusoidal_positions,
)
from hifigan_tpu_torch.models.vocoder import ModifiedVocoder
from hifigan_tpu_torch.ops import conv as conv_ops

# The forward-semantics revision of the JAX package's StreamSpeech: a
# checkpoint's streamspeech_config.json records the revision it was trained
# under, and a config of another revision is refused
# (weights.load_streamspeech_config).
FEATURE_REV = 2


@dataclass(frozen=True)
class StreamSpeechConfig:
    input_dim: int = 80
    hidden_dim: int = 512
    encoder_layers: int = 12
    decoder_layers: int = 6
    num_heads: int = 8
    vocab_size: int = 32_000
    unit_vocab_size: int = 1_000
    chunk_size: int = 32
    speaker_dim: int = 192
    emotion_dim: int = 256
    vocoder_hidden: int = 512
    vocoder_upsample: tuple = (8, 8, 2, 2)
    ecapa_channels: int = 512
    emo_hidden: int = 512
    emo_layers: int = 6

    def generator_config(self) -> GeneratorConfig:
        return GeneratorConfig(
            input_channels=self.input_dim,
            hidden_channels=self.vocoder_hidden,
            upsample_factors=self.vocoder_upsample,
            speaker_dim=self.speaker_dim,
            emotion_dim=self.emotion_dim,
        )


class CTCHead(nn.Module):
    """fp32 projection hidden → vocabulary."""

    def __init__(self, hidden_dim: int, vocab_size: int, *, gen: torch.Generator):
        super().__init__()
        self.proj = Dense(hidden_dim, vocab_size, gen)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.proj(h.float())


class SimultaneousTextDecoder(nn.Module):
    """Causal transformer decoder over the encoder memory: token embedding
    × √d + sinusoidal positions → post-norm decoder layers → fp32 output
    projection."""

    def __init__(self, hidden_dim: int, vocab_size: int, num_layers: int = 6, num_heads: int = 8,
                 max_len: int = 4096, dtype=torch.float32, *, gen: torch.Generator):
        super().__init__()
        self.hidden_dim, self.num_layers, self.num_heads, self.dtype = hidden_dim, num_layers, num_heads, dtype
        self.token_embedding = Embed(vocab_size, hidden_dim, gen)
        self.register_buffer("positions", torch.from_numpy(sinusoidal_positions(max_len, hidden_dim)),
                             persistent=False)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerDecoderLayer(hidden_dim, num_heads, 4 * hidden_dim, dtype,
                                                                  gen=gen))
        self.output_proj = Dense(hidden_dim, vocab_size, gen)

    def layer(self, i: int) -> TransformerDecoderLayer:
        return getattr(self, f"layer_{i}")

    def forward(self, memory: torch.Tensor, target_ids: torch.Tensor, cross_mask: torch.Tensor | None = None,
                return_features: bool = False):
        """``memory [B, S, D]``, ``target_ids [B, T]`` → logits ``[B, T,
        vocab]`` (and the pre-projection features ``[B, T, D]`` when
        ``return_features``)."""
        T = target_ids.shape[1]
        emb = self.token_embedding(target_ids) * math.sqrt(self.hidden_dim)
        x = (emb + self.positions[:T]).to(self.dtype)
        self_mask = causal_mask(T, x.device)
        memory = memory.to(self.dtype)
        for i in range(self.num_layers):
            x = self.layer(i)(x, memory, self_mask, cross_mask)
        logits = self.output_proj(x.float())
        return (logits, x) if return_features else logits


class TextToUnitEncoder(nn.Module):
    """Three stride-2 transposed convs (k 4, padding 1; 8× upsampling),
    each followed by ReLU, then an fp32 unit predictor."""

    def __init__(self, hidden_dim: int, unit_vocab_size: int, dtype=torch.float32, *, gen: torch.Generator):
        super().__init__()
        d = hidden_dim
        self.dtype = dtype
        for i in range(3):
            setattr(self, f"up_{i}_kernel", _normal(gen, 0.02, d, d, 4))
            setattr(self, f"up_{i}_bias", _const(0.0, d))
        self.unit_predictor = Dense(d, unit_vocab_size, gen)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        x = h.to(self.dtype)
        for i in range(3):
            x = conv_ops.conv_transpose1d(x, getattr(self, f"up_{i}_kernel").to(self.dtype),
                                          getattr(self, f"up_{i}_bias"), stride=2, padding=1)
            x = torch.relu(x)
        return self.unit_predictor(x.float())


class StreamSpeechS2ST(nn.Module):
    """The composed simultaneous S2ST system."""

    def __init__(self, config: StreamSpeechConfig = StreamSpeechConfig(), dtype=torch.float32, *,
                 gen: torch.Generator, with_vocoder: bool = True, with_transition_head: bool = True):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.encoder = ChunkedConformer(cfg.input_dim, cfg.hidden_dim, cfg.encoder_layers, cfg.num_heads,
                                        cfg.chunk_size, dtype=dtype, gen=gen)
        self.source_ctc = CTCHead(cfg.hidden_dim, cfg.vocab_size, gen=gen)
        self.target_ctc = CTCHead(cfg.hidden_dim, cfg.vocab_size, gen=gen)
        self.text_decoder = SimultaneousTextDecoder(cfg.hidden_dim, cfg.vocab_size, cfg.decoder_layers,
                                                    cfg.num_heads, dtype=dtype, gen=gen)
        self.t2u_encoder = TextToUnitEncoder(cfg.hidden_dim, cfg.unit_vocab_size, dtype, gen=gen)
        self.transition_head = Dense(cfg.hidden_dim, 1, gen) if with_transition_head else None
        self.vocoder = (ModifiedVocoder(cfg.generator_config(), cfg.ecapa_channels, cfg.emo_hidden, cfg.emo_layers,
                                        dtype=dtype, gen=gen) if with_vocoder else None)

    def forward(self, mel: torch.Tensor, target_ids: Optional[torch.Tensor] = None,
                speaker_emb: Optional[torch.Tensor] = None, emotion_emb: Optional[torch.Tensor] = None, *,
                chunked: bool = False, cross_mask: Optional[torch.Tensor] = None, run_vocoder: bool = True,
                decoder_units_out: bool = False) -> dict:
        """``mel [B, T, n_mels]``.  Returns the encoder output, both CTC
        heads' logits and the T2U unit logits; with ``target_ids`` the
        text logits (and with ``decoder_units_out`` the T2U logits over the
        decoder features and the transition head's write logits); with
        ``run_vocoder`` the vocoder's waveform and embeddings."""
        enc = self.encoder(mel, chunked=chunked)
        out = {
            "encoder_outputs": enc,
            "source_ctc_logits": self.source_ctc(enc),
            "target_ctc_logits": self.target_ctc(enc),
            "unit_logits": self.t2u_encoder(enc),
        }
        if target_ids is not None:
            if decoder_units_out:
                text_logits, feats = self.text_decoder(enc, target_ids, cross_mask, return_features=True)
                out["text_logits"] = text_logits
                out["decoder_unit_logits"] = self.t2u_encoder(feats)
                out["write_logits"] = self.transition_head(feats.detach().float())[..., 0]
            else:
                out["text_logits"] = self.text_decoder(enc, target_ids, cross_mask)
        if run_vocoder:
            voc = self.vocoder(mel.transpose(1, 2), speaker_emb, emotion_emb)
            out["generated_waveform"] = voc["waveform"]
            out["speaker_embedding"] = voc["speaker_embedding"]
            out["emotion_embedding"] = voc["emotion_embedding"]
        return out

    def decoder_units(self, memory: torch.Tensor, target_ids: torch.Tensor,
                      cross_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Unit logits ``[B, 8·L, unit_vocab]`` from the text decoder's
        features (the decoder-fed T2U path)."""
        _, feats = self.text_decoder(memory, target_ids, cross_mask, return_features=True)
        return self.t2u_encoder(feats)

    def decoder_scores(self, memory: torch.Tensor, target_ids: torch.Tensor,
                       cross_mask: Optional[torch.Tensor] = None):
        """(text logits, write logits) in one decoder pass."""
        logits, feats = self.text_decoder(memory, target_ids, cross_mask, return_features=True)
        return logits, self.transition_head(feats.float())[..., 0]

    def streaming_forward(self, mel_chunk: torch.Tensor, speaker_emb: Optional[torch.Tensor] = None,
                          emotion_emb: Optional[torch.Tensor] = None) -> dict:
        """The per-chunk variant: chunked encoder, heads and vocoder, no
        text decoder."""
        enc = self.encoder(mel_chunk, chunked=True)
        voc = self.vocoder(mel_chunk.transpose(1, 2), speaker_emb, emotion_emb)
        return {
            "encoder_outputs": enc,
            "source_ctc_logits": self.source_ctc(enc),
            "target_ctc_logits": self.target_ctc(enc),
            "unit_logits": self.t2u_encoder(enc),
            "generated_waveform": voc["waveform"],
        }
