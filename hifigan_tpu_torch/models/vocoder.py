"""The vocoder facade: the generator plus the embedding extractor.

Counterpart of ``hifigan_tpu/models/vocoder.py::ModifiedVocoder``, the
voice-cloning API: a speaker and an emotion embedding not supplied are
extracted by ECAPA-TDNN and Emotion2Vec from ``reference_mel`` when one is
given (clone that clip's voice onto ``mel``'s content), else from ``mel``;
the generator then synthesises ``mel`` under them.  The parameter tree is
the JAX one (``embedding_extractor`` and ``generator``), whichever call
form is used.
"""

from __future__ import annotations

import torch
from torch import nn

from hifigan_tpu_torch.models.embeddings import EmbeddingExtractor
from hifigan_tpu_torch.models.generator import Generator, GeneratorConfig
from hifigan_tpu_torch.ops.cuda.grc_kernel import grc_step


class ModifiedVocoder(nn.Module):
    """``forward(mel [B, n_mels, T], speaker_emb?, emotion_emb?,
    reference_mel?) → {"waveform": [B, 1, 256·T], "speaker_embedding",
    "emotion_embedding"}``."""

    def __init__(self, config: GeneratorConfig = GeneratorConfig(), ecapa_channels: int = 512,
                 emo_hidden: int = 512, emo_layers: int = 6, emo_heads: int = 8,
                 dtype=torch.float32, *, gen: torch.Generator):
        super().__init__()
        self.embedding_extractor = EmbeddingExtractor(
            config.speaker_dim, config.emotion_dim, config.input_channels, ecapa_channels,
            emo_hidden, emo_layers, emo_heads, dtype, gen=gen)
        self.generator = Generator(config, dtype, gen=gen)

    def forward(self, mel, speaker_emb=None, emotion_emb=None, reference_mel=None, *, step=grc_step) -> dict:
        """The extractor runs when either embedding is ``None``; an embedding
        supplied overrides the extracted one.  ``step`` goes to
        :meth:`Generator.forward` (``grc_step_reference`` runs the plain
        path on a card).  The extractor is a profiler range named
        ``embedding_extractor``."""
        if speaker_emb is None or emotion_emb is None:
            with torch.profiler.record_function("embedding_extractor"):
                ext_spk, ext_emo = self.embedding_extractor(mel if reference_mel is None else reference_mel)
            speaker_emb = ext_spk if speaker_emb is None else speaker_emb
            emotion_emb = ext_emo if emotion_emb is None else emotion_emb
        wav = self.generator(mel, speaker_emb, emotion_emb, step=step)
        return {"waveform": wav, "speaker_embedding": speaker_emb, "emotion_embedding": emotion_emb}
