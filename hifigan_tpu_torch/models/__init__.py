"""Models of the port."""

from hifigan_tpu_torch.models.discriminators import Discriminators
from hifigan_tpu_torch.models.embeddings import EcapaTdnn, EmbeddingExtractor, Emotion2Vec
from hifigan_tpu_torch.models.generator import (
    FiLM,
    Generator,
    GeneratorConfig,
    GRCLoRABlock,
    ODConvTranspose1d,
)
from hifigan_tpu_torch.models.vocoder import ModifiedVocoder

__all__ = ["Discriminators", "EcapaTdnn", "EmbeddingExtractor", "Emotion2Vec", "FiLM", "Generator", "GeneratorConfig",
           "GRCLoRABlock", "ModifiedVocoder", "ODConvTranspose1d"]
