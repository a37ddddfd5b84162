"""Models of the port."""

from hifigan_tpu_torch.models.code_vocoder import CodeVocoder, CodeVocoderConfig
from hifigan_tpu_torch.models.conformer import ChunkedConformer
from hifigan_tpu_torch.models.discriminators import Discriminators
from hifigan_tpu_torch.models.embeddings import EcapaTdnn, EmbeddingExtractor, Emotion2Vec
from hifigan_tpu_torch.models.generator import (
    FiLM,
    Generator,
    GeneratorConfig,
    GRCLoRABlock,
    HiFiGANV1Generator,
    ODConv1d,
    ODConvTranspose1d,
)
from hifigan_tpu_torch.models.streamspeech import StreamSpeechConfig, StreamSpeechS2ST
from hifigan_tpu_torch.models.vocoder import ModifiedVocoder

__all__ = ["ChunkedConformer", "CodeVocoder", "CodeVocoderConfig", "Discriminators", "EcapaTdnn",
           "EmbeddingExtractor", "Emotion2Vec", "FiLM", "Generator", "GeneratorConfig", "GRCLoRABlock",
           "HiFiGANV1Generator", "ModifiedVocoder", "ODConv1d", "ODConvTranspose1d", "StreamSpeechConfig", "StreamSpeechS2ST"]
