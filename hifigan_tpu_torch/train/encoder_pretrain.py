"""The conditioning encoders' pre-training config, at inference.

Counterpart of the inference half of ``hifigan_tpu/train/encoder_pretrain.py``:
the config the judge encoders were trained under (speaker identity over the
formant corpus's 32 speakers for ECAPA-TDNN, arousal in
:data:`N_AROUSAL_BINS` classes for Emotion2Vec), the two models without
their classifier heads, and the helpers that strip a head from a parameter
tree and graft the encoders into a vocoder's extractor.  The port's
parameter trees are state dicts (dotted names, the JAX leaves' paths).

The classifier heads and the encoder train step are not ported yet.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch

from hifigan_tpu_torch.models.embeddings import EcapaTdnn, Emotion2Vec
from hifigan_tpu_torch.ops.stft import MelConfig

N_AROUSAL_BINS = 8


def arousal_bin(arousal) -> np.ndarray:
    """Quantise arousal ∈ [0.2, 1.0] into N_AROUSAL_BINS classes."""
    a = (np.asarray(arousal) - 0.2) / 0.8
    return np.clip((a * N_AROUSAL_BINS).astype(np.int32), 0, N_AROUSAL_BINS - 1)


@dataclass(frozen=True)
class EncoderTrainConfig:
    """The JAX package's encoder pre-training config.  The *judge*
    Emotion2Vec is 3 layers × 256 with 4 heads (the 6 × 512 class default
    could not learn the arousal task); ECAPA-TDNN is 512 wide."""

    n_speakers: int = 32
    segment_samples: int = 16_384
    batch_size: int = 32
    learning_rate: float = 1e-3
    mel: MelConfig = MelConfig()
    ecapa_channels: int = 512
    emo_hidden: int = 256
    emo_layers: int = 3
    emo_heads: int = 4
    aam_margin: float = 0.2
    aam_scale: float = 30.0
    emo_learning_rate: float = 1e-4
    emo_warmup_steps: int = 500
    spk_pair_weight: float = 0.0


def build_models(cfg: EncoderTrainConfig, dtype=torch.float32, *,
                 gen: torch.Generator) -> tuple[EcapaTdnn, Emotion2Vec]:
    """ECAPA-TDNN and Emotion2Vec at ``cfg``'s widths over ``cfg.mel``'s
    mels, without classifier heads, drawn from ``gen``."""
    n_mels = cfg.mel.n_mels
    ecapa = EcapaTdnn(n_mels, cfg.ecapa_channels, dtype=dtype, gen=gen)
    emo = Emotion2Vec(n_mels, cfg.emo_hidden, num_layers=cfg.emo_layers, num_heads=cfg.emo_heads, dtype=dtype,
                      gen=gen)
    return ecapa, emo


def strip_classifier(params: Mapping) -> dict:
    """``params`` (a state dict) without the classifier head's entries,
    so that it matches the inference-mode encoder."""
    return {k: v for k, v in params.items() if k.split(".")[0] != "classifier"}


def graft_into_extractor(gen_params: Mapping, ecapa_params: Mapping, emo_params: Mapping) -> dict:
    """A new vocoder state dict whose extractor subtrees
    (``embedding_extractor.ecapa`` / ``embedding_extractor.emotion2vec``)
    are replaced by the encoders' (classifier heads stripped); the input is
    left as it is.  The encoders' widths must be the extractor's: the judge
    Emotion2Vec (3 × 256) fits only a vocoder built at those widths."""
    out = {k: v for k, v in gen_params.items()
           if not k.startswith(("embedding_extractor.ecapa.", "embedding_extractor.emotion2vec."))}
    for prefix, params in (("ecapa", ecapa_params), ("emotion2vec", emo_params)):
        out.update({f"embedding_extractor.{prefix}.{k}": v for k, v in strip_classifier(params).items()})
    return out
