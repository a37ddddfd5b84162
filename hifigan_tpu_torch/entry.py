"""Entry points: build the flagship generator, the voice-cloning vocoder,
the streaming S2ST stack and example inputs.

All run on the card unless the caller passes ``device="cpu"``."""

from __future__ import annotations

import torch

from hifigan_tpu_torch.models.code_vocoder import CodeVocoder, CodeVocoderConfig
from hifigan_tpu_torch.models.generator import Generator, GeneratorConfig
from hifigan_tpu_torch.models.streamspeech import StreamSpeechConfig, StreamSpeechS2ST
from hifigan_tpu_torch.models.vocoder import ModifiedVocoder
from hifigan_tpu_torch.streaming.runtime import S2STInference, S2STInferenceConfig


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device and
    there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def build_generator(
    config: GeneratorConfig = GeneratorConfig(),
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> Generator:
    """A ``Generator`` with weights drawn from ``seed`` (the JAX package's
    initialisers), on ``device``, computing in ``dtype``."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return Generator(config, dtype, gen=gen).to(device).eval()


def build_vocoder(
    config: GeneratorConfig = GeneratorConfig(),
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
    seed: int = 0,
    ecapa_channels: int = 512,
    emo_hidden: int = 512,
    emo_layers: int = 6,
    emo_heads: int = 8,
) -> ModifiedVocoder:
    """A ``ModifiedVocoder`` (generator + ECAPA-TDNN + Emotion2Vec; the
    defaults are ``TrainConfig()``'s widths) with weights drawn from
    ``seed``, on ``device``, computing in ``dtype``."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return ModifiedVocoder(config, ecapa_channels, emo_hidden, emo_layers, emo_heads, dtype,
                           gen=gen).to(device).eval()


def build_s2st(
    config: StreamSpeechConfig = StreamSpeechConfig(),
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> StreamSpeechS2ST:
    """A ``StreamSpeechS2ST`` (with its vocoder and transition head) with
    weights drawn from ``seed`` (the JAX package's initialisers), fp32, in
    eval mode, on ``device``."""
    device = resolve_device(device)
    return StreamSpeechS2ST(config, gen=torch.Generator().manual_seed(seed)).to(device).eval()


def build_code_vocoder(
    config: CodeVocoderConfig = CodeVocoderConfig(),
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> CodeVocoder:
    """A ``CodeVocoder`` with weights drawn from ``seed``, fp32, in eval
    mode, on ``device``."""
    device = resolve_device(device)
    return CodeVocoder(config, gen=torch.Generator().manual_seed(seed)).to(device).eval()


def build_s2st_inference(
    config: StreamSpeechConfig = StreamSpeechConfig(),
    code_config: CodeVocoderConfig | None = None,
    inference_config: S2STInferenceConfig = S2STInferenceConfig(),
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> S2STInference:
    """The streaming S2ST runtime over ``build_s2st(config, seed)`` and
    ``build_code_vocoder(code_config, seed + 1)``, the pair ``cli
    simulate`` runs without a checkpoint; ``code_config`` defaults to
    ``CodeVocoderConfig()`` over ``config``'s unit vocabulary."""
    code_config = code_config or CodeVocoderConfig(unit_vocab_size=config.unit_vocab_size)
    return S2STInference(build_s2st(config, device, seed), build_code_vocoder(code_config, device, seed + 1),
                         inference_config)


def entry(device: str | torch.device = "cuda"):
    """Returns ``(model, (mel, spk, emo))``: the flagship generator (full
    config, bf16, seed 0) and a batch of 2 × 64 mel frames, the counterpart
    of ``__graft_entry__.entry()``."""
    device = resolve_device(device)
    model = build_generator(GeneratorConfig(), torch.bfloat16, device, seed=0)
    gens = [torch.Generator().manual_seed(s) for s in (0, 1, 2)]
    mel = torch.randn((2, 80, 64), generator=gens[0])
    spk = torch.randn((2, 192), generator=gens[1])
    emo = torch.randn((2, 256), generator=gens[2])
    return model, tuple(t.to(device) for t in (mel, spk, emo))
