"""Entry points: build the flagship generator, the voice-cloning vocoder
and example inputs.

All run on the card unless the caller passes ``device="cpu"``."""

from __future__ import annotations

import torch

from hifigan_tpu_torch.models.generator import Generator, GeneratorConfig
from hifigan_tpu_torch.models.vocoder import ModifiedVocoder


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
