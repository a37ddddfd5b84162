"""Models of the port."""

from hifigan_tpu_torch.models.generator import (
    FiLM,
    Generator,
    GeneratorConfig,
    GRCLoRABlock,
    ODConvTranspose1d,
)

__all__ = ["FiLM", "Generator", "GeneratorConfig", "GRCLoRABlock", "ODConvTranspose1d"]
