"""hifigan_tpu_torch: the PyTorch / CUDA port of ``hifigan_tpu``.

The flagship generator runs on an NVIDIA H100, with the fused GRC-chain step
as a hand-written CUDA kernel (``csrc/grc_step_bf16.cu`` on the tensor cores
for bf16, ``csrc/grc_step.cu`` for fp32).  Importing the package
imports torch and numpy only; kernels are built at first use."""

from hifigan_tpu_torch.entry import build_generator, entry
from hifigan_tpu_torch.models.generator import Generator, GeneratorConfig
from hifigan_tpu_torch.weights import load_jax_generator_params

__all__ = ["Generator", "GeneratorConfig", "build_generator", "entry", "load_jax_generator_params"]
