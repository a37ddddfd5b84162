"""hifigan_tpu_torch: the PyTorch / CUDA port of ``hifigan_tpu``.

The flagship generator, and the voice-cloning vocoder around it
(``ModifiedVocoder``: ECAPA-TDNN and Emotion2Vec embeddings of a reference
clip condition the generator), run on an NVIDIA H100, with the fused
GRC-chain step as a hand-written CUDA kernel (``csrc/grc_step_bf16.cu`` on
the tensor cores for bf16, ``csrc/grc_step.cu`` for fp32).  Importing the
package imports torch and numpy only; kernels are built at first use."""

from hifigan_tpu_torch.entry import build_generator, build_vocoder, entry
from hifigan_tpu_torch.models.generator import Generator, GeneratorConfig
from hifigan_tpu_torch.models.vocoder import ModifiedVocoder
from hifigan_tpu_torch.weights import load_jax_generator_params, load_jax_params

__all__ = ["Generator", "GeneratorConfig", "ModifiedVocoder", "build_generator", "build_vocoder", "entry",
           "load_jax_generator_params", "load_jax_params"]
