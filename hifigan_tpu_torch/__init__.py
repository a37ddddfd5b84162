"""hifigan_tpu_torch: the PyTorch / CUDA port of ``hifigan_tpu``.

The flagship generator, and the voice-cloning vocoder around it
(``ModifiedVocoder``: ECAPA-TDNN and Emotion2Vec embeddings of a reference
clip condition the generator), run on an NVIDIA H100, with the fused
GRC-chain step as a hand-written CUDA kernel (``csrc/grc_step_bf16.cu`` on
the tensor cores for bf16, ``csrc/grc_step.cu`` for fp32).  The GAN
trainer (``create_train_state``, ``hifigan_tpu_torch.train``, ``python -m
hifigan_tpu_torch.cli train``) trains it against the MPD/MSD
discriminators.  Importing the package imports torch and numpy only;
kernels are built at first use."""

from hifigan_tpu_torch.entry import build_generator, build_vocoder, entry
from hifigan_tpu_torch.models.generator import Generator, GeneratorConfig
from hifigan_tpu_torch.models.vocoder import ModifiedVocoder
from hifigan_tpu_torch.train.state import TrainConfig, create_train_state
from hifigan_tpu_torch.weights import load_jax_generator_params, load_jax_params, load_jax_train_state

__all__ = ["Generator", "GeneratorConfig", "ModifiedVocoder", "TrainConfig", "build_generator", "build_vocoder",
           "create_train_state", "entry", "load_jax_generator_params", "load_jax_params", "load_jax_train_state"]
