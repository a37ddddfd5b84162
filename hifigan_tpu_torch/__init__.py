"""hifigan_tpu_torch: the PyTorch / CUDA port of ``hifigan_tpu``.

The flagship generator, and the voice-cloning vocoder around it
(``ModifiedVocoder``: ECAPA-TDNN and Emotion2Vec embeddings of a reference
clip condition the generator), run on an NVIDIA H100, with the fused
GRC-chain step as a hand-written CUDA kernel (``csrc/grc_step_bf16.cu`` on
the tensor cores for bf16, ``csrc/grc_step.cu`` for fp32).  The GAN
trainer (``create_train_state``, ``hifigan_tpu_torch.train``, ``python -m
hifigan_tpu_torch.cli train``) trains it against the MPD/MSD
discriminators.  The streaming speech-to-speech translation path
(``build_s2st_inference``, ``hifigan_tpu_torch.streaming``, ``python -m
hifigan_tpu_torch.cli simulate``) runs StreamSpeech and the CodeHiFiGAN
unit vocoder over an utterance fed in segments.  The evaluation path
(``hifigan_tpu_torch.eval``, ``python -m hifigan_tpu_torch.cli eval`` and
``eval-clone``) scores the vocoder on the formant corpus: speaker and
emotion similarity, mel-L1, MCD, ASR-BLEU with a CTC judge, and the
voice-cloning transfer grid.  The translation app
(``hifigan_tpu_torch.app``, ``python -m hifigan_tpu_torch.cli serve``)
serves the ASR → MT → TTS cascade over HTTP, its TTS mels through the
vocoder.  Importing the package imports torch and numpy only (the corpus
adds scipy); kernels are built at first use."""

from hifigan_tpu_torch.entry import (
    build_code_vocoder,
    build_generator,
    build_s2st,
    build_s2st_inference,
    build_vocoder,
    entry,
)
from hifigan_tpu_torch.models.generator import Generator, GeneratorConfig
from hifigan_tpu_torch.models.vocoder import ModifiedVocoder
from hifigan_tpu_torch.train.state import TrainConfig, create_train_state
from hifigan_tpu_torch.weights import load_jax_generator_params, load_jax_params, load_jax_train_state

__all__ = ["Generator", "GeneratorConfig", "ModifiedVocoder", "TrainConfig", "build_code_vocoder", "build_generator",
           "build_s2st", "build_s2st_inference", "build_vocoder", "create_train_state", "entry",
           "load_jax_generator_params", "load_jax_params", "load_jax_train_state"]
