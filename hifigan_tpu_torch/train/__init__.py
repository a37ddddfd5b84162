"""GAN training of the vocoder: losses, train state and optimisers, the
alternating train step, on-device data, host data and checkpoints.

The heavier tasks are imported by their users: ``encoder_pretrain``
(discriminative pre-training of the conditioning encoders) and ``cloning``
(the voice-cloning fine-tune)."""

from hifigan_tpu_torch.train.losses import (
    LossWeights,
    discriminator_loss,
    feature_matching_loss,
    generator_adversarial_loss,
    mel_l1_loss,
)
from hifigan_tpu_torch.train.state import GanTrainState, TrainConfig, create_train_state, make_optimizer
from hifigan_tpu_torch.train.train_step import audio_to_mel, make_eval_step, make_train_step

__all__ = ["GanTrainState", "LossWeights", "TrainConfig", "audio_to_mel", "create_train_state",
           "discriminator_loss", "feature_matching_loss", "generator_adversarial_loss", "make_eval_step",
           "make_optimizer", "make_train_step", "mel_l1_loss"]
