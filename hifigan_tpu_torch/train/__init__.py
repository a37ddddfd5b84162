"""GAN training of the vocoder: losses, train state and optimisers, the
alternating train step, on-device data, host data and checkpoints."""

from hifigan_tpu_torch.train.losses import LossWeights
from hifigan_tpu_torch.train.state import GanTrainState, TrainConfig, create_train_state, make_optimizer
from hifigan_tpu_torch.train.train_step import audio_to_mel, make_eval_step, make_train_step

__all__ = ["GanTrainState", "LossWeights", "TrainConfig", "audio_to_mel", "create_train_state", "make_eval_step",
           "make_optimizer", "make_train_step"]
