"""Utilities: model introspection."""

from hifigan_tpu_torch.utils.model_info import model_info

__all__ = ["model_info"]
