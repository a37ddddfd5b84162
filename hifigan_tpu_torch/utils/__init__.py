"""Utilities: model introspection, profiling, TensorBoard events."""

from hifigan_tpu_torch.utils.model_info import model_info
from hifigan_tpu_torch.utils.profiling import StageTimer, annotate, device_time, trace_to

__all__ = ["StageTimer", "annotate", "device_time", "model_info", "trace_to"]
