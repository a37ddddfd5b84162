"""Utilities: model introspection, profiling, timing, TensorBoard events."""

from hifigan_tpu_torch.utils.benchit import call_time
from hifigan_tpu_torch.utils.model_info import model_info
from hifigan_tpu_torch.utils.profiling import StageTimer, annotate, device_time, trace_to

__all__ = ["StageTimer", "annotate", "call_time", "device_time", "model_info", "trace_to"]
