"""Tracing and profiling utilities, the JAX package's API over torch.

Counterpart of ``hifigan_tpu/utils/profiling.py``:

* :func:`annotate`: a ``torch.profiler.record_function`` range (it shows
  up in the trace as a CPU range around the kernels launched inside it);
* :func:`trace_to`: ``torch.profiler.profile`` around a block, writing a
  Chrome trace file into a directory;
* :class:`StageTimer`: wall-clock timing of named stages with a summary;
* :func:`device_time`: seconds per call, from CUDA events around ``iters``
  calls after warm-up calls on the card, ``time.perf_counter`` on the CPU;
  the port's one timer (``cli bench`` times with it, under the name
  :func:`hifigan_tpu_torch.utils.benchit.call_time`).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import torch
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named profiler range (cheap when no profiler runs)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU, and CUDA where a card is present) and write
    ``<log_dir>/trace_<pid>_<ns>.json``, a Chrome trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StageTimer:
    """Accumulates wall-clock timings per named stage."""

    def __init__(self):
        self._records: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._records[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, vals in self._records.items():
            out[name] = {
                "count": len(vals),
                "total_s": sum(vals),
                "mean_ms": 1e3 * sum(vals) / len(vals),
                "max_ms": 1e3 * max(vals),
            }
        return out

    def reset(self) -> None:
        self._records.clear()


def _on_card(args) -> bool:
    """Whether a tensor anywhere in ``args`` (nested tuples, lists and
    dicts included) lies on the card."""
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in tree_leaves(args))


def device_time(fn, args, iters: int = 16, *, warmup: int = 1, device=None) -> float:
    """Seconds per call of ``fn(*args)``: ``warmup`` calls that are not
    timed, then the whole window of ``iters`` calls over ``iters``, the calls
    made one after another as a caller makes them.

    On the card the window lies between two CUDA events (the device's time,
    every gap in which it waited for the host to launch included, so a
    stalled call moves the figure); on the CPU between two
    ``time.perf_counter`` reads (torch on the CPU returns when the work is
    done).  ``device`` is the device asked for, ``"cuda"`` or ``"cpu"``;
    when None, the card if a tensor of ``args``, at any depth, lies on it.
    Any other device raises."""
    if device is None:
        device = "cuda" if _on_card(args) else "cpu"
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device_time times on 'cuda' or 'cpu', not {device}")
    for _ in range(warmup):
        fn(*args)
    if device.type == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(device):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()  # the warm-up's work ends before the window opens
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters
