"""Simultaneous read/write policies, host-side decisions over token counts.

The port's own copy of ``hifigan_tpu/streaming/policy.py``:

* :class:`StreamSpeechPolicy`: the CTC-progress gate.  Write once both the
  source (ASR) and the target (translation) CTC streams have at least
  ``stride_n`` new tokens since the last write, after lagging offsets
  ``k1``/``k2`` before the first.
* :class:`WaitKPolicy`: the wait-k / stride-n schedule.  The subword budget
  is ``((segments − k1) // n1) · n1``, the unit budget ``((subwords − k2)
  // n2) · n2 · unit_per_subword``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class StreamSpeechPolicy:
    """CTC-progress policy gate."""

    stride_n: int = 1
    lagging_k1: int = 0  # source CTC tokens needed before the first write
    lagging_k2: int = 0  # target CTC tokens needed before the first write

    def __post_init__(self):
        self._last_src = 0
        self._last_tgt = 0

    def should_write(self, src_tokens: int, tgt_tokens: int, *, source_finished: bool) -> bool:
        if source_finished:
            return True
        if src_tokens < self.lagging_k1 or tgt_tokens < self.lagging_k2:
            return False
        new_src = src_tokens - self._last_src
        new_tgt = tgt_tokens - self._last_tgt
        return new_src >= self.stride_n and new_tgt >= self.stride_n

    def committed(self, src_tokens: int, tgt_tokens: int) -> None:
        """Record the progress at a write."""
        self._last_src = src_tokens
        self._last_tgt = tgt_tokens

    def reset(self):
        self._last_src = self._last_tgt = 0


@dataclass
class WaitKPolicy:
    """Wait-k / stride-n schedule."""

    k1: int = 3  # source segments to wait before text
    n1: int = 1  # text stride
    k2: int = 1  # subwords to wait before units
    n2: int = 1  # unit stride
    unit_per_subword: int = 10

    def subword_budget(self, source_segments: int, *, source_finished: bool) -> int:
        if source_finished:
            return 1 << 30
        if source_segments < self.k1:
            return 0
        return ((source_segments - self.k1) // self.n1) * self.n1

    def unit_budget(self, emitted_subwords: int, *, source_finished: bool) -> int:
        if source_finished:
            return 1 << 30
        if emitted_subwords < self.k2:
            return 0
        return ((emitted_subwords - self.k2) // self.n2) * self.n2 * self.unit_per_subword
