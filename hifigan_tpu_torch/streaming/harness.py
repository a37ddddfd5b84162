"""The streaming simulation loop (SimulEval's semantics) and Average
Lagging.

The port's own copy of ``hifigan_tpu/streaming/harness.py``.  The loop
feeds fixed-size source segments; the agent answers each policy call with a
``ReadAction`` (it needs more input) or a ``WriteAction`` (it emits a text
or speech segment), and latency is scored from the source time at which
each output was committed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Protocol, Union

import numpy as np


@dataclass
class SpeechSegment:
    samples: np.ndarray
    sample_rate: int = 16_000
    finished: bool = False


@dataclass
class TextSegment:
    content: str
    finished: bool = False


@dataclass
class ReadAction:
    pass


@dataclass
class WriteAction:
    segment: Union[SpeechSegment, TextSegment]
    finished: bool = False


@dataclass
class AgentStates:
    """What a streaming agent sees: the source so far and whether it ended."""

    source_samples: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    source_sample_rate: int = 16_000
    source_finished: bool = False
    target_segments: List[Union[SpeechSegment, TextSegment]] = field(default_factory=list)

    @property
    def source_seconds(self) -> float:
        return len(self.source_samples) / self.source_sample_rate


class StreamingAgent(Protocol):
    def reset(self) -> None: ...

    def policy(self, states: AgentStates) -> Union[ReadAction, WriteAction]: ...


@dataclass
class SessionResult:
    outputs: List[Union[SpeechSegment, TextSegment]]
    emission_source_seconds: List[float]  # the source time at each write
    source_seconds: float

    @property
    def text(self) -> str:
        return " ".join(s.content for s in self.outputs if isinstance(s, TextSegment)).strip()

    @property
    def waveform(self) -> np.ndarray:
        chunks = [s.samples for s in self.outputs if isinstance(s, SpeechSegment)]
        return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)

    def _token_delays(self) -> List[float]:
        """The source time at the commitment of each target token: a write
        of k tokens at source time t gives k delays of t.  Text sessions
        count whitespace tokens, speech sessions 20 ms units of output."""
        text_mode = any(isinstance(s, TextSegment) and s.content.strip() for s in self.outputs)
        delays: List[float] = []
        for seg, t in zip(self.outputs, self.emission_source_seconds):
            if text_mode:
                if isinstance(seg, TextSegment):
                    delays.extend([t] * len(seg.content.split()))
            elif isinstance(seg, SpeechSegment) and len(seg.samples):
                k = max(1, int(round(len(seg.samples) / seg.sample_rate / 0.02)))
                delays.extend([t] * k)
        return delays

    @property
    def average_lagging_ms(self) -> float:
        """Average Lagging (Ma et al., 2019; SimulEval's scorer), not aware
        of computation time:

            AL = (1/τ) · Σ_{i=1..τ} (d_i − (i−1)/γ),   γ = |Y| / |X|,

        d_i the source seconds read when target token i was committed, |X|
        the source duration, |Y| the number of target tokens and τ the
        first token committed after the whole source was read.  No term is
        clamped: a policy that commits everything early shows a small or
        negative AL."""
        delays = self._token_delays()
        if not delays:
            return 0.0
        x = self.source_seconds
        y = len(delays)
        if x <= 0:
            return 0.0
        gamma = y / x
        tau = next((i + 1 for i, d in enumerate(delays) if d >= x), y)
        al = sum(delays[i] - i / gamma for i in range(tau)) / tau
        return 1000.0 * float(al)


def run_streaming_session(agent: StreamingAgent, source_audio: np.ndarray, *, sample_rate: int = 16_000,
                          segment_size_ms: int = 320, max_steps: int = 10_000) -> SessionResult:
    """Drive ``agent`` with ``segment_size_ms`` source segments until it
    finishes (or reads past the end of the source twice)."""
    agent.reset()
    states = AgentStates(source_sample_rate=sample_rate)
    seg_len = sample_rate * segment_size_ms // 1000
    cursor = 0
    outputs: List[Union[SpeechSegment, TextSegment]] = []
    emission_ts: List[float] = []
    for _ in range(max_steps):
        action = agent.policy(states)
        if isinstance(action, WriteAction):
            outputs.append(action.segment)
            emission_ts.append(states.source_seconds)
            if action.finished:
                break
            continue
        if cursor >= len(source_audio):
            if states.source_finished:
                break  # the agent reads on after the end: stop it
            states.source_finished = True
            continue
        nxt = source_audio[cursor: cursor + seg_len]
        cursor += len(nxt)
        states.source_samples = np.concatenate([states.source_samples, nxt])
        if cursor >= len(source_audio):
            states.source_finished = True
    return SessionResult(outputs=outputs, emission_source_seconds=emission_ts,
                         source_seconds=len(source_audio) / sample_rate)
