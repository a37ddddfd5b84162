"""Streaming agents: simultaneous S2ST, S2TT and ASR under the StreamSpeech
(CTC-progress) and wait-k policies, greedy decoding.

Counterpart of ``hifigan_tpu/streaming/agents.py``:

* :class:`ASRAgent` emits the source-CTC text beyond what it committed;
* :class:`S2TTAgent` gates on CTC progress and continues the text greedily
  under a write budget, drains at the end of the source, and can trim to
  whole words;
* :class:`S2STAgent` adds units, from the encoder-fed T2U stream
  (``units_from="encoder"``) or from the decoder's features
  (``"decoder"``), and the unit vocoder's new waveform tail;
* :class:`WaitkS2TTAgent` and :class:`WaitkS2STAgent` follow the wait-k
  budgets.

Each policy call encodes the whole prefix received so far; only what is
emitted is incremental.  ``decode="hmt"`` (the simultaneous beam) is not
ported yet and raises.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np

from hifigan_tpu_torch.streaming.decode import trim_to_whole_words
from hifigan_tpu_torch.streaming.features import FbankConfig, OnlineFbank
from hifigan_tpu_torch.streaming.harness import AgentStates, ReadAction, SpeechSegment, TextSegment, WriteAction
from hifigan_tpu_torch.streaming.policy import StreamSpeechPolicy, WaitKPolicy
from hifigan_tpu_torch.streaming.runtime import S2STInference


def default_detokenizer(ids: List[int]) -> str:
    """The id → text mapping used when no tokenizer is given."""
    return " ".join(f"<{i}>" for i in ids)


class _AgentBase:
    def __init__(self, inference: S2STInference, *, fbank: Optional[FbankConfig] = None,
                 detokenize: Callable[[List[int]], str] = default_detokenizer, debug_dir: Optional[str] = None):
        self.inf = inference
        self.fbank_cfg = fbank or FbankConfig()
        self.detokenize = detokenize
        self.debug_dir = debug_dir  # where per-stream transcripts are appended, if given
        self.reset()

    def _debug(self, stream: str, text: str):
        if not self.debug_dir:
            return
        os.makedirs(self.debug_dir, exist_ok=True)
        with open(os.path.join(self.debug_dir, f"{stream}.txt"), "a") as f:
            f.write(text + "\n")

    def reset(self):
        self.extractor = OnlineFbank(self.fbank_cfg, device=self.inf.device)
        self._consumed_samples = 0
        self.committed_text_ids: List[int] = []
        self.emitted_units: List[int] = []
        self.finished = False
        self.dec_session = self.inf.new_session()

    def _ingest(self, states: AgentStates):
        new = states.source_samples[self._consumed_samples:]
        if len(new):
            self.extractor.push(new)
            self._consumed_samples = len(states.source_samples)

    def _encode(self, states: AgentStates):
        self._ingest(states)
        frames = self.extractor.frames()
        if frames.shape[0] == 0:
            return None
        return self.inf.encode_prefix(frames)


class ASRAgent(_AgentBase):
    """Streaming ASR: emit the source-CTC tokens beyond those committed."""

    def __init__(self, inference, *, min_new_tokens: int = 1, **kw):
        super().__init__(inference, **kw)
        self.min_new_tokens = min_new_tokens

    def reset(self):
        super().reset()
        self.committed_src: List[int] = []

    def policy(self, states: AgentStates):
        enc = self._encode(states)
        if enc is None:
            return ReadAction()
        new = enc["src_tokens"][len(self.committed_src):]
        if len(new) < self.min_new_tokens and not states.source_finished:
            return ReadAction()
        if not new and states.source_finished:
            self.finished = True
            return WriteAction(TextSegment("", finished=True), finished=True)
        self.committed_src.extend(new)
        self._debug("asr", self.detokenize(new))
        return WriteAction(TextSegment(self.detokenize(new), finished=states.source_finished),
                           finished=states.source_finished and not new)


class S2TTAgent(_AgentBase):
    """Simultaneous speech-to-text translation under the CTC-progress gate,
    with greedy KV-cached decoding."""

    def __init__(self, inference, *, stride_n: int = 1, whole_words: bool = False, decode: str = "greedy",
                 token_text: Optional[Callable[[int], str]] = None, **kw):
        if decode == "hmt":
            raise NotImplementedError("decode='hmt' needs the simultaneous beam search (streaming/beam.py), "
                                      "not ported yet: ROADMAP Queue 1 item 6")
        if decode != "greedy":
            raise ValueError(f"decode must be 'greedy' or 'hmt', got {decode!r}")
        super().__init__(inference, **kw)
        self.gate = StreamSpeechPolicy(stride_n=stride_n)
        self.whole_words = whole_words
        # id → subword string, for the ▁ word boundaries
        self.token_text = token_text or (lambda i: self.detokenize([i]))

    def reset(self):
        super().reset()
        if hasattr(self, "gate"):
            self.gate.reset()

    def _write_budget(self, n_tgt: int) -> int:
        """How many subwords may be written now: ``((n_tgt − k1) //
        stride_n) · stride_n`` in all (+1 with whole words, whose trailing
        partial word is trimmed), less those already committed.  The
        decoder never runs ahead of the target CTC's length estimate while
        the source is open."""
        total = ((n_tgt - self.gate.lagging_k1) // self.gate.stride_n) * self.gate.stride_n
        if self.whole_words:
            total += 1
        return total - len(self.committed_text_ids)

    def _advance_text(self, states: AgentStates, enc, budget: Optional[int] = None) -> tuple:
        """Continue the text, shared by S2TT and S2ST: KV-cached greedy
        decoding, the whole remaining buffer in one call once the source
        has ended, and whole-word trimming while it is open.  Returns
        (new ids, whether EOS was reached)."""
        cfg = self.inf.cfg
        if states.source_finished:
            max_new = cfg.max_target_len - 1 - len(self.committed_text_ids)
            if max_new <= 0:
                return [], True
        else:
            max_new = cfg.max_new_tokens
            if budget is not None:
                max_new = min(max_new, budget)
        new_ids = self.inf.continue_text(enc["enc"], self.committed_text_ids, max_new_tokens=max_new,
                                         session=self.dec_session)
        hit_eos = bool(new_ids) and new_ids[-1] == cfg.eos_id
        if hit_eos:
            new_ids = new_ids[:-1]
        if self.whole_words and not states.source_finished and new_ids:
            new_ids = new_ids[: len(trim_to_whole_words([self.token_text(i) for i in new_ids]))]
        if new_ids:
            self.committed_text_ids.extend(new_ids)
            self._debug("st", self.detokenize(new_ids))
        return new_ids, hit_eos

    def _gate(self, states: AgentStates, enc):
        """(write?, budget): the CTC-progress gate and the write budget;
        records the progress when the gate opens."""
        n_src, n_tgt = len(enc["src_tokens"]), len(enc["tgt_tokens"])
        if not self.gate.should_write(n_src, n_tgt, source_finished=states.source_finished):
            return False, None
        budget = None
        if not states.source_finished:
            budget = self._write_budget(n_tgt)
            if budget < 1:
                return False, None
        self.gate.committed(n_src, n_tgt)
        return True, budget

    def policy(self, states: AgentStates):
        enc = self._encode(states)
        if enc is None:
            return ReadAction()
        write, budget = self._gate(states, enc)
        if not write:
            return ReadAction()
        new_ids, hit_eos = self._advance_text(states, enc, budget=budget)
        if not new_ids:
            if states.source_finished:
                self.finished = True
                return WriteAction(TextSegment("", finished=True), finished=True)
            return ReadAction()
        done = states.source_finished and hit_eos
        self.finished = done
        return WriteAction(TextSegment(self.detokenize(new_ids), finished=done), finished=done)


class S2STAgent(S2TTAgent):
    """Simultaneous S2ST: the S2TT gate and text, then units and the unit
    vocoder's new tail.  ``units_from="encoder"`` takes units from the
    encoder-fed T2U stream, whose long blank runs become pause units;
    ``"decoder"`` from the decoder's features over the committed text."""

    def __init__(self, inference, *, units_from: str = "encoder", **kw):
        if units_from not in ("decoder", "encoder"):
            raise ValueError(f"units_from must be 'encoder' or 'decoder', got {units_from!r}")
        super().__init__(inference, **kw)
        self.units_from = units_from

    def policy(self, states: AgentStates):
        enc = self._encode(states)
        if enc is None:
            return ReadAction()
        write, budget = self._gate(states, enc)
        if not write:
            return ReadAction()
        self._advance_text(states, enc, budget=budget)
        if self.units_from == "decoder":
            new_units, _ = self.inf.units_from_text(enc["enc"], self.committed_text_ids, len(self.emitted_units))
        else:
            new_units, _ = self.inf.units_from_prefix(enc["unit_argmax"], len(self.emitted_units))
        if not new_units:
            if states.source_finished:
                self.finished = True
                return WriteAction(SpeechSegment(np.zeros(0, np.float32), finished=True), finished=True)
            return ReadAction()
        self.emitted_units.extend(new_units)
        self._debug("unit", " ".join(map(str, new_units)))
        tail = self.inf.synthesize_tail(self.emitted_units, len(new_units))
        done = bool(states.source_finished)
        self.finished = done
        return WriteAction(SpeechSegment(tail, finished=done), finished=done)


class WaitkS2TTAgent(_AgentBase):
    """Wait-k text agent: the subword budget follows the source segments read."""

    def __init__(self, inference, *, k1: int = 3, n1: int = 1, segment_size_ms: int = 320, **kw):
        super().__init__(inference, **kw)
        self.sched = WaitKPolicy(k1=k1, n1=n1)
        self.segment_size_ms = segment_size_ms

    def policy(self, states: AgentStates):
        enc = self._encode(states)
        if enc is None:
            return ReadAction()
        segments = int(states.source_seconds * 1000 / self.segment_size_ms)
        budget = self.sched.subword_budget(segments, source_finished=states.source_finished)
        allowed = budget - len(self.committed_text_ids)
        if allowed <= 0:
            if states.source_finished:
                self.finished = True
                return WriteAction(TextSegment("", finished=True), finished=True)
            return ReadAction()
        new_ids = self.inf.continue_text(enc["enc"], self.committed_text_ids,
                                         max_new_tokens=min(allowed, self.inf.cfg.max_new_tokens),
                                         session=self.dec_session)
        hit_eos = bool(new_ids) and new_ids[-1] == self.inf.cfg.eos_id
        if hit_eos:
            new_ids = new_ids[:-1]
        if not new_ids:
            if states.source_finished:
                self.finished = True
                return WriteAction(TextSegment("", finished=True), finished=True)
            return ReadAction()
        self.committed_text_ids.extend(new_ids)
        done = states.source_finished and hit_eos
        self.finished = done
        return WriteAction(TextSegment(self.detokenize(new_ids), finished=done), finished=done)


class WaitkS2STAgent(WaitkS2TTAgent):
    """Wait-k S2ST: the unit budget ``((subwords − k2) // n2) · n2 ·
    unit_per_subword``, then the unit vocoder's new tail."""

    def __init__(self, inference, *, k2: int = 1, n2: int = 1, unit_per_subword: int = 10, **kw):
        super().__init__(inference, **kw)
        self.sched.k2 = k2
        self.sched.n2 = n2
        self.sched.unit_per_subword = unit_per_subword

    def policy(self, states: AgentStates):
        enc = self._encode(states)
        if enc is None:
            return ReadAction()
        segments = int(states.source_seconds * 1000 / self.segment_size_ms)
        sub_budget = self.sched.subword_budget(segments, source_finished=states.source_finished)
        unit_budget = self.sched.unit_budget(min(sub_budget, len(enc["tgt_tokens"])),
                                             source_finished=states.source_finished)
        allowed_units = unit_budget - len(self.emitted_units)
        new_units = []
        if allowed_units > 0:
            new_units, _ = self.inf.units_from_prefix(enc["unit_argmax"], len(self.emitted_units))
            new_units = new_units[:allowed_units]
        if not new_units:
            if states.source_finished:
                self.finished = True
                return WriteAction(SpeechSegment(np.zeros(0, np.float32), finished=True), finished=True)
            return ReadAction()
        self.emitted_units.extend(new_units)
        tail = self.inf.synthesize_tail(self.emitted_units, len(new_units))
        done = bool(states.source_finished)
        self.finished = done
        return WriteAction(SpeechSegment(tail, finished=done), finished=done)
