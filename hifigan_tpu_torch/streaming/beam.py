"""Beam search over the text decoder: prefix continuation, the KV-cached
beam, and the HMT-class simultaneous beam with read positions.

Counterpart of ``hifigan_tpu/streaming/beam.py``.  Host-side numpy: each
search asks a scorer (a decoder call on the device) for the log-probs of
all its rows at once and keeps the top-k bookkeeping on the host.  The
bookkeeping is the JAX package's, step for step: the same
``np.argpartition`` calls, the same candidate order, the same sorts and
ties, so that the two packages can differ only where their scores do.

* :func:`beam_search` re-scores every live beam's whole buffer each step;
* :func:`kv_beam_search` takes the next-token log-probs of a prefilled
  cache and a ``step_fn`` that reorders the cache rows by parent;
* :func:`hmt_beam_search` scores every beam at several candidate read
  positions (the source masked to each row's prefix), decides READ or
  WRITE per state by a gate (the top token's probability, or a learned
  transition head's write probability), and is resumable across policy
  calls: when no state may write with the source read so far it returns
  ``need_read`` instead of writing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Tuple

import numpy as np


@dataclass
class BeamHypothesis:
    tokens: List[int]
    score: float  # summed log-prob
    finished: bool = False
    row: int = 0  # the KV-cache row of this hypothesis (kv_beam_search)

    def normalized_score(self, length_penalty: float) -> float:
        n = max(1, len(self.tokens))
        return self.score / (n**length_penalty)


def partial_encoder_mask(total_len: int, prefix_len: int) -> np.ndarray:
    """The cross-attention mask ``[1, 1, 1, total_len]`` that shows only the
    first ``prefix_len`` source positions (a mask, so shapes stay fixed)."""
    m = np.zeros((1, 1, 1, total_len), dtype=bool)
    m[..., :prefix_len] = True
    return m


def beam_search(
    score_fn: Callable[[np.ndarray], np.ndarray],
    *,
    prefix: List[int],
    beam_size: int = 5,
    max_new_tokens: int = 32,
    max_len: int = 128,
    bos_id: int = 1,
    eos_id: int = 2,
    length_penalty: float = 1.0,
    forbidden_ids: Tuple[int, ...] = (),
) -> List[BeamHypothesis]:
    """Beam search continuing BOS + ``prefix``.

    ``score_fn(tokens [N, max_len]) → log-probs [N, max_len, V]`` is a
    causal decoder (position ``i`` scores token ``i + 1``).  Returns the
    hypotheses sorted by normalised score; their ``tokens`` are the
    continuation beyond the prefix."""
    seed = [bos_id] + list(prefix)
    beams: List[BeamHypothesis] = [BeamHypothesis([], 0.0)]
    finished: List[BeamHypothesis] = []

    for step in range(max_new_tokens):
        live = [b for b in beams if not b.finished]
        if not live:
            break
        tokens = np.zeros((len(live), max_len), np.int32)
        pos = []
        for bi, b in enumerate(live):
            seq = (seed + b.tokens)[:max_len]
            tokens[bi, : len(seq)] = seq
            pos.append(len(seq) - 1)
        logprobs = np.asarray(score_fn(tokens))  # [N, L, V]
        candidates: List[BeamHypothesis] = []
        for bi, b in enumerate(live):
            lp = logprobs[bi, pos[bi]]
            if forbidden_ids:
                lp = lp.copy()
                lp[list(forbidden_ids)] = -np.inf
            top = np.argpartition(-lp, beam_size)[: beam_size + 1]
            for tok in top:
                cand = BeamHypothesis(b.tokens + [int(tok)], b.score + float(lp[tok]))
                if int(tok) == eos_id or len(seed) + len(cand.tokens) >= max_len:
                    cand.finished = True
                    finished.append(cand)
                else:
                    candidates.append(cand)
        candidates.sort(key=lambda h: h.normalized_score(length_penalty), reverse=True)
        beams = candidates[:beam_size]
        # stop once the best finished hypothesis beats the best live one
        if finished and beams:
            best_fin = max(h.normalized_score(length_penalty) for h in finished)
            if best_fin >= beams[0].normalized_score(length_penalty) and step > 0:
                break
    result = finished + beams
    result.sort(key=lambda h: h.normalized_score(length_penalty), reverse=True)
    return result


def kv_beam_search(
    first_logprobs: np.ndarray,
    step_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
    *,
    seed_len: int,
    beam_size: int = 5,
    max_new_tokens: int = 32,
    max_len: int = 128,
    eos_id: int = 2,
    length_penalty: float = 1.0,
    forbidden_ids: Tuple[int, ...] = (),
) -> List[BeamHypothesis]:
    """The KV-cached beam search.  The caller prefilled the seed into a
    ``[beam_size, max_len]`` cache (every row the same) and gives
    ``first_logprobs [V]``, the next-token log-probs after the seed, and
    ``step_fn(tokens [beam], parents [beam]) → log-probs [beam, V]``, which
    reorders the cache rows by ``parents`` (a copy), writes ``tokens`` and
    returns each row's next-token log-probs.  The bookkeeping is
    :func:`beam_search`'s.  Returns the hypotheses sorted by normalised
    score; their ``tokens`` are the continuation beyond the seed."""

    def masked(lp: np.ndarray) -> np.ndarray:
        if forbidden_ids:
            lp = lp.copy()
            lp[list(forbidden_ids)] = -np.inf
        return lp

    finished: List[BeamHypothesis] = []
    beams: List[BeamHypothesis] = []
    lp0 = masked(np.asarray(first_logprobs))
    for tok in np.argpartition(-lp0, min(beam_size, lp0.size - 1))[: beam_size + 1]:
        cand = BeamHypothesis([int(tok)], float(lp0[tok]), row=0)
        if int(tok) == eos_id or seed_len + 1 >= max_len:
            cand.finished = True
            finished.append(cand)
        else:
            beams.append(cand)
    beams.sort(key=lambda h: h.score, reverse=True)
    beams = beams[:beam_size]

    for step in range(1, max_new_tokens):
        if not beams:
            break
        tokens = np.zeros(beam_size, np.int32)
        parents = np.zeros(beam_size, np.int32)
        for i, b in enumerate(beams):
            tokens[i] = b.tokens[-1]
            parents[i] = b.row
        logprobs = np.asarray(step_fn(tokens, parents))  # [beam, V]
        candidates: List[BeamHypothesis] = []
        for i, b in enumerate(beams):
            lp = masked(logprobs[i])
            top = np.argpartition(-lp, min(beam_size, lp.size - 1))[: beam_size + 1]
            for tok in top:
                cand = BeamHypothesis(b.tokens + [int(tok)], b.score + float(lp[tok]), row=i)
                if int(tok) == eos_id or seed_len + len(cand.tokens) >= max_len:
                    cand.finished = True
                    finished.append(cand)
                else:
                    candidates.append(cand)
        candidates.sort(key=lambda h: h.normalized_score(length_penalty), reverse=True)
        beams = candidates[:beam_size]
        if finished and beams:
            best_fin = max(h.normalized_score(length_penalty) for h in finished)
            if best_fin >= beams[0].normalized_score(length_penalty) and step > 0:
                break
    result = finished + beams
    result.sort(key=lambda h: h.normalized_score(length_penalty), reverse=True)
    return result


def greedy_equivalent(score_fn, **kw) -> List[int]:
    """Beam size 1: greedy decoding through :func:`beam_search`."""
    hyps = beam_search(score_fn, beam_size=1, **kw)
    return hyps[0].tokens if hyps else []


@dataclass
class HmtHypothesis:
    tokens: List[int]          # the continuation beyond the committed prefix
    score: float               # joint log-prob, read penalties included
    num_read: int              # source positions read so far (never falls)
    reads: List[int]           # the read position at which each token was written
    finished: bool = False
    row: int = 0               # the KV-cache row (stepper mode)

    def normalized_score(self, length_penalty: float) -> float:
        n = max(1, len(self.tokens))
        return self.score / (n**length_penalty)


@dataclass
class HmtBeamState:
    """The decode state carried from one policy call to the next."""

    beams: List[HmtHypothesis]
    finished: List[HmtHypothesis]
    need_read: bool = False    # every live beam wants source not yet received

    def best(self, length_penalty: float = 1.0) -> HmtHypothesis:
        pool = self.finished + self.beams
        return max(pool, key=lambda h: h.normalized_score(length_penalty))


def hmt_beam_search(
    score_fn,
    *,
    stepper=None,
    prefix: List[int],
    src_len: int,
    source_finished: bool,
    state: "HmtBeamState | None" = None,
    beam_size: int = 4,
    cands_per_token: int = 4,
    read_stride: int = 1,
    max_new_tokens: int = 32,
    max_len: int = 128,
    bos_id: int = 1,
    eos_id: int = 2,
    write_threshold: float = 0.5,
    read_penalty: float = 0.1,
    length_penalty: float = 1.0,
    min_read: int = 1,
) -> HmtBeamState:
    """One resumable pass of the HMT beam.

    Args:
      score_fn: ``(tokens [N, max_len], read_lens [N]) → log-probs [N,
        max_len, V]``, the decoder with row ``i``'s source masked to
        ``read_lens[i]`` positions; or ``→ (log-probs, write_probs [N,
        max_len])``, and then the learned transition head's write
        probability is the READ/WRITE gate in place of the top token's
        probability.
      stepper: a KV-cached scorer in place of ``score_fn`` (the
        ``prefill(tokens, read_lens, n)`` / ``step(last_tokens, parents,
        read_lens) → (log-probs [R, V], write_probs [R] or None)`` protocol
        with ``beam_rows`` and ``step_rows``, as ``runtime._HmtKvStepper``).
      prefix: the committed target tokens, without BOS; the hypotheses
        continue beyond them.
      src_len: the source positions received so far; no read passes it.
      source_finished: while False, EOS is suppressed and the pass may end
        with ``need_read`` instead of writing a token below the gate.
      state: the state of the previous pass, resumed.

    Returns the updated :class:`HmtBeamState`.
    """
    seed = [bos_id] + list(prefix)
    if state is None:
        state = HmtBeamState(
            beams=[HmtHypothesis([], 0.0, min(max(1, min_read), max(1, src_len)), [])],
            finished=[],
        )
    state.need_read = False
    prefilled = False
    if source_finished:
        # the whole source is in hand, so reading all of it costs nothing;
        # otherwise a beam whose gate defers writes climbs to src_len at
        # (cands_per_token − 1)·read_stride a step and spends the budget
        for b in state.beams + state.finished:
            b.num_read = max(b.num_read, src_len)

    for _ in range(max_new_tokens):
        live = [b for b in state.beams if not b.finished]
        if not live:
            break
        # each beam's candidate read positions: num_read, + stride, ...
        # (clamped), the last one all of the source received
        row_meta = []  # (beam index, read_len)
        if stepper is not None:
            if not prefilled:
                n = min(len(seed) + len(live[0].tokens), max_len)
                toks = np.zeros((stepper.beam_rows, max_len), np.int32)
                reads0 = np.ones(stepper.beam_rows, np.int32)
                for bi, b in enumerate(live):
                    seq = (seed + b.tokens)[:max_len]
                    toks[bi, : len(seq)] = seq
                    reads0[bi] = max(1, b.num_read)
                    b.row = bi
                stepper.prefill(toks, reads0, n)
                prefilled = True
            R = stepper.step_rows
            last_toks = np.zeros(R, np.int32)
            parents = np.zeros(R, np.int32)
            rows_read = np.ones(R, np.int64)
            for bi, b in enumerate(live):
                seq = (seed + b.tokens)[:max_len]
                for k in range(cands_per_token):
                    r = (src_len if k == cands_per_token - 1
                         else min(src_len, b.num_read + k * read_stride))
                    row = bi * cands_per_token + k
                    last_toks[row] = seq[-1]
                    parents[row] = b.row
                    rows_read[row] = max(1, r)
                    row_meta.append((bi, r))
            logprobs, write_probs = stepper.step(last_toks, parents, rows_read)
        else:
            rows_tokens = np.zeros((len(live) * cands_per_token, max_len), np.int32)
            rows_read = np.zeros(len(live) * cands_per_token, np.int64)
            for bi, b in enumerate(live):
                seq = (seed + b.tokens)[:max_len]
                for k in range(cands_per_token):
                    r = (src_len if k == cands_per_token - 1
                         else min(src_len, b.num_read + k * read_stride))
                    row = bi * cands_per_token + k
                    rows_tokens[row, : len(seq)] = seq
                    rows_read[row] = max(1, r)
                    row_meta.append((bi, r))
            scored = score_fn(rows_tokens, rows_read)
            write_probs = None
            if isinstance(scored, tuple):
                logprobs, write_probs = scored
                logprobs = np.asarray(logprobs)
                write_probs = np.asarray(write_probs)
            else:
                logprobs = np.asarray(scored)
        pos = [min(len(seed + b.tokens), max_len) - 1 for b in live]

        candidates: List[HmtHypothesis] = []
        beam_confident = [False] * len(live)
        for row, (bi, r) in enumerate(row_meta):
            b = live[bi]
            if stepper is not None:
                lp = logprobs[row].copy()
            else:
                lp = logprobs[row, pos[bi]].copy()
            if not source_finished:
                lp[eos_id] = -np.inf
            if write_probs is not None:
                # the learned transition gate p(write | state, read prefix)
                p_gate = (float(write_probs[row]) if stepper is not None
                          else float(write_probs[row, pos[bi]]))
            else:
                p_gate = float(np.exp(lp.max()))
            fully_read = r >= src_len
            confident = p_gate >= write_threshold or (fully_read and source_finished)
            if confident:
                beam_confident[bi] = True
            elif not fully_read:
                continue  # this state would rather READ: no writes from it
            elif not source_finished:
                continue  # it would need source not yet received
            top = np.argpartition(-lp, min(beam_size + 1, lp.size - 1))[: beam_size + 1]
            for tok in top:
                if not np.isfinite(lp[tok]):
                    continue
                cand = HmtHypothesis(
                    b.tokens + [int(tok)],
                    b.score + float(lp[tok]) - read_penalty * (r - b.num_read),
                    r,
                    b.reads + [r],
                    row=row,
                )
                if int(tok) == eos_id or len(seed) + len(cand.tokens) >= max_len:
                    cand.finished = True
                candidates.append(cand)

        if not candidates:
            # every live beam wants more source than has arrived
            if not source_finished:
                state.need_read = True
                return state
            break

        # a beam none of whose states passed the gate still moves its read
        # pointer, so that the next pass looks further into the source
        for bi, conf in enumerate(beam_confident):
            if not conf:
                live[bi].num_read = min(src_len, live[bi].num_read + cands_per_token * read_stride)

        candidates.sort(key=lambda h: h.normalized_score(length_penalty), reverse=True)
        new_beams: List[HmtHypothesis] = []
        for cand in candidates:
            if cand.finished:
                state.finished.append(cand)
            else:
                new_beams.append(cand)
            if len(new_beams) >= beam_size:
                break
        if not new_beams:
            break
        state.beams = new_beams
        if state.finished:
            best_fin = max(h.normalized_score(length_penalty) for h in state.finished)
            if best_fin >= state.beams[0].normalized_score(length_penalty):
                break
    return state
