"""The port's beam searches (``hifigan_tpu_torch/streaming/beam.py``, host
numpy) against the JAX package's on the same seeded score tables: every
search gives the same hypotheses (tokens, reads, read pointers, rows,
finished flags and ``need_read``) and scores within 1e-6; and the JAX
package's own behavioural cases (``tests/test_beam.py``) on the port."""

import numpy as np
import pytest

from hifigan_tpu.streaming import beam as jbeam
from hifigan_tpu_torch.streaming import beam as tbeam

V, P, R = 12, 10, 6  # vocabulary, positions and read buckets of the tables
BOS, EOS = 1, 2


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


class _Tables:
    """Seeded log-prob and write-logit tables: the next token's
    distribution depends on the token at a position, the one before it,
    the position and the read length (bucketed)."""

    def __init__(self, seed):
        g = np.random.default_rng(seed)
        self.lp = _log_softmax(g.standard_normal((V, V, R, P, V)) * 2.0)
        self.gate = (1.0 / (1.0 + np.exp(-g.standard_normal((V, V, R, P)) * 2.0))).astype(np.float32)

    def score(self, tokens, read_lens=None, learned=False):
        """``[N, L]`` tokens (and ``[N]`` read lengths) → log-probs ``[N, L,
        V]`` (and write probabilities ``[N, L]``)."""
        tokens = np.asarray(tokens)
        n, length = tokens.shape
        prev = np.concatenate([np.zeros((n, 1), tokens.dtype), tokens[:, :-1]], 1) % V
        r = np.zeros(n, np.int64) if read_lens is None else np.minimum(np.asarray(read_lens), R - 1)
        idx = (tokens % V, prev, r[:, None], np.arange(length)[None] % P)
        return (self.lp[idx], self.gate[idx]) if learned else self.lp[idx]


class _Stepper:
    """A KV-cached scorer of the ``prefill``/``step`` protocol: each row
    carries a hash of its history, reordered by ``parents`` at each step."""

    def __init__(self, tables, learned, beam_rows, step_rows):
        self.t, self.learned = tables, learned
        self.beam_rows, self.step_rows = beam_rows, step_rows
        self.h = None
        self.calls = 0

    def prefill(self, tokens, read_lens, n):
        self.h = (tokens[:, : max(n - 1, 0)].sum(1) * 7 + np.asarray(read_lens)) % V

    def step(self, last, parents, read_lens):
        self.calls += 1
        self.h = (self.h[parents] * 5 + last) % V
        r = np.minimum(np.asarray(read_lens), R - 1)
        idx = (np.asarray(last) % V, self.h, r, np.full(len(last), self.calls % P))
        return self.t.lp[idx], (self.t.gate[idx] if self.learned else None)


def _same_hyps(got, want, fields):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in fields:
            assert getattr(g, f) == getattr(w, f), (f, g, w)
        assert abs(g.score - w.score) <= 1e-6, (g.score, w.score)


BEAM_CASES = [dict(beam_size=b, max_new_tokens=m, max_len=ml, length_penalty=lpn, forbidden_ids=fb)
              for b, m, ml, lpn, fb in [(1, 6, 12, 1.0, ()), (3, 6, 12, 1.0, ()), (5, 8, 9, 0.6, (0,)),
                                        (4, 12, 10, 1.2, (0, 5))]]


@pytest.mark.parametrize("case", range(len(BEAM_CASES)))
def test_beam_search_equals_jax(case):
    """``beam_search`` over three seeded tables and prefixes."""
    kw = BEAM_CASES[case]
    for seed in range(3):
        t = _Tables(seed)
        prefix = list(np.random.default_rng(seed).integers(3, V, seed))
        want = jbeam.beam_search(t.score, prefix=prefix, bos_id=BOS, eos_id=EOS, **kw)
        got = tbeam.beam_search(t.score, prefix=prefix, bos_id=BOS, eos_id=EOS, **kw)
        _same_hyps(got, want, ("tokens", "finished", "row"))
        if kw["beam_size"] == 1:
            assert (tbeam.greedy_equivalent(t.score, prefix=prefix, bos_id=BOS, eos_id=EOS,
                                            max_new_tokens=kw["max_new_tokens"], max_len=kw["max_len"])
                    == jbeam.greedy_equivalent(t.score, prefix=prefix, bos_id=BOS, eos_id=EOS,
                                               max_new_tokens=kw["max_new_tokens"], max_len=kw["max_len"]))


@pytest.mark.parametrize("case", range(len(BEAM_CASES)))
def test_kv_beam_search_equals_jax(case):
    """``kv_beam_search`` with a history-hashing ``step_fn`` whose rows are
    reordered by the parents it is given."""
    kw = BEAM_CASES[case]
    for seed in range(3):
        t = _Tables(10 + seed)
        results = []
        for mod in (jbeam, tbeam):
            s = _Stepper(t, False, kw["beam_size"], kw["beam_size"])
            s.prefill(np.full((kw["beam_size"], 4), 3), np.ones(kw["beam_size"], np.int64), 3)
            results.append(mod.kv_beam_search(t.lp[3, 1, 0, seed], lambda tok, par: s.step(tok, par, par * 0)[0],
                                              seed_len=3, eos_id=EOS, **kw))
        _same_hyps(results[1], results[0], ("tokens", "finished", "row"))


HMT_FIELDS = ("tokens", "num_read", "reads", "finished", "row")


def _same_state(got, want):
    assert got.need_read == want.need_read
    _same_hyps(got.beams, want.beams, HMT_FIELDS)
    _same_hyps(got.finished, want.finished, HMT_FIELDS)


@pytest.mark.parametrize("protocol", ["confidence", "learned", "stepper_confidence", "stepper_learned"])
def test_hmt_beam_search_equals_jax(protocol):
    """``hmt_beam_search`` under both scorer protocols and both gates, fresh
    and resumed over three calls (2 then 4 source positions, then the whole
    source, finished), with two prefixes and two write thresholds: the
    states equal after every call."""
    learned = protocol.endswith("learned")
    kw = dict(beam_size=3, cands_per_token=3, read_stride=1, max_new_tokens=4, max_len=P, bos_id=BOS,
              eos_id=EOS, read_penalty=0.1)
    for seed in range(4):
        t = _Tables(20 + seed)
        prefix = [3 + seed] if seed % 2 else []
        states = [None, None]
        for src_len, finished in ((2, False), (4, False), (6, True)):
            for i, mod in enumerate((jbeam, tbeam)):
                if protocol.startswith("stepper"):
                    call = dict(score_fn=None, stepper=_Stepper(t, learned, 3, 9))
                else:
                    call = dict(score_fn=lambda tok, r: t.score(tok, r, learned))
                states[i] = mod.hmt_beam_search(**call, prefix=prefix, src_len=src_len, source_finished=finished,
                                                state=states[i], write_threshold=0.35 + 0.1 * (seed % 2), **kw)
            _same_state(states[1], states[0])
            assert states[1].best().tokens == states[0].best().tokens


# The JAX package's own cases (tests/test_beam.py), on the port.

def _toy_score_fn(transition_logits):
    """A Markov chain: the next token's logits depend on the current one."""
    n = transition_logits.shape[0]

    def score(tokens):
        out = np.full(tokens.shape + (n,), -1e9, np.float32)
        for i in range(tokens.shape[0]):
            for pos in range(tokens.shape[1]):
                logits = transition_logits[tokens[i, pos] % n]
                out[i, pos] = logits - np.log(np.exp(logits).sum())
        return out

    return score


def test_beam_finds_higher_probability_path():
    T = np.full((5, 5), -10.0, np.float32)
    T[1, 3], T[1, 4] = 2.0, 1.9  # from BOS token 3 looks better than 4...
    T[3] = 0.0                   # ...but leads to a flat distribution
    T[3, 2] = 0.1
    T[4, 2] = 3.0                # while 4 reaches EOS with confidence
    score = _toy_score_fn(T)
    greedy = tbeam.beam_search(score, prefix=[], beam_size=1, max_new_tokens=3, max_len=8, bos_id=1, eos_id=2)
    wide = tbeam.beam_search(score, prefix=[], beam_size=3, max_new_tokens=3, max_len=8, bos_id=1, eos_id=2)
    assert greedy[0].tokens[0] == 3
    assert wide[0].tokens[0] == 4 and wide[0].tokens[-1] == 2
    assert wide[0].score > greedy[0].score


def test_beam_prefix_continuation():
    T = np.full((5, 5), -10.0, np.float32)
    T[3, 4], T[4, 2] = 5.0, 5.0
    hyps = tbeam.beam_search(_toy_score_fn(T), prefix=[3], beam_size=2, max_new_tokens=2, max_len=8, bos_id=1,
                             eos_id=2)
    assert hyps[0].tokens == [4, 2]  # the continuation only


def test_partial_encoder_mask():
    m = tbeam.partial_encoder_mask(10, 4)
    assert m.shape == (1, 1, 1, 10) and m[..., :4].all() and not m[..., 4:].any()
    assert np.array_equal(m, jbeam.partial_encoder_mask(10, 4))


OVOCAB = 32
TGT = [11, 14, 17, 13, 19]    # the right target
DECOY = [21, 24, 27, 23, 29]  # what a premature policy writes


def _oracle_score_fn(lookahead=2):
    """Target position t is predictable only once ``read >= t +
    lookahead``; before that a decoy looks mildly confident."""

    def score(tokens, read_lens):
        n, length = tokens.shape
        out = np.full((n, length, OVOCAB), np.log(0.001), np.float32)
        for i in range(n):
            r = int(read_lens[i])
            for pos in range(length):
                if pos < len(TGT):
                    if r >= pos + lookahead:
                        out[i, pos, TGT[pos]] = np.log(0.9)
                    else:
                        out[i, pos, DECOY[pos]] = np.log(0.55)
                        out[i, pos, TGT[pos]] = np.log(0.05)
                else:
                    out[i, pos, EOS] = np.log(0.95)
        return out

    return score


def test_hmt_beam_beats_greedy_waitk():
    score = _oracle_score_fn()
    greedy = []
    for t in range(len(TGT)):  # wait-1 greedy: writes from the shortest read prefix
        tokens = np.zeros((1, 16), np.int32)
        tokens[0, 0] = BOS
        tokens[0, 1:1 + t] = greedy[:t]
        greedy.append(int(score(tokens, np.array([t + 1]))[0, t].argmax()))
    assert greedy == DECOY
    state = tbeam.hmt_beam_search(score, prefix=[], src_len=len(TGT) + 2, source_finished=True, beam_size=3,
                                  cands_per_token=4, max_new_tokens=10, max_len=16, bos_id=BOS, eos_id=EOS,
                                  write_threshold=0.6)
    best = state.best()
    toks = best.tokens[:-1] if best.tokens and best.tokens[-1] == EOS else best.tokens
    assert toks == TGT
    assert all(b <= a for b, a in zip(best.reads, best.reads[1:])) and best.reads[0] >= 2


def test_hmt_beam_resumes_across_policy_calls():
    score = _oracle_score_fn()
    kw = dict(beam_size=2, cands_per_token=4, max_new_tokens=10, max_len=16, bos_id=BOS, eos_id=EOS,
              write_threshold=0.6)
    st = tbeam.hmt_beam_search(score, prefix=[], src_len=3, source_finished=False, **kw)
    assert st.need_read and st.best().tokens == TGT[:2]
    st2 = tbeam.hmt_beam_search(score, prefix=[], src_len=len(TGT) + 2, source_finished=True, state=st, **kw)
    best = st2.best()
    assert (best.tokens[:-1] if best.tokens[-1] == EOS else best.tokens) == TGT


def test_hmt_eos_suppressed_until_source_finished():
    st = tbeam.hmt_beam_search(_oracle_score_fn(lookahead=0), prefix=list(TGT), src_len=len(TGT) + 2,
                               source_finished=False, beam_size=2, max_new_tokens=4, max_len=16, bos_id=BOS,
                               eos_id=EOS)
    assert all(EOS not in h.tokens for h in st.beams + st.finished)
