"""The port's beam and HMT programs, continuations and agent sessions
against the JAX package's ``S2STInference`` on the CPU, fp32, at
``TINY_SS``/``TINY_CODE`` widths (the S2ST trainer's tree: with the
transition head).

Weights: the JAX initialisers' draw moved by N(0, 0.05²) (``jitter``), as
the greedy sessions of ``test_torch_streaming.py``; the unit vocoder is
``_code_pair``'s.

Token sequences are discrete decisions from continuous scores: the HMT
gate ``p ≥ 0.5``, the ``argpartition`` boundary and the candidates' order.
They are held equal where every decision's margin exceeds 10× the float
error measured between the two packages' scores in the same run; where
the two runs part at a step whose closest decision lies within that, the
comparison is counted and printed as a near tie (``[margin]``, read with
``pytest -s``) instead of failing."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_code_vocoder import TINY_CODE, _code_pair
from test_torch_s2st import TINY_SS, _s2st_pair, assert_within

from hifigan_tpu.streaming import agents as jagents
from hifigan_tpu.streaming import beam as jbeam
from hifigan_tpu.streaming import harness as jharness
from hifigan_tpu.streaming import incremental as jinc
from hifigan_tpu.streaming import runtime as jrt
from hifigan_tpu_torch.streaming import agents as tagents
from hifigan_tpu_torch.streaming import beam as tbeam
from hifigan_tpu_torch.streaming import harness as tharness
from hifigan_tpu_torch.streaming import incremental as tinc
from hifigan_tpu_torch.streaming import runtime as trt
from hifigan_tpu_torch.train.data import SyntheticSpeechDataset

# tests/test_streaming.py's tiny_inference config
INFERENCE = dict(source_buckets=(32, 64, 128, 256), max_target_len=16, max_new_tokens=4)
AUDIO = SyntheticSpeechDataset(segment_samples=16000)[3]  # 1 s of pseudo-speech
PROGRAM_TOL = 1e-5  # of each output's peak
WRITE_THRESHOLD, BEAM = 0.5, 4  # continue_text_hmt's defaults


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    """(JAX S2STInference, the port's) on one jittered tree with the
    transition head, and the unit vocoder pair.  The draw of the greedy
    sessions' pair (seed 8): there the learned gate writes before the
    source ends and the confidence gate asks to read, so both paths of a
    policy call run (at seed 12 the learned head's write probability stays
    under 0.5 until the end, and the sessions of both gates are one)."""
    jm, params, tm = _s2st_pair(TINY_SS, 8, vocoder=False, transition_head=True, draw="init_jitter")
    jcv_m, cv_params, tcv_m = _code_pair(TINY_CODE, 9)
    jinf = jrt.S2STInference(jm, params, jcv_m, cv_params, jrt.S2STInferenceConfig(**INFERENCE))
    tinf = trt.S2STInference(tm, tcv_m, trt.S2STInferenceConfig(**INFERENCE))
    return jinf, tinf


@pytest.fixture(scope="module")
def encoded(pair):
    """JAX's encoder output over 40 frames of noise (S = 64, the bucket):
    the programs take the same memory in both packages."""
    jinf, _ = pair
    mel = (np.random.default_rng(30).standard_normal((40, 80)) * 0.5).astype(np.float32)
    jenc = jinf.encode_prefix(mel)["enc"]
    return jenc, torch.from_numpy(np.array(jenc))


def _peak(got, want, what):
    want = np.asarray(want)
    assert_within(np.asarray(got), want, PROGRAM_TOL * float(np.abs(want).max()), what)


def test_scorers_match_jax(pair, encoded):
    """``_decode_logprobs``, ``_decode_logprobs_hmt`` and
    ``_decode_scores_hmt`` (log-probs and write probabilities) over 8 rows
    of 16 tokens with 8 distinct read lengths; 1e-5 of each peak."""
    jinf, tinf = pair
    jenc, enc = encoded
    g = np.random.default_rng(31)
    tokens = g.integers(3, TINY_SS["vocab_size"], (8, 16)).astype(np.int32)
    tokens[:, 0] = 1
    reads = np.array([1, 5, 8, 13, 24, 33, 40, 64], np.int32)
    tt, tr = torch.from_numpy(tokens).long(), torch.from_numpy(reads).long()
    _peak(tinf._decode_logprobs(enc, tt).numpy(), jinf._decode_logprobs(jinf.params, jenc, tokens),
          "_decode_logprobs")
    _peak(tinf._decode_logprobs_hmt(enc, tt, tr).numpy(),
          jinf._decode_logprobs_hmt(jinf.params, jenc, tokens, reads), "_decode_logprobs_hmt")
    lp, wp = tinf._decode_scores_hmt(enc, tt, tr)
    jlp, jwp = jinf._decode_scores_hmt(jinf.params, jenc, tokens, reads)
    _peak(lp.numpy(), jlp, "_decode_scores_hmt log-probs")
    _peak(wp.numpy(), jwp, "_decode_scores_hmt write probabilities")
    assert 0.05 < float(np.asarray(jwp).min()) and float(np.asarray(jwp).max()) < 0.95  # a live gate
    # the read mask matters: another read length moves the scores
    assert float(np.abs(np.asarray(jlp)[0] - np.asarray(jlp)[-1]).max()) > 1e-3


@pytest.mark.parametrize("learned", [False, True], ids=["confidence", "learned"])
def test_hmt_prefill_and_kv_step_match_jax(pair, encoded, learned):
    """``_hmt_prefill`` of 4 rows of 16 tokens under 4 read lengths (its
    cache), then two KV steps at 16 rows gathered by parent under 16
    distinct read lengths: log-probs, write probabilities and the cache;
    1e-5 of each peak.  The step's rows are copies (``gather_beams``); the
    cross K/V are broadcast views."""
    jinf, tinf = pair
    jenc, enc = encoded
    g = np.random.default_rng(32 + learned)
    tokens = g.integers(3, TINY_SS["vocab_size"], (BEAM, 16)).astype(np.int32)
    tokens[:, 0] = 1
    reads0 = np.array([1, 9, 17, 40], np.int32)
    jckv = jinf._cross_kv(jinf.params, jenc)
    ckv = tinc.cross_kv(tinf.model.text_decoder, enc)
    jcache = jinf._hmt_prefill(jinf.params, jckv, tokens, jinc.init_cache(jinf.decoder_spec, BEAM, 16), reads0)
    cache = tinf._hmt_prefill(ckv, torch.from_numpy(tokens).long(), tinc.init_cache(tinf.decoder_spec, BEAM, 16),
                              torch.from_numpy(reads0).long())
    _peak(cache.k.numpy(), jcache.k, "_hmt_prefill cache k")
    _peak(cache.v.numpy(), jcache.v, "_hmt_prefill cache v")
    jcache, cache = jinc.with_index(jcache, 5), tinc.with_index(cache, 5)
    step = jinf._hmt_kv_step_learned if learned else jinf._hmt_kv_step_conf
    for i in range(2):
        parents = (np.arange(16) // 4 if i == 0 else g.permutation(16)).astype(np.int32)
        last = g.integers(3, TINY_SS["vocab_size"], 16).astype(np.int32)
        reads = np.sort(g.choice(np.arange(1, 65), 16, replace=False)).astype(np.int32)
        jlp, jwp, jcache = step(jinf.params, jckv, jcache, last, parents, reads)
        lp, wp, cache = tinf._hmt_kv_step(ckv, cache, *(torch.from_numpy(a).long() for a in (last, parents, reads)),
                                          learned=learned)
        _peak(lp.numpy(), jlp, f"KV step {i} log-probs")
        if learned:
            _peak(wp.numpy(), jwp, f"KV step {i} write probabilities")
        else:
            assert wp is None and jwp is None
        assert cache.index == int(jcache.index) == 6 + i
        _peak(cache.k.numpy(), jcache.k, f"KV step {i} cache k")
    assert cache.k.shape[1] == 16 and cache.k.data_ptr() != ckv[0].data_ptr()
    bcast = trt._bcast_ckv(ckv, 16)
    assert bcast[0].shape[1] == 16 and bcast[0].data_ptr() == ckv[0].data_ptr()  # expand: no copy


def test_beam_step_matches_jax(pair, encoded):
    """``_prefill_lp`` over 5 rows of the seed and two ``_beam_step``s with
    reordered parents; 1e-5 of each peak."""
    jinf, tinf = pair
    jenc, enc = encoded
    buf = np.zeros((5, 16), np.int32)
    buf[:, :4] = [1, 7, 9, 4]
    jckv = jinf._cross_kv(jinf.params, jenc)
    ckv = tinc.cross_kv(tinf.model.text_decoder, enc)
    jlp, jcache = jinf._prefill_lp(jinf.params, jckv, buf, jinc.init_cache(jinf.decoder_spec, 5, 16))
    lp, cache = tinf._prefill_lp(ckv, torch.from_numpy(buf).long(), tinc.init_cache(tinf.decoder_spec, 5, 16))
    _peak(lp.numpy(), jlp, "_prefill_lp")
    jcache, cache = jinc.with_index(jcache, 4), tinc.with_index(cache, 4)
    for parents, toks in (([0, 0, 0, 0, 0], [5, 6, 7, 8, 9]), ([3, 1, 1, 0, 4], [10, 11, 12, 13, 14])):
        parents, toks = np.array(parents, np.int32), np.array(toks, np.int32)
        jlp, jcache = jinf._beam_step(jinf.params, jckv, jcache, toks, parents)
        lp, cache = tinf._beam_step(ckv, cache, torch.from_numpy(toks).long(), torch.from_numpy(parents).long())
        _peak(lp.numpy(), jlp, "_beam_step")


# ---- discrete decisions: equal where the margins allow --------------------

NEAR_TIES = []  # (what, step, margin, float error)


class _Tape:
    """Records every KV HMT step (inputs and outputs) of one package."""

    def __init__(self, monkeypatch, module):
        self.calls = []
        orig = module._HmtKvStepper.step

        def step(stepper, last, parents, reads):
            lp, wp = orig(stepper, last, parents, reads)
            self.calls.append((np.array(last), np.array(parents), np.array(reads), np.asarray(lp),
                               None if wp is None else np.asarray(wp)))
            return lp, wp

        monkeypatch.setattr(module._HmtKvStepper, "step", step)


def _margin(lp, wp) -> float:
    """The closest decision a step's scores feed: the gate (write
    probability, or the top token's probability with and without EOS,
    against the threshold) and, per row, the gaps between the top
    ``BEAM + 2`` log-probs (the ``argpartition`` boundary and the order of
    the candidates)."""
    lp = np.asarray(lp, np.float64)
    gates = [wp] if wp is not None else [np.exp(lp.max(-1)), np.exp(np.delete(lp, 2, axis=-1).max(-1))]
    m = min(float(np.abs(np.asarray(p, np.float64) - WRITE_THRESHOLD).min()) for p in gates)
    top = -np.sort(-lp, axis=-1)[:, : BEAM + 2]
    return min(m, float(np.abs(np.diff(top, axis=-1)).min()))


def _parting(jtape, ttape):
    """(float error of the shared steps, index of the first step whose
    inputs differ, or None)."""
    err = 0.0
    for i, (a, b) in enumerate(zip(jtape.calls, ttape.calls)):
        if any(not np.array_equal(x, y) for x, y in zip(a[:3], b[:3])):
            return err, i
        err = max(err, float(np.abs(a[3][np.isfinite(a[3])] - b[3][np.isfinite(b[3])]).max()))
        if a[4] is not None:
            err = max(err, float(np.abs(a[4] - b[4]).max()))
    return err, None if len(jtape.calls) == len(ttape.calls) else min(len(jtape.calls), len(ttape.calls))


def _equal_or_near_tie(what, equal: bool, jtape, ttape) -> bool:
    """True when the outputs are equal; False (counted and printed) when
    the runs part at a step whose closest decision lies within 10× the
    measured float error; fails otherwise."""
    err, at = _parting(jtape, ttape)
    print(f"[margin] {what}: {len(jtape.calls)} KV steps, float error {err:.3g}, equal {equal}")
    if equal:
        return True
    assert at is not None and at > 0, f"{what}: the outputs differ although every KV step's inputs were equal"
    m = _margin(*jtape.calls[at - 1][3:])
    assert m <= 10 * err, f"{what}: the runs part after KV step {at - 1}, whose closest decision is {m:.3g} > 10 × {err:.3g}"
    NEAR_TIES.append((what, at, m, err))
    print(f"[margin] {what}: near tie after KV step {at - 1}: margin {m:.3g}, float error {err:.3g}")
    return False


def _same_state(got, want) -> bool:
    def key(h):
        return (h.tokens, h.num_read, h.reads, h.finished, h.row)

    return (got.need_read == want.need_read and [key(h) for h in got.beams] == [key(h) for h in want.beams]
            and [key(h) for h in got.finished] == [key(h) for h in want.finished]
            and all(abs(g.score - w.score) < 1e-4 for g, w in zip(got.beams + got.finished,
                                                                  want.beams + want.finished)))


def _prefix_encodings(jinf, tinf):
    """Each package's encoding of 24, 40 and 56 frames of one noise mel: a
    growing source, three policy calls."""
    mel = (np.random.default_rng(33).standard_normal((56, 80)) * 0.5).astype(np.float32)
    return [(jinf.encode_prefix(mel[:n]), tinf.encode_prefix(mel[:n])) for n in (24, 40, 56)]


@pytest.mark.parametrize("kv_cached", [True, False], ids=["kv", "uncached"])
def test_continue_text_beam_equals_jax(pair, kv_cached):
    """``continue_text_beam`` over three growing source prefixes, each call
    continuing the last one's tokens (EOS dropped): equal tokens."""
    jinf, tinf = pair
    prefix = []
    for jenc, tenc in _prefix_encodings(jinf, tinf):
        want = jinf.continue_text_beam(jenc["enc"], prefix, beam_size=3, max_new_tokens=4, kv_cached=kv_cached)
        got = tinf.continue_text_beam(tenc["enc"], prefix, beam_size=3, max_new_tokens=4, kv_cached=kv_cached)
        assert got == want and got, (prefix, got, want)
        prefix = prefix + [t for t in got if t != tinf.cfg.eos_id]


@pytest.mark.parametrize("transition", ["confidence", "learned"])
@pytest.mark.parametrize("kv_cached", [True, False], ids=["kv", "uncached"])
def test_continue_text_hmt_equals_jax(pair, monkeypatch, transition, kv_cached):
    """``continue_text_hmt`` over three policy calls on a growing source
    (24, 40 frames open; 56 finished), resuming the state: the same
    beams, reads and ``need_read`` after each call (scores within 1e-4),
    where the margins allow."""
    jinf, tinf = pair
    jtape, ttape = _Tape(monkeypatch, jrt), _Tape(monkeypatch, trt)
    jst = tst = None
    for i, (jenc, tenc) in enumerate(_prefix_encodings(jinf, tinf)):
        kw = dict(src_len=jenc["valid_frames"], source_finished=i == 2, transition=transition, kv_cached=kv_cached)
        jst = jinf.continue_text_hmt(jenc["enc"], [5], state=jst, **kw)
        tst = tinf.continue_text_hmt(tenc["enc"], [5], state=tst, **kw)
        if not _same_state(tst, jst):
            assert kv_cached, f"uncached {transition} call {i}: the states differ"
            assert not _equal_or_near_tie(f"continue_text_hmt {transition} call {i}", False, jtape, ttape)
            return
    assert tst.best().tokens and (jtape.calls or not kv_cached)
    if kv_cached:
        _equal_or_near_tie(f"continue_text_hmt {transition}", True, jtape, ttape)


SESSIONS = {f"{agent}_{transition}{'_whole_words' if ww else ''}": (agent, transition, ww)
            for agent in ("S2TTAgent", "S2STAgent") for transition in ("confidence", "learned")
            for ww in (False, True)}


@pytest.mark.parametrize("name", list(SESSIONS))
def test_hmt_session_equals_jax(pair, monkeypatch, name):
    """One ``decode="hmt"`` session over 1 s of pseudo-speech in 320 ms
    segments, per agent, gate and whole-word setting: the same writes at
    the same source times, committed ids and emitted units, and each speech
    segment within 1e-4, where the margins allow."""
    jinf, tinf = pair
    cls, transition, whole_words = SESSIONS[name]
    kw = dict(decode="hmt", hmt_transition=transition, whole_words=whole_words)
    if whole_words:
        kw["token_text"] = lambda i: f"▁w{i}" if i % 3 else f"c{i}"
    jtape, ttape = _Tape(monkeypatch, jrt), _Tape(monkeypatch, trt)
    jagent, tagent = getattr(jagents, cls)(jinf, **kw), getattr(tagents, cls)(tinf, **kw)
    want = jharness.run_streaming_session(jagent, AUDIO, segment_size_ms=320)
    got = tharness.run_streaming_session(tagent, AUDIO, segment_size_ms=320)
    equal = (got.emission_source_seconds == want.emission_source_seconds
             and tagent.committed_text_ids == jagent.committed_text_ids
             and tagent.emitted_units == jagent.emitted_units
             and [getattr(s, "content", None) for s in got.outputs] == [getattr(s, "content", None)
                                                                       for s in want.outputs])
    if not _equal_or_near_tie(name, equal, jtape, ttape):
        return
    assert tagent.committed_text_ids and len(got.outputs) > 1 and jtape.calls
    if transition == "learned":
        assert any(t < got.source_seconds for t in got.emission_source_seconds), "no write before the source ended"
    for g, w in zip(got.outputs, want.outputs):
        assert g.finished == w.finished
        if isinstance(g, tharness.SpeechSegment):
            assert_within(g.samples, w.samples, 1e-4, f"{name} speech segment")
    if cls == "S2STAgent":
        assert tagent.emitted_units and len(got.waveform) > 0
        assert got.average_lagging_ms == want.average_lagging_ms


class _ScriptedInference:
    """Stands in for ``S2STInference`` in the agent's HMT bookkeeping: each
    ``continue_text_hmt`` call records what it was given (the prefix, the
    source, whether a state was resumed and which beams it kept, the token
    budget) and returns the next scripted state."""

    def __init__(self, beam_mod, script):
        self.cfg = SimpleNamespace(max_target_len=16, max_new_tokens=4, eos_id=2)
        self.device = "cpu"
        self.beam, self.script, self.calls = beam_mod, list(script), []

    def new_session(self):
        return None

    def continue_text_hmt(self, enc, prefix, *, src_len, source_finished, state, max_new_tokens, transition):
        kept = None if state is None else sorted(tuple(b.tokens) for b in state.beams + state.finished)
        self.calls.append((list(prefix), src_len, source_finished, kept, max_new_tokens, transition))
        hyps = [self.beam.HmtHypothesis(list(t), score, 1, [1] * len(t), finished=f) for t, score, f in self.script.pop(0)]
        return self.beam.HmtBeamState(beams=[h for h in hyps if not h.finished], finished=[h for h in hyps if h.finished])


# (budget, source finished, the state continue_text_hmt returns: (tokens beyond its prefix, score, finished))
HMT_SCRIPT = [
    (2, False, [([5, 6, 7, 8], -1.0, False), ([5, 9], -2.0, False)]),       # more than the budget: capped
    (3, False, [([5, 6, 7, 8, 10], -1.0, False), ([5, 9, 3], -0.5, False)]),  # the best disagrees with the text
    (1, False, [([4, 4], -3.0, False)]),                                     # nothing agrees: the state restarts
    (4, False, [([7, 11, 12], -0.3, False), ([7, 11], -0.1, True)]),
    (None, True, [([7, 11, 13, 2], -0.4, True), ([7, 11, 14], -2.0, False)]),  # the drain, to EOS
]


@pytest.mark.parametrize("whole_words", [False, True])
def test_hmt_agent_bookkeeping_equals_jax(whole_words):
    """``S2TTAgent._advance_text_hmt`` over a scripted sequence of beam
    states, in both packages: the same calls to ``continue_text_hmt``
    (prefix, resumed beams after pruning by the emitted text, token
    budget), the same committed ids, base prefix and EOS flags."""
    outcomes = []
    for agents, harness, beam_mod in ((jagents, jharness, jbeam), (tagents, tharness, tbeam)):
        inf = _ScriptedInference(beam_mod, [step[2] for step in HMT_SCRIPT])
        agent = agents.S2TTAgent(inf, decode="hmt", hmt_transition="learned", whole_words=whole_words,
                                 token_text=lambda i: f"▁w{i}" if i % 3 else f"c{i}")
        steps = []
        for i, (budget, finished, _) in enumerate(HMT_SCRIPT):
            states = harness.AgentStates(source_samples=np.zeros(1, np.float32), source_finished=finished)
            new_ids, hit_eos = agent._advance_text_hmt(states, {"enc": None, "valid_frames": 8 * (i + 1)}, budget)
            steps.append((list(new_ids), hit_eos, list(agent.committed_text_ids), list(agent.hmt_base)))
        outcomes.append((steps, inf.calls))
    assert outcomes[1] == outcomes[0]
    steps, calls = outcomes[1]
    assert steps[0][0] == ([] if whole_words else [5, 6]) and steps[-1][1] and steps[-1][2]
    assert any(c[3] for c in calls[1:])  # a state resumed after pruning
    assert whole_words or any(c[3] is None for c in calls[1:])  # and one restarted


def test_hmt_agent_rejects_unknown_options(pair):
    _, tinf = pair
    with pytest.raises(ValueError, match="decode"):
        tagents.S2TTAgent(tinf, decode="beam")
    with pytest.raises(ValueError, match="hmt_transition"):
        tagents.S2STAgent(tinf, decode="hmt", hmt_transition="oracle")
