"""The port's streaming S2ST runtime against the JAX one on the CPU, fp32,
at ``TINY_SS``/``TINY_CODE`` widths: the online fbank, the host-side
decode, policy and harness copies, the KV-cached decoder (against the full
decoder, and through a retraction and an idempotent re-step), and whole
sessions of every agent over the same audio, which must commit the same
token and unit ids, with the same durations, at the same source times, and
emit the same waveform within 1e-4.  Also ``cli simulate`` on the CPU and
the greedy-only rule.

Weights: the decoder's every leaf is redrawn by ``_randomise``.  The
sessions' S2ST model is the JAX initialisers' draw with every leaf moved by
N(0, 0.05²) (``jitter``): redrawn by ``_randomise``, its biases and
LayerNorm offsets swamp the input, the decoder writes one token over and
over and the CTC heads emit one token a session, so a session could not
tell a port that ignores its input from one that does not.  The unit
vocoder is ``_code_pair``'s (``_randomise`` with its durations spread)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_code_vocoder import TINY_CODE, _code_pair
from test_torch_generator import _gen, _randomise
from test_torch_s2st import TINY_SS, _s2st_pair, assert_within

from hifigan_tpu.models import streamspeech as jss
from hifigan_tpu.streaming import agents as jagents
from hifigan_tpu.streaming import decode as jdecode
from hifigan_tpu.streaming import features as jfeat
from hifigan_tpu.streaming import harness as jharness
from hifigan_tpu.streaming import incremental as jinc
from hifigan_tpu.streaming import runtime as jrt
from hifigan_tpu_torch import cli
from hifigan_tpu_torch.models import streamspeech as tss
from hifigan_tpu_torch.streaming import agents as tagents
from hifigan_tpu_torch.streaming import decode as tdecode
from hifigan_tpu_torch.streaming import features as tfeat
from hifigan_tpu_torch.streaming import harness as tharness
from hifigan_tpu_torch.streaming import incremental as tinc
from hifigan_tpu_torch.streaming import runtime as trt
from hifigan_tpu_torch.train.data import SyntheticSpeechDataset
from hifigan_tpu_torch.weights import load_jax_params, save_s2st_checkpoint

# tests/test_streaming.py's tiny_inference config
INFERENCE = dict(source_buckets=(32, 64, 128, 256), max_target_len=16, max_new_tokens=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cmvn,src_rate,push", [("none", 16000, 1111), ("utterance", 16000, 5120),
                                                ("utterance", 22050, 7056)])
def test_online_fbank_matches_jax(cmvn, src_rate, push):
    """1.5 s of noise pushed in pieces (one of them resampled from 22.05
    kHz) into both extractors: each push returns the same number of frames,
    and all frames agree within 2e-4 (log-mel values of magnitude up to
    about 20; with CMVN, unit scale)."""
    audio = (np.random.default_rng(1).standard_normal(int(1.5 * src_rate)) * 0.1).astype(np.float32)
    cfg = dict(cmvn=cmvn)
    want = jfeat.OnlineFbank(jfeat.FbankConfig(**cfg), src_rate=src_rate)
    got = tfeat.OnlineFbank(tfeat.FbankConfig(**cfg), src_rate=src_rate, device="cpu")
    for start in range(0, len(audio), push):
        piece = audio[start: start + push]
        assert got.push(piece).shape == want.push(piece).shape
    assert got.num_frames == want.num_frames > 140
    assert_within(got.frames(), want.frames(), 2e-4, f"fbank {cmvn} {src_rate} Hz")


def test_host_modules_equal_jax():
    """The port's copies of the host-only modules give JAX's results: CTC
    collapse and prefix continuation with pause reinsertion, whole-word
    trimming, both policies, and a session's Average Lagging."""
    g = np.random.default_rng(2)
    for _ in range(20):
        ids = g.integers(0, 4, 60) * (g.random(60) < 0.6)
        assert tdecode.ctc_greedy_collapse(ids) == jdecode.ctc_greedy_collapse(ids)
        for gap in (None, 3, 8):
            for prefix in (0, 2):
                assert (tdecode.ctc_prefix_frames(ids, prefix, silence_gap=gap)
                        == jdecode.ctc_prefix_frames(ids, prefix, silence_gap=gap))
    for words in (["▁he", "llo", "▁wor", "ld"], ["llo"], ["▁a"], []):
        assert tdecode.trim_to_whole_words(words) == jdecode.trim_to_whole_words(words)
    from hifigan_tpu.streaming import policy as jpolicy
    from hifigan_tpu_torch.streaming import policy as tpolicy
    tp, jp = tpolicy.StreamSpeechPolicy(2, 1, 1), jpolicy.StreamSpeechPolicy(2, 1, 1)
    tw, jw = tpolicy.WaitKPolicy(3, 2, 1, 2, 5), jpolicy.WaitKPolicy(3, 2, 1, 2, 5)
    for n in range(12):
        assert tp.should_write(n, n + 1, source_finished=False) == jp.should_write(n, n + 1, source_finished=False)
        if n % 3 == 0:
            tp.committed(n, n)
            jp.committed(n, n)
        assert tw.subword_budget(n, source_finished=False) == jw.subword_budget(n, source_finished=False)
        assert tw.unit_budget(n, source_finished=False) == jw.unit_budget(n, source_finished=False)
    outs = [tharness.TextSegment("a b"), tharness.TextSegment(""), tharness.TextSegment("c d e")]
    jouts = [jharness.TextSegment(s.content) for s in outs]
    for times in ([0.2, 0.5, 1.0], [0.0, 0.0, 0.3]):
        assert (tharness.SessionResult(outs, times, 1.0).average_lagging_ms
                == jharness.SessionResult(jouts, times, 1.0).average_lagging_ms)
    speech = [tharness.SpeechSegment(np.zeros(n, np.float32)) for n in (3200, 0, 6400)]
    jspeech = [jharness.SpeechSegment(s.samples) for s in speech]
    assert (tharness.SessionResult(speech, [0.3, 0.6, 0.9], 0.9).average_lagging_ms
            == jharness.SessionResult(jspeech, [0.3, 0.6, 0.9], 0.9).average_lagging_ms)


HID, HEADS, LAYERS, VOCAB, MAXLEN = 32, 4, 2, 50, 24  # tests/test_incremental.py's decoder


@pytest.fixture(scope="module")
def decoder():
    """JAX's and the port's SimultaneousTextDecoder on one ``_randomise``d
    tree, and 12 frames of memory."""
    mem = np.random.default_rng(3).standard_normal((1, 12, HID)).astype(np.float32)
    jm = jss.SimultaneousTextDecoder(HID, VOCAB, LAYERS, HEADS)
    params = _randomise(jm.init(jax.random.PRNGKey(1), mem, np.zeros((1, MAXLEN), np.int32)), 3)
    tm = load_jax_params(tss.SimultaneousTextDecoder(HID, VOCAB, LAYERS, HEADS, gen=_gen()), params)
    return jm, params, tm, mem


def test_prefill_and_decode_step_match_the_full_decoder(decoder):
    """``prefill`` over 24 tokens and ``decode_step`` token by token give
    the full decoder's logits (the port's and JAX's) within 1e-5, and JAX's
    incremental logits within 1e-5; the cache index advances on the host."""
    jm, params, tm, mem = decoder
    tokens = np.random.default_rng(4).integers(0, VOCAB, (1, MAXLEN))
    mem_t, tok_t = torch.from_numpy(mem), torch.from_numpy(tokens)
    spec = tinc.DecoderSpec.of(tm)
    jspec = jinc.DecoderSpec(LAYERS, HEADS, HID, VOCAB)
    with torch.no_grad():
        full = tm(mem_t, tok_t).numpy()
        ckv = tinc.cross_kv(tm, mem_t)
        logits, cache = tinc.prefill(tm, ckv, tok_t, tinc.init_cache(spec, 1, MAXLEN))
        full_feats = tm(mem_t, tok_t, return_features=True)[1].numpy()
        step_cache = tinc.init_cache(spec, 1, MAXLEN)
        steps, feats = [], []
        for i in range(MAXLEN):
            step_logits, step_cache, step_feats = tinc.decode_step(tm, ckv, step_cache, tok_t[:, i],
                                                                   return_features=True)
            steps.append(step_logits.numpy())
            feats.append(step_feats.numpy())
    assert step_cache.index == MAXLEN and cache.index == 0
    jfull = np.asarray(jm.apply(params, mem, tokens.astype(np.int32)))
    jckv = jinc.cross_kv(params["params"], jspec, mem)
    jlogits, _ = jinc.prefill(params["params"], jspec, jckv, tokens.astype(np.int32),
                              jinc.init_cache(jspec, 1, MAXLEN))
    assert_within(full, jfull, 1e-5, "full decoder")
    assert_within(logits.numpy(), full, 1e-5, "prefill vs full")
    assert_within(logits.numpy(), jlogits, 1e-5, "prefill vs JAX prefill")
    assert_within(np.stack(steps, 1), full, 1e-5, "decode_step vs full")
    assert_within(np.stack(feats, 1), full_feats, 1e-5, "decode_step features vs full")
    assert_within(cache.k.numpy(), step_cache.k.numpy(), 1e-5, "prefill vs decode_step cache")


def test_gather_beams_reorders_the_batch(decoder):
    """``gather_beams`` takes each row of the cache from its parent row and
    keeps the index; decoding on from the gathered cache equals decoding
    the parents' rows."""
    _, _, tm, mem = decoder
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, VOCAB, (3, 6)))
    parent = torch.tensor([2, 0, 2])
    with torch.no_grad():
        ckv = tinc.cross_kv(tm, torch.from_numpy(mem).expand(3, -1, -1))
        _, cache = tinc.prefill(tm, ckv, tokens, tinc.init_cache(tinc.DecoderSpec.of(tm), 3, MAXLEN))
        gathered = tinc.gather_beams(tinc.with_index(cache, 6), parent)
        assert gathered.index == 6 and torch.equal(gathered.k, cache.k[:, parent])
        logits = tinc.decode_step(tm, ckv, gathered, torch.tensor([7, 7, 7]))[0]
        want = tm(torch.from_numpy(mem).expand(3, -1, -1), torch.cat([tokens[parent], torch.full((3, 1), 7)], 1))
    assert_within(logits.numpy(), want[:, -1].numpy(), 1e-5, "decode after gather_beams")


@pytest.fixture(scope="module")
def inference_pair():
    """The JAX S2STInference (``cli simulate``'s init form: vocoder, no
    transition head) and the port's, on the same ``_randomise``d trees."""
    jm, params, tm = _s2st_pair(TINY_SS, 8, vocoder=True, transition_head=False, draw="init_jitter")
    jcv_m, cv_params, tcv_m = _code_pair(TINY_CODE, 9)
    jinf = jrt.S2STInference(jm, params, jcv_m, cv_params, jrt.S2STInferenceConfig(**INFERENCE))
    tinf = trt.S2STInference(tm, tcv_m, trt.S2STInferenceConfig(**INFERENCE))
    return jinf, tinf


AUDIO = SyntheticSpeechDataset(segment_samples=16000)[3]  # 1 s of pseudo-speech, the same rows as JAX's
AGENTS = {
    "asr": ("ASRAgent", {}),
    "s2tt": ("S2TTAgent", {}),
    "s2tt_whole_words": ("S2TTAgent", {"whole_words": True, "token_text": lambda i: f"▁w{i}" if i % 3 else f"c{i}"}),
    "s2st_encoder": ("S2STAgent", {"units_from": "encoder"}),
    "s2st_decoder": ("S2STAgent", {"units_from": "decoder"}),
    "waitk_s2tt": ("WaitkS2TTAgent", {"k1": 2}),
    "waitk_s2st": ("WaitkS2STAgent", {"k1": 1, "k2": 0, "unit_per_subword": 4}),
}
# JAX's wait-k text agent writes one token a call after the source ends
# until EOS, past max_target_len (ROADMAP Queue 3): cap its session
MAX_STEPS = 60


@pytest.mark.parametrize("name", list(AGENTS))
def test_session_equals_jax(inference_pair, name):
    """One session of each agent over the same second of pseudo-speech in
    320 ms segments: the same writes (content, source time, finished flag),
    committed text ids and emitted unit ids, the same durations of the
    emitted units, and each speech segment's samples within 1e-4."""
    jinf, tinf = inference_pair
    cls, kw = AGENTS[name]
    jagent, tagent = getattr(jagents, cls)(jinf, **kw), getattr(tagents, cls)(tinf, **kw)
    want = jharness.run_streaming_session(jagent, AUDIO, segment_size_ms=320, max_steps=MAX_STEPS)
    got = tharness.run_streaming_session(tagent, AUDIO, segment_size_ms=320, max_steps=MAX_STEPS)
    assert len(got.outputs) == len(want.outputs) > 1, name
    assert got.emission_source_seconds == want.emission_source_seconds
    assert any(t < got.source_seconds for t in got.emission_source_seconds), "no write before the source ended"
    for g, w in zip(got.outputs, want.outputs):
        assert type(g).__name__ == type(w).__name__ and g.finished == w.finished
        if isinstance(g, tharness.TextSegment):
            assert g.content == w.content
        else:
            assert_within(g.samples, w.samples, 1e-4, f"{name} speech segment")
    assert tagent.committed_text_ids == jagent.committed_text_ids
    assert tagent.emitted_units == jagent.emitted_units
    if name.startswith("asr"):
        assert tagent.committed_src == jagent.committed_src and tagent.committed_src
    if "s2st" in name:
        assert tagent.emitted_units and len(got.waveform) > 0
        units = np.asarray(tagent.emitted_units)[None]
        with torch.no_grad():
            dur = tinf.code_vocoder(torch.from_numpy(units))[1].numpy()
        np.testing.assert_array_equal(dur, np.asarray(jinf._synth(jinf.code_params, units.astype(np.int32))[1]))
        assert got.average_lagging_ms == want.average_lagging_ms
    elif name != "asr":
        assert tagent.committed_text_ids


def test_session_sync_keeps_retraction_and_restep_results(inference_pair):
    """The port writes the cache in place.  ``DecoderSession.sync`` must
    still give the logits of a fresh full decode: after growing by one
    token, after a jump (prefill), after a retraction to a diverged prefix
    and after an idempotent re-step of an unchanged sequence, which must
    also leave the cache's valid rows as they were; 1e-5."""
    _, tinf = inference_pair
    mel = (np.random.default_rng(11).standard_normal((40, 80)) * 0.5).astype(np.float32)
    enc = tinf.encode_prefix(mel)["enc"]
    decoder, session = tinf.model.text_decoder, tinf.new_session()
    with torch.no_grad():
        ckv = tinc.cross_kv(decoder, enc)
        for seq in ([1], [1, 5], [1, 5, 7, 9, 11], [1, 5, 8], [1, 5, 8], [1, 5, 8, 3], [1, 6, 2, 4]):
            before = session.cache.k[:, :, :len(seq)].clone() if session.tokens == seq else None
            got = session.sync(ckv, seq)
            want = decoder(enc, torch.tensor([seq]))[:, -1]
            assert_within(got.numpy(), want.numpy(), 1e-5, f"sync {seq}")
            assert session.tokens == seq and session.cache.index == len(seq)
            if before is not None:
                assert torch.equal(session.cache.k[:, :, :len(seq)], before)


def test_continue_text_cached_equals_uncached(inference_pair):
    """On 40 frames: the KV-cached greedy continuation equals the plain
    one (the full decoder per token) and JAX's, also on the next call with
    the committed prefix and after a retraction to a diverged prefix."""
    jinf, tinf = inference_pair
    mel = (np.random.default_rng(10).standard_normal((40, 80)) * 0.5).astype(np.float32)
    enc, jenc = tinf.encode_prefix(mel), jinf.encode_prefix(mel)
    session, jsession = tinf.new_session(), jinf.new_session()
    for prefix, n in (([], 6), (None, 4), ([5, 8], 3), ([5, 8, 11, 3, 4], 5)):
        if prefix is None:
            prefix = [t for t in cached if t != tinf.cfg.eos_id]
        plain = tinf.continue_text(enc["enc"], prefix, max_new_tokens=n)
        cached = tinf.continue_text(enc["enc"], prefix, max_new_tokens=n, session=session)
        want = jinf.continue_text(jenc["enc"], prefix, max_new_tokens=n, session=jsession)
        assert plain == cached == want and cached, prefix


def test_s2tt_drains_in_one_call_at_the_end_of_the_source(inference_pair):
    """With the whole source given as finished, the S2TT agent writes the
    rest of the text in one policy call, and the next ends the session (as
    JAX's agent does)."""
    jinf, tinf = inference_pair
    actions = []
    for inf, mod, harness in ((tinf, tagents, tharness), (jinf, jagents, jharness)):
        agent = mod.S2TTAgent(inf)
        states = harness.AgentStates(source_samples=AUDIO, source_finished=True)
        first, second = agent.policy(states), agent.policy(states)
        actions.append((first.segment.content, second.segment.content, second.finished,
                        list(agent.committed_text_ids)))
    assert actions[0] == actions[1]
    assert len(actions[0][3]) > INFERENCE["max_new_tokens"] and actions[0][2]


def test_hmt_decoding_raises():
    for cls in (tagents.S2TTAgent, tagents.S2STAgent):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            cls(None, decode="hmt")


def test_cli_simulate_on_the_cpu(capsys, tmp_path):
    """``cli simulate --tiny --device cpu`` prints JAX's summary keys, and
    ``--checkpoint`` with the same models saved gives the same session."""
    cli.main(["simulate", "--tiny", "--device", "cpu"])
    tiny = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(tiny) == {"agent", "source_seconds", "writes", "text", "output_samples", "average_lagging_ms",
                         "wall_s"}
    assert tiny["agent"] == "s2st" and tiny["source_seconds"] == 1.0 and tiny["writes"] > 1
    assert tiny["output_samples"] > 0
    from hifigan_tpu_torch.entry import build_s2st_inference
    inf = build_s2st_inference(*cli._tiny_s2st_configs(), device="cpu")
    save_s2st_checkpoint(str(tmp_path / "s2st.pt"), inf.model, inf.code_vocoder)
    cli.main(["simulate", "--checkpoint", str(tmp_path / "s2st.pt"), "--device", "cpu"])
    restored = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: v for k, v in restored.items() if k != "wall_s"} == {k: v for k, v in tiny.items() if k != "wall_s"}
