"""The trained S2ST stack in the port against JAX on the CPU, fp32: the
StreamSpeech model of ``runs/s2st3/60002`` and the CodeHiFiGAN unit vocoder
of ``runs/unit_vocoder/16000``, each restored once through the JAX
package's trainers' state and ``CheckpointManager`` and carried into the
port by ``load_jax_params``; then one ``S2STAgent`` session on a held-out
``FormantSpeechCorpus`` utterance, as JAX's ``cli simulate`` runs the
trained stack, and one ``hmt_learned`` ``S2TTAgent`` session (the trained
transition head as the READ/WRITE gate, as ``cli eval-s2st``'s
``hmt_learned`` row).  Skips, naming the path, if a checkpoint is missing."""

import json
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_generator import _gen
from test_torch_hmt import _equal_or_near_tie, _Tape
from test_torch_s2st import assert_within

from hifigan_tpu_torch.models.code_vocoder import CodeVocoder
from hifigan_tpu_torch.models.streamspeech import StreamSpeechS2ST
from hifigan_tpu_torch.streaming import agents as tagents
from hifigan_tpu_torch.streaming import harness as tharness
from hifigan_tpu_torch.streaming import runtime as trt
from hifigan_tpu_torch.weights import load_code_config, load_jax_params, load_streamspeech_config

ROOT = Path(__file__).resolve().parents[1]
S2ST = ROOT / "runs" / "s2st3" / "60002"
UNIT_VOCODER = ROOT / "runs" / "unit_vocoder" / "16000"
SEED = 0  # cli simulate's --seed: the held-out utterance


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _restore(directory: Path, state_fn):
    """The train state of ``directory`` restored into an ``eval_shape``
    template of ``state_fn()``."""
    from hifigan_tpu.train.checkpoint import CheckpointManager

    sharding = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    template = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=sharding),
                                      jax.eval_shape(state_fn))
    mgr = CheckpointManager(str(directory.parent))
    try:
        return mgr.restore(template, step=int(directory.name))
    finally:
        mgr.close()


@pytest.fixture(scope="module")
def stacks():
    """(JAX S2STInference, the port's S2STInference) over the trained weights."""
    for path in (S2ST, UNIT_VOCODER):
        if not (path / "default").is_dir():
            pytest.skip(f"the trained checkpoint {path.relative_to(ROOT)} is missing")
    from hifigan_tpu.cli import _load_streamspeech_config
    from hifigan_tpu.models.code_vocoder import CodeVocoder as JCodeVocoder
    from hifigan_tpu.models.code_vocoder import CodeVocoderConfig as JCodeConfig
    from hifigan_tpu.models.streamspeech import StreamSpeechConfig as JConfig
    from hifigan_tpu.models.streamspeech import StreamSpeechS2ST as JStreamSpeech
    from hifigan_tpu.streaming.runtime import S2STInference
    from hifigan_tpu.train import TrainConfig
    from hifigan_tpu.train.s2st_task import S2STTaskConfig, create_s2st_state
    from hifigan_tpu.train.unit_vocoder import UnitVocoderTaskConfig, create_unit_vocoder_state

    jcfg = _load_streamspeech_config(str(S2ST.parent / "streamspeech_config.json"), JConfig)
    state = _restore(S2ST, lambda: create_s2st_state(jax.random.PRNGKey(0), jcfg, S2STTaskConfig())[0])
    jmodel = JStreamSpeech(jcfg)
    with open(UNIT_VOCODER.parent / "code_config.json") as f:
        cd = json.load(f)
    task = UnitVocoderTaskConfig(code=JCodeConfig(**{**cd, "upsample_factors": tuple(cd["upsample_factors"])}))
    uv_state = _restore(UNIT_VOCODER,
                        lambda: create_unit_vocoder_state(jax.random.PRNGKey(0), TrainConfig(), task)[0])
    jcv = JCodeVocoder(task.code)
    jinf = S2STInference(jmodel, state.params, jcv, uv_state.gen_params)

    cfg = load_streamspeech_config(str(S2ST.parent / "streamspeech_config.json"))
    model = StreamSpeechS2ST(cfg, gen=_gen(), with_vocoder=False)
    code_vocoder = CodeVocoder(load_code_config(str(UNIT_VOCODER.parent / "code_config.json")), gen=_gen())
    load_jax_params(model, state.params)
    load_jax_params(code_vocoder, uv_state.gen_params)
    return jinf, trt.S2STInference(model.eval(), code_vocoder.eval())


@pytest.fixture(scope="module")
def utterance():
    """``cli simulate``'s held-out utterance for ``--seed 0``."""
    from hifigan_tpu.train.corpus import FormantSpeechCorpus

    return FormantSpeechCorpus(n_speakers=32).utterance(SEED % 32, 0, content=2_000_000 + SEED)


def test_trained_programs_match_jax(stacks, utterance):
    """The encoder program on the utterance's first 2.56 s (its CTC and
    T2U argmax streams equal), the decoder's logits for BOS + 6 tokens
    within 1e-4, and the unit vocoder on the units of that T2U stream:
    durations equal, the waveform within 1e-4."""
    from hifigan_tpu.streaming.features import OnlineFbank

    jinf, tinf = stacks
    extractor = OnlineFbank()
    extractor.push(utterance[:40960])
    mel = extractor.frames()
    want, got = jinf.encode_prefix(mel), tinf.encode_prefix(mel)
    for key in ("src_tokens", "tgt_tokens", "src_token_frames", "tgt_token_frames"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["unit_argmax"], want["unit_argmax"])
    assert_within(got["enc"].numpy(), np.asarray(want["enc"]), 1e-4, "trained encoder")
    tokens = np.array([[1] + got["tgt_tokens"][:6]])
    with torch.no_grad():
        logits = tinf.model.text_decoder(got["enc"], torch.from_numpy(tokens))
    want_logits = jinf.model.apply(jinf.params, want["enc"], tokens.astype(np.int32),
                                   method=lambda m, e, t: m.text_decoder(e, t))
    assert_within(logits.numpy(), np.asarray(want_logits), 1e-4, "trained decoder logits")
    units = np.array([tinf.units_from_prefix(got["unit_argmax"], 0)[0]])
    assert units.shape[1] >= 8, units.shape
    with torch.no_grad():
        wav, dur, n = tinf.code_vocoder(torch.from_numpy(units))
    jwav, jdur, jn = jinf._synth(jinf.code_params, units.astype(np.int32))
    np.testing.assert_array_equal(dur.numpy(), np.asarray(jdur))
    assert int(n[0]) == int(np.asarray(jn)[0]) and len(set(dur[0].tolist())) > 1
    assert_within(wav.numpy(), np.asarray(jwav), 1e-4, "trained unit vocoder")


def test_trained_s2st_session_equals_jax(stacks, utterance):
    """One ``S2STAgent`` session (encoder-fed units) over the utterance in
    320 ms segments: the same writes at the same source times, the same
    committed text ids and emitted unit ids, and each speech segment within
    1e-4; the session writes speech before the source ends."""
    jinf, tinf = stacks
    from hifigan_tpu.streaming import agents as jagents
    from hifigan_tpu.streaming import harness as jharness

    jagent, tagent = jagents.S2STAgent(jinf), tagents.S2STAgent(tinf)
    want = jharness.run_streaming_session(jagent, utterance, segment_size_ms=320)
    got = tharness.run_streaming_session(tagent, utterance, segment_size_ms=320)
    assert got.emission_source_seconds == want.emission_source_seconds
    assert tagent.committed_text_ids == jagent.committed_text_ids and tagent.committed_text_ids
    assert tagent.emitted_units == jagent.emitted_units and tagent.emitted_units
    assert any(t < got.source_seconds for t, s in zip(got.emission_source_seconds, got.outputs)
               if len(s.samples))
    for g, w in zip(got.outputs, want.outputs):
        assert g.finished == w.finished
        assert_within(g.samples, w.samples, 1e-4, "trained speech segment")
    assert got.average_lagging_ms == want.average_lagging_ms


def test_trained_hmt_learned_session_equals_jax(stacks, utterance, monkeypatch):
    """One ``S2TTAgent(decode="hmt", hmt_transition="learned")`` session
    over the utterance in 320 ms segments: the same writes at the same
    source times and the same committed ids, which write before the source
    ends, where the margins allow (``test_torch_hmt``'s rule: the runs may
    part only after a KV step whose closest decision lies within 10× the
    measured float error)."""
    jinf, tinf = stacks
    from hifigan_tpu.streaming import agents as jagents
    from hifigan_tpu.streaming import harness as jharness
    from hifigan_tpu.streaming import runtime as jrt

    jtape, ttape = _Tape(monkeypatch, jrt), _Tape(monkeypatch, trt)
    kw = dict(decode="hmt", hmt_transition="learned")
    jagent, tagent = jagents.S2TTAgent(jinf, **kw), tagents.S2TTAgent(tinf, **kw)
    want = jharness.run_streaming_session(jagent, utterance, segment_size_ms=320)
    got = tharness.run_streaming_session(tagent, utterance, segment_size_ms=320)
    equal = (got.emission_source_seconds == want.emission_source_seconds
             and tagent.committed_text_ids == jagent.committed_text_ids
             and [s.content for s in got.outputs] == [s.content for s in want.outputs])
    if _equal_or_near_tie("trained hmt_learned session", equal, jtape, ttape):
        assert tagent.committed_text_ids and got.average_lagging_ms == want.average_lagging_ms
        assert any(t < got.source_seconds for t in got.emission_source_seconds)


def test_trained_checkpoints_stay_unchanged(stacks):
    out = subprocess.run(["git", "status", "--porcelain", "runs/"], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=60)
    assert out.stdout == ""
