"""The port's translation app (``hifigan_tpu_torch/app``) on the CPU: every
behaviour ``tests/test_app.py`` checks in the JAX package, held to the JAX
package's own output where the two compute the same host function (the
settings, the WAV codec, the VAD, the trim and the ring buffer, equal bit
for bit), the engine's graceful degradation (no HF model can be loaded
here), the offline manager, and the stdlib server over a real socket on
port 0.  The TTS's vocoder route runs the port's ``make_vocoder_synth``
over a seeded train state: ``/api/synthesize/text`` answers with the WAV of
``make_vocoder_synth(mel)`` for the mel of SpeechT5's stage (a test double
here).  Both packages raise ``FileNotFoundError`` for a vocoder directory
with no checkpoint (ROADMAP Queue 3)."""

import base64
import dataclasses
import json
import urllib.error
import urllib.request
from dataclasses import replace

import numpy as np
import pytest
import torch

from hifigan_tpu.app import audio as jaudio
from hifigan_tpu.app import config as jconfig
from hifigan_tpu_torch import TrainConfig, create_train_state
from hifigan_tpu_torch.app import audio as taudio
from hifigan_tpu_torch.app.config import Settings, load_config, settings_from_json
from hifigan_tpu_torch.app.engine import RealTimeTranslationEngine, TranslationMode, make_vocoder_synth
from hifigan_tpu_torch.app.offline import OfflineManager
from hifigan_tpu_torch.app.server import StdlibServer
from hifigan_tpu_torch.train.checkpoint import CheckpointManager

SR = 16000


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the vocoder route runs many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _noise(seed, n, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _voiced(n):
    t = np.arange(n, dtype=np.float32)
    return (0.4 * np.sin(2 * np.pi * 180 * t / SR) * (1 + 0.4 * np.sin(2 * np.pi * 4 * t / SR))).astype(np.float32)


# ---- settings ----


def test_settings_env_overrides(monkeypatch):
    monkeypatch.setenv("HIFIGAN_TPU_PORT", "9999")
    monkeypatch.setenv("HIFIGAN_TPU_SOURCE_LANG", "es")
    monkeypatch.setenv("HIFIGAN_TPU_USE_TPU", "false")
    monkeypatch.setenv("HIFIGAN_TPU_MAX_DURATION_S", "12.5")
    got, want = Settings().with_env_overrides(), jconfig.Settings().with_env_overrides()
    assert got.web.port == 9999 and got.translation.source_lang == "es"
    assert got.models.use_tpu is False and got.audio.max_duration_s == 12.5
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_settings_from_json_equal_jax_yaml(tmp_path, monkeypatch):
    """A JSON file and JAX's YAML file of the same keys give the same
    settings; unknown keys and sections are ignored; the environment still
    wins."""
    monkeypatch.setenv("HIFIGAN_TPU_HOST", "0.0.0.0")
    raw = {"web": {"port": 1234, "cors_origins": ["http://a"], "bogus": 1},
           "audio": {"sample_rate": 22050}, "models": {"vocoder_checkpoint": "ckpt"},
           "translation": {"beam_size": 3}, "other": {"x": 1}}
    (tmp_path / "app.json").write_text(json.dumps(raw))
    (tmp_path / "app.yaml").write_text(
        "\n".join(f"{sec}:\n" + "\n".join(f"  {k}: {json.dumps(v)}" for k, v in keys.items())
                  for sec, keys in raw.items()) + "\n")
    got, want = settings_from_json(str(tmp_path / "app.json")), jconfig.settings_from_yaml(str(tmp_path / "app.yaml"))
    assert (got.web.port, got.audio.sample_rate, got.web.host, got.models.vocoder_checkpoint) == (
        1234, 22050, "0.0.0.0", "ckpt")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert load_config(str(tmp_path / "app.json")) == raw


def test_yaml_config_raises_naming_json(tmp_path):
    (tmp_path / "app.yaml").write_text("web:\n  port: 1\n")
    with pytest.raises(ValueError, match="JSON"):
        settings_from_json(str(tmp_path / "app.yaml"))


# ---- audio ----


def test_wav_roundtrip_matches_jax():
    audio = _noise(0, 1600) * 4  # some samples past ±1: clipped
    data = taudio.float_to_wav_bytes(audio, SR)
    assert data == jaudio.float_to_wav_bytes(audio, SR)
    back, sr = taudio.wav_bytes_to_float(data)
    assert sr == SR
    np.testing.assert_array_equal(back, jaudio.wav_bytes_to_float(data)[0])
    np.testing.assert_allclose(back, np.clip(audio, -1, 1), atol=1e-3)


def test_vad_segments_utterance_as_jax():
    """1 s of voiced signal, then 1 s of silence: the utterance is released
    at the silence, the same samples as JAX's processor releases."""
    speech, silence = _voiced(SR), np.zeros(SR, np.float32)
    got, want = taudio.AudioProcessor(), jaudio.AudioProcessor()
    assert got.process_chunk(speech) is None and want.process_chunk(speech) is None
    utt = got.process_chunk(silence)
    assert utt is not None and len(utt) > 0
    np.testing.assert_array_equal(utt, want.process_chunk(silence))
    for chunk in (_noise(1, 480), _voiced(4800)):
        assert got.is_speech_frame(chunk) == want.is_speech_frame(chunk)


def test_trim_and_preprocess_match_jax():
    sig = np.concatenate([np.zeros(SR // 2, np.float32),
                          0.5 * np.sin(np.linspace(0, 440 * 2 * np.pi, SR)).astype(np.float32),
                          np.zeros(SR // 2, np.float32)])
    trimmed = taudio.AudioProcessor().trim_silence(sig)
    assert SR * 0.9 <= len(trimmed) < len(sig)
    np.testing.assert_array_equal(trimmed, jaudio.AudioProcessor().trim_silence(sig))
    np.testing.assert_array_equal(taudio.AudioProcessor().preprocess(sig, 22050),
                                  jaudio.AudioProcessor().preprocess(sig, 22050))


def test_stream_ring_buffer():
    stream = taudio.RealTimeAudioStream(max_chunks=3)
    assert stream.get_audio().shape == (0,)
    for i in range(5):
        stream.add_chunk(np.full(10, float(i), np.float32))
    audio = stream.get_audio()
    assert len(stream) == 3 and audio[0] == 2.0  # the oldest two chunks evicted
    assert [c.shape for c in taudio.chunk_audio(audio, 12)] == [(12,), (12,), (6,)]
    stream.clear()
    assert len(stream) == 0


# ---- engine ----


@pytest.fixture(scope="module")
def engine():
    # no HF model can be loaded here: every stage degrades
    return RealTimeTranslationEngine("en", "es", device="cpu")


def test_engine_degrades_gracefully(engine):
    info = engine.get_model_info()
    assert {"asr", "mt", "tts"} <= set(info)
    assert not any(info[k]["available"] for k in ("asr", "mt", "tts"))
    assert info["tts"]["uses_framework_vocoder"] is False
    result = engine.translate_text("hello world")
    assert result.translated_text == "hello world"  # identity fallback
    assert result.mode == TranslationMode.TEXT_ONLY
    heard = []
    audio_result = engine.translate_audio(_noise(2, 8000, 0.1), on_transcript=heard.append)
    assert audio_result.source_text == "" and heard == [""]  # ASR unavailable
    assert audio_result.audio.size == 0 and audio_result.processing_time > 0
    assert engine.synthesize_text("hola").audio.size == 0  # TTS unavailable: silence


def test_engine_streaming_buffers(engine):
    for i in range(4):
        r = engine.process_streaming_audio(_noise(3 + i, 1024, 0.1))
        assert r.mode == TranslationMode.STREAMING
    flushed = engine.flush_streaming_buffers()
    assert flushed.mode == TranslationMode.STREAMING and flushed.audio is None
    assert engine.streaming_asr.flush() is None  # the buffer was emptied


def test_engine_switch_languages(engine):
    src, tgt = engine.source_lang, engine.target_lang
    engine.switch_languages()
    assert (engine.source_lang, engine.target_lang) == (tgt, src)
    assert engine.mt.forward.model_name == "Helsinki-NLP/opus-mt-es-en"
    engine.switch_languages()
    assert engine.mt.forward.model_name == "Helsinki-NLP/opus-mt-en-es"


def test_offline_manager(tmp_path):
    mgr = OfflineManager(base_dir=str(tmp_path / "base"))
    assert not (tmp_path / "base").exists()  # nothing written until a save
    assert not mgr.is_model_available("vocoder")
    cap = mgr.check_offline_capability()
    assert cap["fully_offline"] is False and cap["history_entries"] == 0
    for i in range(1005):
        mgr.save_translation(f"s{i}", f"t{i}", "en", "es", max_entries=1000)
    history = mgr.load_history()
    assert len(history) == 1000
    assert history[-1]["source_text"] == "s1004"
    assert set(history[0]) == {"timestamp", "source_text", "translated_text", "source_lang", "target_lang"}
    mgr.clear_history()
    assert mgr.load_history() == []
    vdir = tmp_path / "base" / "models" / "vocoder"
    vdir.mkdir(parents=True)
    (vdir / "1.pt").write_text("x")
    assert mgr.is_model_available("vocoder")
    assert mgr.cache_size_mb() > 0
    mgr.clear_cache("vocoder")
    assert not vdir.exists()


# ---- the stdlib server ----


def _post(base, path, payload=None, data=None):
    req = urllib.request.Request(base + path, data=data if data is not None else json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.load(r)


@pytest.fixture
def server(engine, tmp_path):
    """The stdlib server over ``engine`` on a free port, its history in a
    temporary directory."""
    cfg = replace(Settings(), web=replace(Settings().web, port=0))
    srv = StdlibServer(engine=engine, cfg=cfg, offline=OfflineManager(str(tmp_path / "offline")))
    port = srv.start(background=True)
    yield srv, f"http://127.0.0.1:{port}"
    srv.stop()


def test_stdlib_server_roundtrip(server):
    srv, base = server
    with urllib.request.urlopen(base + "/api/health") as r:
        assert json.load(r) == {"status": "ok", "app": "hifigan-tpu-translator", "version": "0.1.0"}
    with urllib.request.urlopen(base + "/api/models/info") as r:
        info = json.load(r)
        assert "engine" in info and "offline" in info
    out = _post(base, "/api/translate/text", {"text": "good morning"})
    assert out["translated_text"] == "good morning"
    assert [h["source_text"] for h in srv.offline.load_history()] == ["good morning"]
    wav = taudio.float_to_wav_bytes(np.zeros(1024, np.float32))
    reply = _post(base, "/api/stream/chunk", {"type": "audio_chunk", "audio": base64.b64encode(wav).decode()})
    assert reply["type"] == "translation_update"
    assert _post(base, "/api/synthesize/text", {"text": "hola"})["audio"] == ""  # no TTS: silence
    for path, data, code in (("/api/translate/text", b"not json", 400), ("/api/nope", b"{}", 404)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, path, data=data)
        assert e.value.code == code
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/api/nope")
    assert e.value.code == 404
    assert _post(base, "/api/switch_languages", {}) == {"source_lang": "es", "target_lang": "en"}
    assert _post(base, "/api/switch_languages", {}) == {"source_lang": "en", "target_lang": "es"}


def test_stdlib_server_static_client(server):
    """The port's copy of the web client is served; a path out of
    ``static/`` is not."""
    _, base = server
    with urllib.request.urlopen(base + "/") as r:
        assert "/static/app.js" in r.read().decode()  # the real client, not the fallback page
    with urllib.request.urlopen(base + "/static/app.js") as r:
        assert r.headers["Content-Type"] == "text/javascript"
        js = r.read().decode()
        assert "TranslatorClient" in js and "audio_chunk" in js and "/api/stream/chunk" in js
    with urllib.request.urlopen(base + "/static/style.css") as r:
        assert r.headers["Content-Type"] == "text/css"
    for evil in ("/static/../server.py", "/static/nope.js"):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + evil)
        assert e.value.code == 404


def test_stream_chunk_conversation(server):
    """0.5 s base64-WAV chunks, then silence, as the web client sends them:
    every reply a well-formed translation_update."""
    _, base = server
    for chunk in (_voiced(SR // 2), _voiced(SR // 2), np.zeros(SR // 2, np.float32)):
        wav = base64.b64encode(taudio.float_to_wav_bytes(chunk, SR)).decode()
        reply = _post(base, "/api/stream/chunk", {"type": "audio_chunk", "audio": wav})
        assert reply["type"] == "translation_update"
        assert set(reply) >= {"source_text", "translated_text"}


# ---- the vocoder route ----


@pytest.fixture(scope="module")
def seeded_run(tmp_path_factory):
    """A seeded ``create_train_state(TrainConfig())`` written as step 1."""
    directory = tmp_path_factory.mktemp("vocoder")
    state = create_train_state(TrainConfig(), torch.float32, "cpu", seed=3)
    state.step = 1
    CheckpointManager(str(directory)).save(state, force=True)
    return str(directory)


def test_synthesize_runs_the_vocoder_route(seeded_run, tmp_path):
    """An engine built with ``vocoder_checkpoint`` routes TTS mels through
    ``make_vocoder_synth``: with SpeechT5's stage replaced by a test double
    that returns a seeded ``[32, 80]`` mel, ``/api/synthesize/text`` answers
    with ``float_to_wav_bytes(make_vocoder_synth(mel))`` byte for byte; a
    language switch keeps the vocoder, which does not depend on the
    languages."""
    eng = RealTimeTranslationEngine("en", "es", vocoder_checkpoint=seeded_run, device="cpu")
    mel = np.random.default_rng(4).standard_normal((32, 80)).astype(np.float32)
    seen = []
    eng.tts.text_to_mel = lambda text: seen.append(text) or mel
    assert eng.get_model_info()["tts"] == {"model": "microsoft/speecht5_tts", "available": True,
                                           "uses_framework_vocoder": True}
    want = make_vocoder_synth(seeded_run, device="cpu")(mel.T[None])
    assert want.shape == (32 * 256,) and want.dtype == np.float32 and 0.01 < want.std()
    cfg = replace(Settings(), web=replace(Settings().web, port=0))
    srv = StdlibServer(engine=eng, cfg=cfg, offline=OfflineManager(str(tmp_path)))
    base = f"http://127.0.0.1:{srv.start(background=True)}"
    try:
        out = _post(base, "/api/synthesize/text", {"text": "hola mundo"})
    finally:
        srv.stop()
    assert seen == ["hola mundo"] and out["processing_time"] > 0
    assert base64.b64decode(out["audio"]) == taudio.float_to_wav_bytes(want)
    synth = eng.tts.vocoder_synth
    eng.switch_languages()
    assert eng.tts.vocoder_synth is synth and eng.get_model_info()["tts"]["uses_framework_vocoder"]


def test_vocoder_synth_bf16_default_and_plain_step(seeded_run):
    """bf16 is the default compute dtype; on the CPU the default step is the
    plain chain, so passing ``grc_step_reference`` changes nothing."""
    from hifigan_tpu_torch.ops.cuda.grc_kernel import grc_step_reference

    synth = make_vocoder_synth(seeded_run, device="cpu")
    assert synth.generator.dtype == torch.bfloat16 and make_vocoder_synth(None) is None
    mel = np.random.default_rng(5).standard_normal((2, 80, 8)).astype(np.float32)
    wav = synth(mel)
    assert wav.shape == (8 * 256,) and wav.dtype == np.float32
    np.testing.assert_array_equal(synth(mel, step=grc_step_reference), wav)


def test_a_directory_without_checkpoints_raises_in_both_packages(tmp_path, monkeypatch):
    """ROADMAP Queue 3: JAX's ``cli serve`` picks ``runs/flagship`` (no
    checkpoint there) by default and fails building the engine; both
    packages' ``make_vocoder_synth`` raise ``FileNotFoundError``.  JAX's
    full-width ``create_train_state`` (about 26 s on an 8-core CPU) only builds the
    template its ``CheckpointManager.restore`` fills, and the restore
    raises before it reads the template, so the test hands it none."""
    import hifigan_tpu.train
    from hifigan_tpu.app.engine import make_vocoder_synth as jmake_vocoder_synth

    (tmp_path / "metrics.jsonl").write_text("")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        make_vocoder_synth(str(tmp_path), device="cpu")
    monkeypatch.setattr(hifigan_tpu.train, "create_train_state", lambda key, cfg: (None, None, None))
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        jmake_vocoder_synth(str(tmp_path))
