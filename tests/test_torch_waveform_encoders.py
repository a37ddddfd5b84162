"""The port's waveform-input encoders (``models/waveform_encoders.py``)
against the JAX package's on the CPU, on the same seeded inputs.

- ``extract_mel_features``: the same log-mel within 1e-6 (fp32; the two
  FFTs sum in different orders).
- ``WaveformEcapaTdnn`` on JAX's init params (hidden 64 and the default
  1024, 1 × 64 mel frames): within 1e-5 of the embedding's peak.
- ``SpeakerEncoder`` reading the port's file written from JAX's params by
  ``weights.save_jax_speaker_encoder``: the embedding of JAX's
  ``SpeakerEncoder`` within 1e-5 of its peak; unit norm and the
  same / different decisions as ``tests/test_beam.py`` checks them.
- ``Wav2Vec2Emotion``'s fallback (no HF weights here): JAX's keys and
  shapes, and with JAX's ``Emotion2Vec`` params the same embedding and
  logits within 1e-5 of each peak."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.models import waveform_encoders as jwe
from hifigan_tpu_torch.models import waveform_encoders as twe
from hifigan_tpu_torch.weights import load_jax_params, load_speaker_encoder_checkpoint, save_jax_speaker_encoder

REL = 1e-5  # of the JAX output's peak


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the file runs many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _audio(seed, n=8000):
    return (np.random.default_rng(seed).standard_normal(n) * 0.3).astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * float(np.abs(want).max()))


def test_extract_mel_features_matches_jax():
    audio = _audio(0, 12000)
    want = jwe.extract_mel_features(audio)
    got = twe.extract_mel_features(audio, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape and got.shape[1] == 80
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hidden", [64, 1024])
def test_waveform_ecapa_matches_jax(hidden):
    mel = np.random.default_rng(hidden).standard_normal((1, 64, 80)).astype(np.float32)
    jm = jwe.WaveformEcapaTdnn(hidden=hidden)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1), jnp.asarray(mel)))
    want = jm.apply(params, mel)
    tm = load_jax_params(twe.WaveformEcapaTdnn(hidden=hidden, gen=torch.Generator()), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(mel)).numpy()
        got_cf = tm(torch.from_numpy(mel.transpose(0, 2, 1).copy())).numpy()  # [B, n_mels, T] too
    assert got.shape == (1, 192)
    _close(got, want)
    np.testing.assert_array_equal(got_cf, got)


@pytest.fixture(scope="module")
def speaker_file(tmp_path_factory):
    """JAX's seeded native ``SpeakerEncoder`` (no speechbrain here) and its
    params written as the port's speaker-encoder file."""
    jenc = jwe.SpeakerEncoder()
    assert jenc.backend == "native"
    path = str(tmp_path_factory.mktemp("spk") / "speaker.pt")
    save_jax_speaker_encoder(path, jax.tree_util.tree_map(np.asarray, jenc.params))
    return jenc, path


def test_speaker_encoder_from_jax_params(speaker_file):
    jenc, path = speaker_file
    enc = twe.SpeakerEncoder(checkpoint_path=path, device="cpu")
    assert enc.backend == "native"
    assert load_speaker_encoder_checkpoint(path, "cpu").proj.kernel.shape == (1024, 192)
    a, b = _audio(1), _audio(2)
    e1, e2 = enc(a), enc(b)
    _close(e1, jenc(a))
    _close(e2, jenc(b))
    assert e1.shape == (192,)
    np.testing.assert_allclose(np.linalg.norm(e1), 1.0, rtol=1e-4)
    same, sim = twe.verify_speaker_identity(e1, e1)
    assert same and sim > 0.99
    assert twe.calculate_speaker_similarity(e1, e2) < 1.0
    assert twe.verify_speaker_identity(e1, e2, threshold=1.0)[0] is False
    np.testing.assert_array_equal(twe.extract_speaker_embeddings(enc, [a, b]), np.stack([e1, e2]))


def test_speaker_encoder_falls_back_to_the_seeded_encoder(tmp_path):
    """No file and no speechbrain: the native encoder drawn from ``seed``;
    an unreadable file: the same, with a warning."""
    bad = tmp_path / "bad.pt"
    bad.write_bytes(b"not a checkpoint")
    a = _audio(3)
    ref = twe.SpeakerEncoder(seed=4, device="cpu")
    assert ref.backend == "native"
    np.testing.assert_array_equal(twe.SpeakerEncoder(str(bad), seed=4, device="cpu")(a), ref(a))
    assert twe.load_speaker_encoder(device="cpu").backend == "native"


def test_wav2vec2_emotion_fallback_matches_jax():
    jemo = jwe.Wav2Vec2Emotion()
    emo = twe.Wav2Vec2Emotion(device="cpu")
    assert emo.backend == jemo.backend == "native"
    load_jax_params(emo._model, jax.tree_util.tree_map(np.asarray, jemo._params))
    audio = _audio(5)
    got, want = emo(audio), jemo(audio)
    assert set(got) == set(want) == {"embedding", "logits", "label"}
    assert got["embedding"].shape == (384,) and got["logits"].shape == (8,)
    _close(got["embedding"], want["embedding"])
    _close(got["logits"], want["logits"])
    assert got["label"] in twe.EMOTION_LABELS
    np.testing.assert_allclose(np.linalg.norm(got["embedding"]), 1.0, rtol=1e-5)
    batch = twe.extract_emotion_embeddings(emo, [audio, _audio(6)])
    assert batch.shape == (2, 384)
