"""The port's STFT and mel ops (``hifigan_tpu_torch/ops/stft.py``) and
``audio_to_mel`` against the JAX package's on the CPU, fp32, on seeded
audio; also the gradient of the mel L1 loss with respect to the waveform,
against ``jax.grad``, through a stretch of silence (a zero frame, where the
``eps`` inside the square root keeps the gradient finite)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.ops import stft as jstft
from hifigan_tpu.train import TrainConfig as JaxTrainConfig
from hifigan_tpu.train.losses import mel_l1_loss as jax_mel_l1
from hifigan_tpu.train.train_step import audio_to_mel as jax_audio_to_mel
from hifigan_tpu_torch.ops import stft as tstft
from hifigan_tpu_torch.train import TrainConfig
from hifigan_tpu_torch.train.losses import mel_l1_loss
from hifigan_tpu_torch.train.train_step import audio_to_mel

TINY_MEL = dict(n_fft=32, hop_length=8, win_length=32, n_mels=16)  # cli.py --tiny


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its many small ops pay for
    thread synchronisation, ten times over when test workers share the
    cores (the checkpoint test on an 8-core CPU beside six busy processes:
    112 s at 8 threads, 10 s at 1)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _audio(seed, batch, length, silence=None):
    """Seeded pseudo-speech ``[batch, length]`` in [-0.5, 0.5]: a few
    partials under noise; ``silence = (a, b)`` zeroes samples a..b."""
    g = np.random.default_rng(seed)
    t = np.arange(length) / 16000.0
    f0 = g.uniform(80, 250, (batch, 1))
    x = sum(g.uniform(0.1, 1.0, (batch, 1)) / h * np.sin(2 * np.pi * f0 * h * t + g.uniform(0, 6.3, (batch, 1)))
            for h in range(1, 5))
    x = x + 0.05 * g.standard_normal((batch, length))
    x = 0.5 * x / np.abs(x).max(axis=1, keepdims=True)
    if silence is not None:
        x[:, silence[0]:silence[1]] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("n_fft,hop,center,length", [
    (32, 8, True, 256), (1024, 256, True, 4096), (24, 10, True, 200), (32, 8, False, 256),
    (2048, 512, True, 256),  # the pad (1024) is longer than the signal: reflected again at each edge
])
def test_frame_signal_matches_jax(n_fft, hop, center, length):
    """Exact: framing is a copy."""
    x = _audio(1, 2, length)
    want = np.asarray(jstft.frame_signal(jnp.asarray(x), n_fft, hop, center=center))
    got = tstft.frame_signal(torch.from_numpy(x), n_fft, hop, center=center).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_fft,hop,win", [(32, 8, 32), (1024, 256, 1024), (64, 16, 48), (512, 128, 512)])
def test_stft_magnitude_matches_jax(n_fft, hop, win):
    """Both take the rfft of the same fp32 frames; atol 1e-5 of the peak."""
    x = _audio(2, 2, 4096)
    want = np.asarray(jstft.stft_magnitude(jnp.asarray(x), n_fft, hop, win))
    got = tstft.stft_magnitude(torch.from_numpy(x), n_fft, hop, win).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("args", [(16000, 1024, 80, 0.0, 8000.0), (16000, 32, 16, 0.0, 8000.0),
                                  (22050, 1024, 80, 0.0, None), (16000, 512, 40, 60.0, 7600.0)])
def test_mel_filterbank_equals_jax(args):
    """The port's numpy copy of the Slaney filterbank is the same array."""
    np.testing.assert_array_equal(tstft.mel_filterbank(*args), jstft.mel_filterbank(*args))


@pytest.mark.parametrize("mel", [{}, TINY_MEL], ids=["default", "tiny"])
def test_log_mel_and_audio_to_mel_match_jax(mel):
    """``log_mel_spectrogram`` at ``MelConfig()`` and the tiny config, and
    ``audio_to_mel`` (frames trimmed to ``T // hop``); atol 1e-4 on the log
    scale."""
    x = _audio(3, 2, 4096 + 100)
    jcfg = JaxTrainConfig(mel=jstft.MelConfig(**mel))
    cfg = TrainConfig(mel=tstft.MelConfig(**mel))
    want = np.asarray(jstft.log_mel_spectrogram(jnp.asarray(x), jcfg.mel))
    got = tstft.log_mel_spectrogram(torch.from_numpy(x), cfg.mel).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    want = np.asarray(jax_audio_to_mel(jnp.asarray(x), jcfg))
    got = audio_to_mel(torch.from_numpy(x), cfg).numpy()
    assert got.shape == want.shape == (2, cfg.mel.n_mels, x.shape[1] // cfg.mel.hop_length)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("resolutions", [None, ((32, 8, 32), (64, 16, 64), (16, 4, 16))], ids=["default", "tiny"])
def test_multi_resolution_stft_loss_matches_jax(resolutions):
    """The loss (rtol 1e-5) and its gradient w.r.t. the fake waveform, atol
    1e-3 of its peak: the log-magnitude term's gradient is 1/|X| at the weak
    bins, where fp32 FFTs err most; at the default resolutions each of the
    two fp32 gradients lies 9.3e-4 / 9.8e-4 of the peak from a float64
    one, and they lie 2.6e-4 of it from each other."""
    fake, real = _audio(4, 2, 4096), _audio(5, 2, 4096)
    kw = {} if resolutions is None else {"resolutions": resolutions}
    want, want_g = jax.value_and_grad(lambda f: jstft.multi_resolution_stft_loss(f, jnp.asarray(real), **kw))(
        jnp.asarray(fake))
    f = torch.from_numpy(fake).requires_grad_(True)
    got = tstft.multi_resolution_stft_loss(f, torch.from_numpy(real), **kw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(f.grad.numpy(), want_g, rtol=0, atol=1e-3 * np.abs(want_g).max())


@pytest.mark.parametrize("mel", [{}, TINY_MEL], ids=["default", "tiny"])
def test_mel_l1_gradient_through_silence_matches_jax(mel):
    """d mel-L1(audio_to_mel(fake), target) / d fake against ``jax.grad``,
    with 1500 samples of silence in ``fake`` (whole zero frames in both
    configs): finite everywhere, atol 1e-4 of the gradient's peak."""
    fake, real = _audio(6, 2, 4096, silence=(1200, 2700)), _audio(7, 2, 4096)
    jcfg = JaxTrainConfig(mel=jstft.MelConfig(**mel))
    cfg = TrainConfig(mel=tstft.MelConfig(**mel))
    target = jax_audio_to_mel(jnp.asarray(real), jcfg)
    want, want_g = jax.value_and_grad(lambda f: jax_mel_l1(jax_audio_to_mel(f, jcfg), target))(jnp.asarray(fake))
    f = torch.from_numpy(fake).requires_grad_(True)
    got = mel_l1_loss(audio_to_mel(f, cfg), audio_to_mel(torch.from_numpy(real), cfg))
    got.backward()
    assert bool(torch.isfinite(f.grad).all())
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_g = np.asarray(want_g)
    assert np.abs(want_g).max() > 0
    np.testing.assert_allclose(f.grad.numpy(), want_g, rtol=0, atol=1e-4 * np.abs(want_g).max())
