"""The port's unit vocoder against the JAX one on the CPU, fp32: HiFi-GAN
V1's ResBlock and generator (the JAX one folds time below 128 channels,
the port does not), ``expand_by_durations``, and ``CodeVocoder`` with
predicted and with teacher durations, with the speaker channel and with
both f0 paths.  Every parameter leaf is redrawn by ``_randomise``; then
the duration predictor's last LayerNorm is reset to unit scale and zero
bias and its projection set to spread the durations over the clip range
(redrawn, the LayerNorm's bias swamps the units, and every duration is 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_generator import _gen, _inputs, _randomise
from test_torch_s2st import assert_within

from hifigan_tpu.models import code_vocoder as jcv
from hifigan_tpu.models import generator as jgen
from hifigan_tpu_torch.models import code_vocoder as tcv
from hifigan_tpu_torch.models import generator as tgen
from hifigan_tpu_torch.weights import load_code_config, load_jax_params

# tests/test_streaming.py's TINY_CODE
TINY_CODE = dict(unit_vocab_size=50, embed_dim=16, upsample_factors=(4, 2), hidden_channels=16,
                 max_duration_per_unit=3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_resblock1_matches_jax():
    """One ResBlock, 16 channels, k 7, dilations (1, 3, 5), 2 × 30 frames; 1e-5."""
    x, = _inputs(1, (2, 30, 16))
    jm = jgen._ResBlock1(16, 7, (1, 3, 5))
    params = _randomise(jm.init(jax.random.PRNGKey(0), x), 1)
    tm = load_jax_params(tgen._ResBlock1(16, 7, (1, 3, 5), gen=_gen()), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert_within(got.numpy(), jm.apply(params, x), 1e-5, "ResBlock1")


@pytest.mark.parametrize("config,frames", [(dict(input_channels=16, hidden_channels=32, upsample_factors=(4, 2)), 16),
                                           ({}, 4)], ids=["tiny", "default"])
def test_hifigan_v1_matches_jax(config, frames):
    """HiFi-GAN V1 at tiny widths (2 × 16 frames) and at its default
    (80 mels, 512 hidden, 8·8·2·2, 1 × 4 frames); the JAX generator folds
    time where channels drop below 128 (every stage of the tiny one, the
    last two of the default), the port runs unfolded; 1e-5."""
    n_mels = config.get("input_channels", 80)
    mel, = _inputs(2, (2 if config else 1, n_mels, frames))
    jm = jgen.HiFiGANV1Generator(**config)
    params = _randomise(jax.eval_shape(jm.init, jax.random.PRNGKey(0), mel), 2)
    want = jax.jit(jm.apply)(params, mel)
    tm = load_jax_params(tgen.HiFiGANV1Generator(**config, gen=_gen()), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(mel))
    ratio = int(np.prod(config.get("upsample_factors", (8, 8, 2, 2))))
    assert got.shape == (mel.shape[0], 1, frames * ratio) and 100 * 1e-5 < float(got.std())  # varies by 100× the tol
    assert_within(got.numpy(), want, 1e-5, f"HiFiGANV1 {'tiny' if config else 'default'}")


def test_expand_by_durations_equals_jax():
    """Durations with zeros and a total that overflows the budget: the same
    frames, mask and totals (exact), and frames past the total are 0."""
    frames, = _inputs(3, (2, 5, 3))
    dur = np.array([[1, 2, 0, 3, 1], [4, 0, 4, 1, 2]], np.int32)
    want = jcv.expand_by_durations(frames, dur, 10)
    got = tcv.expand_by_durations(torch.from_numpy(frames), torch.from_numpy(dur).long(), 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[0][0, 7:].any() and got[2].tolist() == [7, 11]
    np.testing.assert_array_equal(got[0][0, :7].numpy(), np.repeat(frames[0], [1, 2, 0, 3, 1], axis=0))


def _code_pair(config, seed, **init_kwargs):
    """A JAX ``CodeVocoder`` tree, ``_randomise``d, with the duration
    predictor's output set to spread (``ln_1`` unit scale and zero bias,
    ``proj`` kernel ×2 and bias 1.2), and the port's vocoder loaded with it."""
    jm = jcv.CodeVocoder(jcv.CodeVocoderConfig(**config))
    units = np.zeros((2, 8), np.int32)
    params = _randomise(jax.eval_shape(jm.init, jax.random.PRNGKey(0), units, **init_kwargs), seed)
    if config.get("dur_prediction", True):
        dp = params["params"]["duration_predictor"]
        dp["ln_1"] = {"scale": np.ones_like(dp["ln_1"]["scale"]), "bias": np.zeros_like(dp["ln_1"]["bias"])}
        dp["proj"] = {"kernel": dp["proj"]["kernel"] * 2, "bias": np.full_like(dp["proj"]["bias"], 1.2)}
    tm = load_jax_params(tcv.CodeVocoder(tcv.CodeVocoderConfig(**config), gen=_gen()), params)
    return jm, params, tm.eval()


def _check_vocoder(jm, params, tm, units, what, **kwargs):
    want = jm.apply(params, units, return_log_dur=True, **kwargs)
    with torch.no_grad():
        got = tm(torch.from_numpy(units).long(), return_log_dur=True,
                 **{k: torch.from_numpy(np.array(v)) for k, v in kwargs.items()})
    wav, dur, n, log_dur = got
    np.testing.assert_array_equal(dur.numpy(), np.asarray(want[1]), err_msg=what)
    np.testing.assert_array_equal(n.numpy(), np.asarray(want[2]), err_msg=what)
    if log_dur is None:
        assert want[3] is None
    else:
        assert_within(log_dur.numpy(), want[3], 1e-5, f"{what} log_dur")
    assert_within(wav.numpy(), want[0], 1e-5, f"{what} wav")
    for b in range(units.shape[0]):
        assert not wav[b, 0, int(n[b]):].any()  # the padded samples stay 0
    return wav, dur


def test_code_vocoder_predicted_and_teacher_durations():
    """``TINY_CODE``, 2 × 8 units: predicted durations (equal, and of more than one value
    in 1..3), then teacher durations; waveform and log-durations 1e-5."""
    jm, params, tm = _code_pair(TINY_CODE, 4)
    units = np.random.default_rng(4).integers(0, 50, (2, 8)).astype(np.int32)
    wav, dur = _check_vocoder(jm, params, tm, units, "predicted")
    assert wav.shape == (2, 1, 8 * 3 * 8) and len(set(dur.flatten().tolist())) > 1
    teacher = np.array([[2, 0, 1, 3, 3, 1, 2, 1], [1, 1, 1, 1, 1, 1, 1, 1]], np.int32)
    _, dur = _check_vocoder(jm, params, tm, units, "teacher", durations=teacher)
    np.testing.assert_array_equal(dur.numpy(), teacher)


def test_code_vocoder_speaker_channel():
    """``speaker_dim = 8``: the speaker embedding is a channel of every
    frame; 1e-5."""
    config = {**TINY_CODE, "speaker_dim": 8}
    spk, = _inputs(5, (2, 8))
    jm, params, tm = _code_pair(config, 5, speaker_emb=spk)
    units = np.random.default_rng(5).integers(0, 50, (2, 8)).astype(np.int32)
    _check_vocoder(jm, params, tm, units, "speaker", speaker_emb=spk)
    with pytest.raises(ValueError, match="speaker"):
        tm(torch.from_numpy(units).long())


@pytest.mark.parametrize("quant_bins", [0, 32], ids=["raw_f0", "quantised_f0"])
def test_code_vocoder_f0_paths(quant_bins):
    """f0 as a raw channel (one value a frame) and as an embedding of
    quantised bins at half the frame rate (nearest-repeated); without
    duration prediction in the quantised case; 1e-5."""
    config = {**TINY_CODE, "f0": True, "f0_quant_bins": quant_bins, "dur_prediction": quant_bins == 0}
    g = np.random.default_rng(6)
    f0 = (g.uniform(80, 250, (2, 24)).astype(np.float32) if quant_bins == 0
          else g.integers(0, quant_bins, (2, 12)).astype(np.int32))
    jm, params, tm = _code_pair(config, 6, f0=f0)
    units = g.integers(0, 50, (2, 8)).astype(np.int32)
    _check_vocoder(jm, params, tm, units, f"f0 bins={quant_bins}", f0=f0)


def test_code_config_loads_the_trainer_json(tmp_path):
    path = tmp_path / "code_config.json"
    path.write_text('{"unit_vocab_size": 32, "embed_dim": 128, "upsample_factors": [8, 8, 2, 2], '
                    '"hidden_channels": 512, "max_duration_per_unit": 16, "speaker_dim": 0, '
                    '"dur_prediction": true, "f0": false, "f0_quant_bins": 0}')
    assert load_code_config(str(path)) == tcv.CodeVocoderConfig(unit_vocab_size=32, max_duration_per_unit=16)
