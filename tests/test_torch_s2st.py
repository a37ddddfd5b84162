"""The port's S2ST model against the JAX one on the CPU, fp32: the conv ops
it adds (grouped ``conv1d``, static ``conv_transpose1d``), the attention
masks, the decoder layer, the chunked Conformer (and its prefix property),
``StreamSpeechS2ST``'s outputs and methods, its parameter trees and the
config loader's feature-revision guard.  Every parameter leaf is redrawn
by ``_randomise``; each test states its tolerance on the max abs error."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_generator import _gen, _inputs, _randomise

from hifigan_tpu.models import conformer as jconf
from hifigan_tpu.models import layers as jlayers
from hifigan_tpu.models import streamspeech as jss
from hifigan_tpu.ops import conv as jconv
from hifigan_tpu_torch.models import conformer as tconf
from hifigan_tpu_torch.models import layers as tlayers
from hifigan_tpu_torch.models import streamspeech as tss
from hifigan_tpu_torch.ops import conv as tconv
from hifigan_tpu_torch.weights import load_jax_params, load_streamspeech_config

# tests/test_streaming.py's TINY_SS: the tiny widths of the streaming tests
TINY_SS = dict(input_dim=80, hidden_dim=32, encoder_layers=1, decoder_layers=1, num_heads=4, vocab_size=30,
               unit_vocab_size=50, chunk_size=8, vocoder_hidden=32, vocoder_upsample=(4, 2), ecapa_channels=32,
               emo_hidden=32, emo_layers=1)
# two layers each, so that the layer stacks are exercised
TWO_LAYERS = {**TINY_SS, "encoder_layers": 2, "decoder_layers": 2}


def assert_within(got, want, tol, what=""):
    """max |got − want| ≤ ``tol``; prints the error as a share of it (read
    with ``pytest -s``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    print(f"[share] {what}: max abs err {err:.3g}, {err / tol:.3g} of tol {tol:g}")
    assert err <= tol, f"{what}: max abs err {err:.3g} > {tol:g}"


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
def test_depthwise_conv1d_matches_jax(causal):
    """``groups = C`` with a ``[k, 1, C]`` kernel, causal and symmetric
    padding (the Conformer's depthwise conv); 1e-5."""
    x, w, b = _inputs(1, (2, 20, 12), (15, 1, 12), (12,))
    pad = (14, 0) if causal else (7, 7)
    want = jconv.conv1d(x, w, b, padding=pad, groups=12)
    got = tconv.conv1d(*_t(x, w, b), padding=pad, groups=12)
    assert_within(got.numpy(), want, 1e-5, f"depthwise conv causal={causal}")


@pytest.mark.parametrize("k,stride,padding", [(4, 2, 1), (16, 8, 4), (4, 2, 2), (3, 1, 0)])
def test_conv_transpose1d_matches_jax(k, stride, padding):
    """The static transposed conv against JAX's polyphase form at the T2U
    encoder's (k 4, s 2, p 1) and HiFi-GAN V1's (k 2f, s f, p f//2)
    shapes, and two others; 1e-5."""
    x, w, b = _inputs(2, (2, 9, 6), (6, 5, k), (5,))
    want = jconv.conv_transpose1d(x, w, b, stride=stride, padding=padding)
    got = tconv.conv_transpose1d(*_t(x, w, b), stride=stride, padding=padding)
    assert got.shape == (2, (9 - 1) * stride - 2 * padding + k, 5)
    assert_within(got.numpy(), want, 1e-5, f"conv_transpose1d k{k} s{stride} p{padding}")


@pytest.mark.parametrize("length,chunk", [(1, 8), (17, 8), (24, 8), (10, 3)])
def test_masks_equal_jax(length, chunk):
    assert np.array_equal(tlayers.causal_mask(length).numpy(), np.asarray(jlayers.causal_mask(length)))
    assert np.array_equal(tlayers.chunk_mask(length, chunk).numpy(),
                          np.asarray(jlayers.chunk_mask(length, chunk)))


@pytest.mark.parametrize("masked", [False, True])
def test_decoder_layer_matches_jax(masked):
    """Post-norm decoder layer, 2 × 7 targets over 2 × 11 memory frames,
    with and without a causal self mask and a per-row cross mask; 1e-5."""
    x, mem = _inputs(3, (2, 7, 32), (2, 11, 32))
    self_mask = np.asarray(jlayers.causal_mask(7)) if masked else None
    cross = (np.arange(11)[None, None, None, :] < np.array([5, 11])[:, None, None, None]) if masked else None
    jm = jlayers.TransformerDecoderLayer(4, 64)
    params = _randomise(jm.init(jax.random.PRNGKey(0), x, mem, self_mask, cross), 4)
    want = jm.apply(params, x, mem, self_mask, cross)
    tm = load_jax_params(tlayers.TransformerDecoderLayer(32, 4, 64, gen=_gen()), params)
    with torch.no_grad():
        got = tm(*_t(x, mem), *(_t(self_mask, cross) if masked else (None, None)))
    assert_within(got.numpy(), want, 1e-5, f"decoder layer masked={masked}")


@pytest.fixture(scope="module")
def conformer():
    x, = _inputs(5, (2, 40, 16))
    jm = jconf.ChunkedConformer(input_dim=16, hidden_dim=32, num_layers=2, num_heads=4, chunk_size=8)
    params = _randomise(jm.init(jax.random.PRNGKey(0), x), 5)
    tm = load_jax_params(tconf.ChunkedConformer(16, 32, 2, 4, 8, gen=_gen()), params)
    return jm, params, tm, x


@pytest.mark.parametrize("chunked", [False, True])
def test_conformer_matches_jax(conformer, chunked):
    """2 layers, 2 × 40 frames (5 chunks of 8): full attention with
    symmetric depthwise padding, and chunked with causal padding; 1e-4."""
    jm, params, tm, x = conformer
    want = jm.apply(params, x, chunked=chunked)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), chunked=chunked)
    assert_within(got.numpy(), want, 1e-4, f"conformer chunked={chunked}")


def test_chunked_conformer_prefix_equals_prefix_of_full_output(conformer):
    """Chunked, the output over the first 2 chunks equals the first 16
    frames of the output over all 5 (the property streaming rests on), in
    the port (1e-5) and in JAX; without ``chunked`` it does not."""
    jm, params, tm, x = conformer
    xt = torch.from_numpy(x)
    with torch.no_grad():
        full, prefix = tm(xt, chunked=True), tm(xt[:, :16], chunked=True)
        offline = tm(xt, chunked=False)[:, :16] - tm(xt[:, :16], chunked=False)
    assert_within(prefix.numpy(), full[:, :16].numpy(), 1e-5, "port chunked prefix")
    assert_within(np.asarray(jm.apply(params, x[:, :16], chunked=True)),
                  np.asarray(jm.apply(params, x, chunked=True))[:, :16], 1e-5, "JAX chunked prefix")
    assert float(offline.abs().max()) > 1e-3


def jitter(params, seed, scale=0.05):
    """Every leaf of a JAX tree plus N(0, ``scale``²) noise drawn from ``seed``."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    g = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        (np.asarray(leaf) + g.standard_normal(leaf.shape) * scale).astype(np.float32) for leaf in leaves])


def _s2st_pair(config, seed, *, vocoder=True, transition_head=True, draw="randomise"):
    """A JAX StreamSpeechS2ST tree with the parts asked for (the JAX
    package's ``init`` forms) and the port's model loaded with it.
    ``draw="randomise"``: every leaf redrawn by ``_randomise``;
    ``"init_jitter"``: the JAX initialisers' draw from ``seed``, every leaf
    then moved by :func:`jitter` (zero biases and unit LayerNorm scales
    become random too, while the signal still propagates)."""
    jm = jss.StreamSpeechS2ST(jss.StreamSpeechConfig(**config))
    mel = np.zeros((1, 16, config["input_dim"]), np.float32)
    tgt = np.zeros((1, 8), np.int32)
    init = lambda: jm.init(jax.random.PRNGKey(seed), mel, tgt, run_vocoder=vocoder,  # noqa: E731
                           decoder_units_out=transition_head)
    params = _randomise(jax.eval_shape(init), seed) if draw == "randomise" else jitter(jax.jit(init)(), seed)
    tm = tss.StreamSpeechS2ST(tss.StreamSpeechConfig(**config), gen=_gen(), with_vocoder=vocoder,
                              with_transition_head=transition_head)
    return jm, params, load_jax_params(tm, params).eval()


def _flat_shapes(tree):
    return {".".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree["params"])[0]}


@pytest.mark.parametrize("vocoder,transition_head", [(True, True), (True, False), (False, True)],
                         ids=["full", "simulate_init", "s2st_trainer_init"])
def test_parameter_tree_matches_jax(vocoder, transition_head):
    """The port's parameter names and shapes equal the JAX tree of each
    ``init`` form: the full tree, ``cli simulate``'s (no transition head)
    and the S2ST trainer's (no vocoder)."""
    jm, params, tm = _s2st_pair(TWO_LAYERS, 0, vocoder=vocoder, transition_head=transition_head)
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == _flat_shapes(params)


def test_streamspeech_outputs_match_jax():
    """The whole forward at ``TINY_SS`` with 2 layers each: 2 × 24 mel
    frames, 2 × 9 targets, chunked, with the decoder-fed units, the write
    logits and the vocoder: every output within 2e-3 (the waveform and
    embeddings pass the port's generator and extractor, held to JAX at
    2e-3 in their own tests), the rest within 1e-4."""
    jm, params, tm = _s2st_pair(TWO_LAYERS, 6)
    mel, = _inputs(6, (2, 24, 80))
    tgt = np.random.default_rng(6).integers(0, 30, (2, 9)).astype(np.int32)
    want = jax.jit(lambda p, m, t: jm.apply(p, m, t, chunked=True, decoder_units_out=True))(params, mel, tgt)
    with torch.no_grad():
        got = tm(torch.from_numpy(mel), torch.from_numpy(tgt).long(), chunked=True, decoder_units_out=True)
    assert got.keys() == want.keys() and len(got) == 10
    assert got["unit_logits"].shape == (2, 24 * 8, 50) and got["generated_waveform"].shape == (2, 1, 24 * 8)
    for name in got:
        tol = 2e-3 if name in ("generated_waveform", "speaker_embedding", "emotion_embedding") else 1e-4
        assert_within(got[name].numpy(), want[name], tol, name)


def test_decoder_methods_match_jax():
    """``decoder_units`` and ``decoder_scores`` under a per-row read-prefix
    cross mask, and ``streaming_forward`` on one chunk; 1e-4 (the
    waveform 2e-3)."""
    jm, params, tm = _s2st_pair(TWO_LAYERS, 7)
    mem, chunk = _inputs(7, (2, 16, 32), (2, 8, 80))
    tgt = np.random.default_rng(7).integers(0, 30, (2, 6)).astype(np.int32)
    cross = np.arange(16)[None, None, None, :] < np.array([8, 16])[:, None, None, None]
    args = (mem, tgt, cross)
    targs = (torch.from_numpy(mem), torch.from_numpy(tgt).long(), torch.from_numpy(cross))
    with torch.no_grad():
        units = tm.decoder_units(*targs)
        logits, write = tm.decoder_scores(*targs)
        stream = tm.streaming_forward(torch.from_numpy(chunk))
    assert_within(units.numpy(), jm.apply(params, *args, method=jss.StreamSpeechS2ST.decoder_units), 1e-4,
                  "decoder_units")
    want_logits, want_write = jm.apply(params, *args, method=jss.StreamSpeechS2ST.decoder_scores)
    assert_within(logits.numpy(), want_logits, 1e-4, "decoder_scores logits")
    assert_within(write.numpy(), want_write, 1e-4, "decoder_scores write")
    want_stream = jax.jit(lambda p, c: jm.apply(p, c, method=jss.StreamSpeechS2ST.streaming_forward))(params, chunk)
    assert stream.keys() == want_stream.keys()
    for name in stream:
        assert_within(stream[name].numpy(), want_stream[name], 2e-3 if name == "generated_waveform" else 1e-4,
                      f"streaming_forward {name}")


def test_load_rejects_a_tree_of_another_init_form():
    """The trainer's tree (no vocoder) does not load into a model with a
    vocoder, and the simulate tree (no transition head) not into one with
    a transition head: the loader stays strict."""
    _, params, _ = _s2st_pair(TINY_SS, 0, vocoder=False, transition_head=True)
    with pytest.raises(KeyError, match="vocoder"):
        load_jax_params(tss.StreamSpeechS2ST(tss.StreamSpeechConfig(**TINY_SS), gen=_gen()), params)
    _, params, _ = _s2st_pair(TINY_SS, 0, vocoder=True, transition_head=False)
    with pytest.raises(KeyError, match="transition_head"):
        load_jax_params(tss.StreamSpeechS2ST(tss.StreamSpeechConfig(**TINY_SS), gen=_gen()), params)


def test_streamspeech_config_guard(tmp_path):
    """``load_streamspeech_config`` reads the trainer's JSON (list → tuple)
    and refuses another feature revision."""
    d = {**TINY_SS, "speaker_dim": 192, "emotion_dim": 256, "vocoder_upsample": [4, 2]}
    path = tmp_path / "streamspeech_config.json"
    path.write_text(json.dumps({**d, "_feature_rev": tss.FEATURE_REV}))
    assert load_streamspeech_config(str(path)) == tss.StreamSpeechConfig(**{**d, "vocoder_upsample": (4, 2)})
    assert tss.FEATURE_REV == jss.FEATURE_REV
    path.write_text(json.dumps({**d, "_feature_rev": tss.FEATURE_REV - 1}))
    with pytest.raises(ValueError, match="feature rev"):
        load_streamspeech_config(str(path))
