"""The port's extractor modules (attention, encoder layer, SE, SE-Res2,
attentive pooling, ECAPA-TDNN, Emotion2Vec) and flax-semantics layers
against the JAX modules on the CPU, fp32, with the JAX parameters carried
over by ``load_jax_params``.

Every parameter leaf is redrawn from a seed (``_randomise``: N(0,
0.3²/fan)), so zero-initialised biases and unit LayerNorm scales take part.
The extractor's widths are the repo's tiny ones (``cli.py``'s ``--tiny``:
ECAPA 32 channels, Emotion2Vec d 32, 1 layer, 4 heads).  Tolerance 2e-3,
the ROADMAP's tiny tolerance, unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_generator import _gen, _inputs, _randomise

from hifigan_tpu.models import embeddings as jemb
from hifigan_tpu.models import layers as jlay
from hifigan_tpu_torch.models import embeddings as temb
from hifigan_tpu_torch.models import layers as tlay
from hifigan_tpu_torch.weights import load_jax_params

TOL = dict(rtol=2e-3, atol=2e-3)


def _run_both(jm, tm, seed, *args):
    """Init ``jm`` on ``args``, redraw its leaves, load them into ``tm``,
    and return both outputs as numpy."""
    params = _randomise(jm.init(jax.random.PRNGKey(0), *args), seed)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(jm.apply)(params, *args))
    load_jax_params(tm, params)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(np.asarray(a)) for a in args))
    return jax.tree_util.tree_map(lambda t: t.float().numpy(), got), want


def test_sinusoidal_positions_match_jax():
    np.testing.assert_array_equal(tlay.sinusoidal_positions(37, 12), jlay.sinusoidal_positions(37, 12))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dense_and_layer_norm_match_flax(dtype):
    """flax ``nn.Dense(dtype=…, param_dtype=fp32)`` and ``nn.LayerNorm``
    (epsilon 1e-6, fast variance) on inputs of variance 0.0025, where
    torch's epsilon 1e-5 would move the output by 0.2%.  fp32: 1e-5; bf16
    Dense: 2 bf16 ulps of the largest output (both round one fp32 sum to
    bf16)."""
    import flax.linen as fnn

    (x,) = _inputs(4, (3, 5, 16))
    x = x * 0.05 + 0.1
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    got, want = _run_both(fnn.Dense(24, dtype=jdt, param_dtype=jnp.float32),
                          tlay.Dense(16, 24, _gen(), dtype=tdt), 1, x)
    tol = 1e-5 if dtype == "fp32" else 2 * 2.0 ** -8 * float(np.abs(want).max())
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0, atol=tol)
    got, want = _run_both(fnn.LayerNorm(dtype=jnp.float32), tlay.LayerNorm(16), 2, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_multi_head_attention_matches_jax(masked):
    """Cross-attention 6 queries × 9 keys, 4 heads of 8.  The mask hides a
    random third of the keys, and all of query 2's in batch 1: that row
    attends uniformly in both (masked scores are float32's min, not -inf)."""
    q, kv = _inputs(8, (2, 6, 32), (2, 9, 32))
    mask = None
    if masked:
        mask = np.random.default_rng(9).random((2, 1, 6, 9)) > 0.33
        mask[1, 0, 2, :] = False
    jm = jlay.MultiHeadAttention(4)
    tm = tlay.MultiHeadAttention(32, 4, gen=_gen())
    args = (q, kv) if mask is None else (q, kv, mask)
    got, want = _run_both(jm, tm, 3, *args)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_transformer_encoder_layer_matches_jax():
    (x,) = _inputs(10, (2, 11, 32))
    got, want = _run_both(jlay.TransformerEncoderLayer(4, 128), tlay.TransformerEncoderLayer(32, 4, 128, gen=_gen()),
                          4, x)
    np.testing.assert_allclose(got, want, **TOL)


def test_se_module_matches_jax():
    (x,) = _inputs(12, (2, 13, 32))
    got, want = _run_both(jemb.SEModule(32), temb.SEModule(32, gen=_gen()), 5, x)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dilation", [2, 4])
def test_se_res2_block_matches_jax(dilation):
    (x,) = _inputs(13, (2, 15, 32))
    got, want = _run_both(jemb.SERes2Block(32, 3, dilation), temb.SERes2Block(32, 3, dilation, gen=_gen()), 6, x)
    np.testing.assert_allclose(got, want, **TOL)


def test_attentive_stats_pooling_matches_jax():
    (x,) = _inputs(14, (2, 17, 24))
    got, want = _run_both(jemb.AttentiveStatsPooling(), temb.AttentiveStatsPooling(24, gen=_gen()), 7, x)
    assert got.shape == (2, 48)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", [(2, 16, 21), (2, 21, 16), (2, 16, 16)],
                         ids=["mels_first", "mels_last", "T_equals_n_mels"])
def test_ecapa_tdnn_matches_jax(shape):
    """Both input layouts, and T = n_mels, which the JAX rule takes as
    channels-last."""
    (mel,) = _inputs(15, shape)
    got, want = _run_both(jemb.EcapaTdnn(n_mels=16, channels=32, embedding_dim=24),
                          temb.EcapaTdnn(16, 32, 24, gen=_gen()), 8, mel)
    assert got.shape == (2, 24)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", [(2, 16, 19), (2, 19, 16)], ids=["mels_first", "mels_last"])
def test_emotion2vec_matches_jax(shape):
    """At 1e-5, tighter than the tiny tolerance: the two agree to about
    1e-7, and a sample std in place of ``jnp.std``'s population std in the
    CMVN moves the embedding by only about 2e-4."""
    (mel,) = _inputs(16, shape)
    mel = mel * 3.0 - 5.0  # a log-mel's offset and scale: the CMVN has work to do
    got, want = _run_both(jemb.Emotion2Vec(n_mels=16, hidden_dim=32, num_layers=1, num_heads=4),
                          temb.Emotion2Vec(16, 32, 256, 1, 4, gen=_gen()), 9, mel)
    assert got.shape == (2, 256)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_embedding_extractor_matches_jax():
    (mel,) = _inputs(17, (2, 16, 23))
    jm = jemb.EmbeddingExtractor(n_mels=16, ecapa_channels=32, emo_hidden=32, emo_layers=1, emo_heads=4)
    tm = temb.EmbeddingExtractor(192, 256, 16, 32, 32, 1, 4, gen=_gen())
    (spk, emo), (want_spk, want_emo) = _run_both(jm, tm, 10, mel)
    np.testing.assert_allclose(spk, want_spk, **TOL)
    np.testing.assert_allclose(emo, want_emo, **TOL)
