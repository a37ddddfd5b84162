"""The port's MPD / MSD discriminators against the JAX package's on the CPU,
with the JAX parameters carried over by ``load_jax_params``: every head
and the ensemble, final outputs and features, at a length that 2, 3, 5, 7
and 11 all leave a remainder of (the MPD pads on the right) and at one they
divide; fp32, and bf16 held to JAX's bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_generator import _gen, _randomise

from hifigan_tpu.models import discriminators as jdisc
from hifigan_tpu_torch.models import discriminators as tdisc
from hifigan_tpu_torch.weights import load_jax_params

PRIME_LENGTH = 1021  # 1021 mod p != 0 for every period


def _wav(seed, batch, length):
    return (0.5 * np.tanh(np.random.default_rng(seed).standard_normal((batch, length)))).astype(np.float32)


def _both(jmodule, tmodule, wav, seed=3, jdt=jnp.float32):
    """Apply the JAX module (jitted) and the port, with every parameter leaf
    redrawn by ``_randomise``; returns (port output, JAX output) as numpy
    pytrees of fp32."""
    params = _randomise(jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), wav), seed)
    want = jax.jit(jmodule.apply)(params, wav)
    load_jax_params(tmodule, params)
    with torch.no_grad():
        got = tmodule(torch.from_numpy(wav))
    to_np = lambda t: t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)  # noqa: E731
    return jax.tree_util.tree_map(to_np, got), jax.tree_util.tree_map(to_np, want)


def _assert_tree_close(got, want, rtol, atol_of_peak):
    got_l, want_l = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_of_peak * np.abs(w).max(), err_msg=str(i))


@pytest.mark.parametrize("length", [PRIME_LENGTH, 2310], ids=["prime", "divisible"])
@pytest.mark.parametrize("head", ["period_2", "period_3", "period_5", "period_7", "period_11",
                                  "scale_1", "scale_2", "scale_4"])
def test_head_matches_jax(head, length):
    """One head: its output and its four feature maps, fp32; rtol 1e-4,
    atol 1e-5 of each map's peak."""
    kind, n = head.split("_")
    wav = _wav(1, 2, length)
    if kind == "period":
        jm, tm = jdisc.PeriodDiscriminator(int(n)), tdisc.PeriodDiscriminator(int(n), gen=_gen())
    else:
        jm, tm = jdisc.ScaleDiscriminator(int(n)), tdisc.ScaleDiscriminator(int(n), gen=_gen())
    got, want = _both(jm, tm, wav)
    out = got[0]
    expect = (2, int(n), -(-length // int(n)), 1) if kind == "period" else (2, length // int(n), 1)
    assert out.shape == expect and np.isfinite(out).all() and out.std() > 1e-3
    _assert_tree_close(got, want, 1e-4, 1e-5)


def test_ensemble_matches_jax():
    """``Discriminators`` on ``[B, 1, T]`` at the prime length: the dict of
    per-head outputs and features, fp32; rtol 1e-4, atol 1e-5 of each
    map's peak.  The parameter names are JAX's (``mpd.period_2.conv_0_kernel``)."""
    wav = _wav(2, 2, PRIME_LENGTH)[:, None, :]
    tm = tdisc.Discriminators(gen=_gen())
    got, want = _both(jdisc.Discriminators(), tm, wav)
    assert got.keys() == want.keys() == {"mpd_outputs", "mpd_features", "msd_outputs", "msd_features"}
    assert [len(f) for f in got["mpd_features"] + got["msd_features"]] == [4] * 8
    assert "mpd.period_2.conv_0_kernel" in dict(tm.named_parameters())
    _assert_tree_close(got, want, 1e-4, 1e-5)


def test_bf16_ensemble_matches_jax_bf16():
    """Both in bf16 (fp32 parameters, bf16 compute): every output and
    feature map within 4 bf16 ulps of its peak (4 · 2⁻⁸ · max|JAX|)."""
    wav = _wav(3, 2, PRIME_LENGTH)
    got, want = _both(jdisc.Discriminators(dtype=jnp.bfloat16), tdisc.Discriminators(dtype=torch.bfloat16, gen=_gen()),
                      wav)
    _assert_tree_close(got, want, 0, 4 * 2.0 ** -8)
