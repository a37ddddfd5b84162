"""The port's generator modules against the JAX modules on the CPU, fp32
(and the whole generator also in bf16), with the JAX parameters carried
over by ``load_jax_generator_params``.

Every parameter leaf is redrawn from a seed (N(0, 0.3²/fan), fan = the
product of all but the last dim), so the zero-initialised LoRA ``B`` and
biases take part, while activations stay in tanh's linear range."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.models import generator as jgen
from hifigan_tpu_torch.models import generator as tgen
from hifigan_tpu_torch.weights import load_jax_generator_params

TINY = dict(input_channels=16, hidden_channels=32, upsample_factors=(4, 2),
            resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),), lora_rank=4)


def _randomise(params, seed):
    leaves, treedef = jax.tree_util.tree_flatten(params)
    g = np.random.default_rng(seed)
    out = []
    for leaf in leaves:
        fan = int(np.prod(leaf.shape[:-1])) if leaf.ndim > 1 else 1
        out.append((g.standard_normal(leaf.shape) * 0.3 / np.sqrt(fan)).astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


def _gen():
    return torch.Generator().manual_seed(0)


def _inputs(seed, *shapes):
    g = np.random.default_rng(seed)
    return [g.standard_normal(s).astype(np.float32) for s in shapes]


def test_generator_matches_jax_both_backends():
    """The tiny config (tests/test_pallas.py): the port against the JAX
    generator under mrf_backend "xla" and "pallas" (interpret); 2e-3."""
    mel, spk, emo = _inputs(1, (2, 16, 16), (2, 192), (2, 256))
    jm = jgen.Generator(jgen.GeneratorConfig(**TINY, mrf_backend="xla"))
    params = _randomise(jm.init(jax.random.PRNGKey(0), mel, spk, emo), 3)
    want = {b: np.asarray(jgen.Generator(jgen.GeneratorConfig(**TINY, mrf_backend=b))
                          .apply(params, mel, spk, emo)) for b in ("xla", "pallas")}

    model = load_jax_generator_params(tgen.Generator(tgen.GeneratorConfig(**TINY), gen=_gen()), params)
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (mel, spk, emo))).numpy()
    assert got.shape == (2, 1, 16 * 8)
    assert 0.05 < got.std() and np.abs(got).max() < 0.99  # not saturated, not vanishing
    for backend, w in want.items():
        np.testing.assert_allclose(got, w, rtol=2e-3, atol=2e-3, err_msg=backend)


def test_default_config_generator_matches_jax():
    """The full default config (80 mels, 512 hidden, upsampling 8·8·2·2,
    MRF kernels {3, 7, 11} × dilations {1, 3, 5}) at batch 1 × 8 frames:
    the port against the JAX generator (mrf_backend "xla", jitted), both
    fp32; atol 1e-4, rtol 1e-3.  Only the parameter shapes are taken from
    JAX's init (``eval_shape``): every leaf is redrawn from a seed."""
    mel, spk, emo = _inputs(7, (1, 80, 8), (1, 192), (1, 256))
    jm = jgen.Generator(jgen.GeneratorConfig(mrf_backend="xla"))
    params = _randomise(jax.eval_shape(jm.init, jax.random.PRNGKey(0), mel, spk, emo), 3)
    want = np.asarray(jax.jit(jm.apply)(params, mel, spk, emo))

    model = load_jax_generator_params(tgen.Generator(tgen.GeneratorConfig(), gen=_gen()), params)
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (mel, spk, emo))).numpy()
    assert got.shape == (1, 1, 8 * 256)
    assert np.isfinite(got).all() and 0.005 < got.std() and np.abs(got).max() < 0.99
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("config,shape", [(TINY, (2, 16)), ({}, (1, 8))], ids=["tiny", "default"])
def test_bf16_generator_matches_jax_bf16(config, shape):
    """The port in bf16 (the flagship's dtype) against JAX's bf16 generator
    (mrf_backend "xla", jitted), on the CPU: ``TINY`` at 2 × 16 frames and
    ``GeneratorConfig()`` at 1 × 8 frames, parameters as in the fp32 tests.

    Tolerance 4 bf16 ulps at the JAX output's peak (4·2⁻⁸·max|wav|), as
    ``chip_smoke.py`` holds the kernel path to the plain path: both compute
    in bf16 with fp32 sums, but round and sum in other places and orders
    (XLA's fused ops against eager torch), so single bf16 roundings may
    differ by an ulp and carry through the layers; a wrong op, layout or
    dtype moves the output by far more."""
    (batch, frames), cfg = shape, dict(config)
    mel, spk, emo = _inputs(11, (batch, cfg.get("input_channels", 80), frames), (batch, 192), (batch, 256))
    jm = jgen.Generator(jgen.GeneratorConfig(**cfg, mrf_backend="xla"), dtype=jnp.bfloat16)
    params = _randomise(jax.eval_shape(jm.init, jax.random.PRNGKey(0), mel, spk, emo), 3)
    want = np.asarray(jax.jit(jm.apply)(params, mel, spk, emo))

    model = tgen.Generator(tgen.GeneratorConfig(**cfg), torch.bfloat16, gen=_gen())
    load_jax_generator_params(model, params)
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (mel, spk, emo))).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape == (batch, 1, frames * model.config.upsample_ratio)
    assert np.isfinite(got).all() and 0.005 < got.std()
    tol = 4 * 2.0 ** -8 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("k,f,p", [(8, 4, 2), (4, 2, 1), (5, 2, 1)], ids=["exact_f4", "exact_f2", "odd_k"])
def test_odconv_transpose_matches_jax(k, f, p):
    (x,) = _inputs(k, (2, 9, 12))
    jm = jgen.ODConvTranspose1d(12, 6, k, f, p)
    params = _randomise(jm.init(jax.random.PRNGKey(0), x), k)
    want = np.asarray(jm.apply(params, x))
    tm = load_jax_generator_params(tgen.ODConvTranspose1d(12, 6, k, f, p, gen=_gen()), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,d", [(3, 1), (7, 3), (11, 5)])
def test_grc_block_matches_jax(k, d):
    """The block alone and as a one-block chain, against the unfolded JAX
    block; 1e-4 (fp32, GroupNorm over 40 steps)."""
    (x,) = _inputs(d, (2, 40, 8))
    jm = jgen.GRCLoRABlock(channels=8, kernel_size=k, dilation=d, lora_rank=4)
    params = _randomise(jm.init(jax.random.PRNGKey(0), x), k)
    want = np.asarray(jm.apply(params, x))
    tm = load_jax_generator_params(tgen.GRCLoRABlock(8, k, d, lora_rank=4, gen=_gen()), params)
    from hifigan_tpu_torch.ops.cuda.grc_kernel import grc_chain

    with torch.no_grad():
        alone = tm(torch.from_numpy(x)).numpy()
        chained = grc_chain(torch.from_numpy(x), [tm.fused()], groups=4, slope=0.1).numpy()
    np.testing.assert_allclose(alone, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(chained, want, rtol=1e-4, atol=1e-4)


def test_film_matches_jax():
    x, spk, emo = _inputs(5, (2, 7, 6), (2, 3), (2, 4))
    cond = np.concatenate([spk, emo], axis=-1)
    jm = jgen.FiLM(6)
    params = _randomise(jm.init(jax.random.PRNGKey(0), x, cond), 5)
    want = np.asarray(jm.apply(params, x, cond))
    tm = load_jax_generator_params(tgen.FiLM(6, 7, _gen()), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_parameter_names_and_shapes_match_jax_tree():
    mel, spk, emo = _inputs(0, (1, 16, 8), (1, 192), (1, 256))
    params = jgen.Generator(jgen.GeneratorConfig(**TINY)).init(jax.random.PRNGKey(0), mel, spk, emo)
    flat = {".".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(params["params"])[0]}
    model = tgen.Generator(tgen.GeneratorConfig(**TINY), gen=_gen())
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == flat


def test_load_rejects_a_mismatched_tree():
    model = tgen.GRCLoRABlock(8, 3, 1, lora_rank=4, gen=_gen())
    tree = {n: p.detach().numpy() for n, p in model.named_parameters()}
    with pytest.raises(KeyError, match="missing"):
        load_jax_generator_params(model, {k: v for k, v in tree.items() if k != "lora_B"})
    with pytest.raises(ValueError, match="lora_B"):
        load_jax_generator_params(model, {**tree, "lora_B": np.zeros((1, 1), np.float32)})


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas", "pallas2", "tpu"])
def test_every_jax_backend_name_resolves(backend):
    cfg = tgen.GeneratorConfig(**TINY, mrf_backend=backend)
    if backend == "tpu":
        with pytest.raises(ValueError, match="mrf_backend"):
            tgen.Generator(cfg, gen=_gen())
    else:
        tgen.Generator(cfg, gen=_gen())
