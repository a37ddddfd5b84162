"""The port's standalone model pieces against the JAX package's on the CPU,
fp32, on the same seeded inputs: ``ops/conv.py``'s ``extract_patches_1d``
and ``dynamic_conv1d``, ``models/generator.py::ODConv1d`` and
``models/blocks.py``'s ``StandaloneGRCBlock`` and ``ParallelMRFBlock``.

Weights: the JAX init's tree with every leaf redrawn (``_randomise``,
N(0, 0.3²/fan)), so the zero-initialised biases and LoRA ``B`` take part,
carried into the port by ``load_jax_params``.  Tolerance: 1e-5 of the JAX
output's peak (fp32; the two sum in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.models import blocks as jblocks
from hifigan_tpu.models import generator as jgen
from hifigan_tpu.ops import conv as jconv
from hifigan_tpu_torch.models import blocks as tblocks
from hifigan_tpu_torch.models import generator as tgen
from hifigan_tpu_torch.ops import conv as tconv
from hifigan_tpu_torch.weights import load_jax_params

REL = 1e-5  # of the JAX output's peak


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the file runs many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * float(np.abs(want).max()))


@pytest.mark.parametrize("stride,padding,dilation", [(1, 1, 1), (2, 3, 1), (1, 4, 2), (3, 0, 3)])
def test_extract_patches_matches_jax(stride, padding, dilation):
    x = np.random.default_rng(stride + 10 * dilation).standard_normal((2, 25, 5)).astype(np.float32)
    want = jconv.extract_patches_1d(jnp.asarray(x), 3, stride=stride, padding=padding, dilation=dilation)
    got = tconv.extract_patches_1d(torch.from_numpy(x), 3, stride=stride, padding=padding, dilation=dilation)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bias", ["per_sample", "shared", "none"])
@pytest.mark.parametrize("stride,padding,dilation", [(1, 1, 1), (2, 3, 1), (1, 4, 2)])
def test_dynamic_conv1d_matches_jax(stride, padding, dilation, bias):
    """``tests/test_ops_conv.py``'s grid (3 × 25 × 5 → 7, k 3), with a
    ``[B, Cout]``, a ``[Cout]`` and no bias."""
    g = np.random.default_rng(stride + 10 * padding + 100 * dilation)
    x = g.standard_normal((3, 25, 5)).astype(np.float32)
    w = g.standard_normal((3, 3, 5, 7)).astype(np.float32)
    b = {"per_sample": g.standard_normal((3, 7)).astype(np.float32),
         "shared": g.standard_normal(7).astype(np.float32), "none": None}[bias]
    kw = dict(stride=stride, padding=padding, dilation=dilation)
    want = jconv.dynamic_conv1d(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b), **kw)
    got = tconv.dynamic_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                               None if b is None else torch.from_numpy(b), **kw)
    _close(got.numpy(), want)


@pytest.mark.parametrize("stride,padding,dilation", [(1, 1, 1), (2, 2, 2)])
def test_odconv1d_matches_jax(stride, padding, dilation):
    """ODConv1d at 8 → 12 channels, k 3, four banks, on 2 × 20 steps."""
    x = np.random.default_rng(dilation).standard_normal((2, 20, 8)).astype(np.float32)
    jm = jgen.ODConv1d(8, 12, 3, stride=stride, padding=padding, dilation=dilation)
    params = _randomise(jm.init(jax.random.PRNGKey(0), x), stride)
    want = jm.apply(params, x)
    tm = load_jax_params(tgen.ODConv1d(8, 12, 3, stride, padding, dilation, gen=_gen()), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert 0.01 < got.std()
    _close(got, want)


@pytest.mark.parametrize("cin,cout,dilation", [(16, 16, 3), (8, 16, 1)], ids=["same_channels", "channel_change"])
def test_standalone_grc_block_matches_jax(cin, cout, dilation):
    """The block with the same channel count, and with a change (the
    projected residual); 2 × 20 steps."""
    x = np.random.default_rng(cin).standard_normal((2, 20, cin)).astype(np.float32)
    jm = jblocks.StandaloneGRCBlock(in_channels=cin, out_channels=cout, dilation=dilation)
    params = _randomise(jm.init(jax.random.PRNGKey(0), x), cin + cout)
    want = jm.apply(params, x)
    tm = load_jax_params(tblocks.StandaloneGRCBlock(cin, cout, dilation=dilation, gen=_gen()), params)
    assert (tm.residual_proj is None) == (cin == cout)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    _close(got, want)


def test_parallel_mrf_block_matches_jax():
    """24 channels split 8/8/8 over dilations 1, 3, 5, deterministic."""
    x = np.random.default_rng(24).standard_normal((2, 16, 24)).astype(np.float32)
    jm = jblocks.ParallelMRFBlock(channels=24)
    params = _randomise(jm.init(jax.random.PRNGKey(0), x), 24)
    want = jm.apply(params, x)
    tm = load_jax_params(tblocks.ParallelMRFBlock(24, gen=_gen()), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    _close(got, want)


def test_parallel_mrf_block_uneven_split_matches_jax():
    """8 channels over three dilations: 2, 2 and the rest (4)."""
    x = np.random.default_rng(8).standard_normal((1, 12, 8)).astype(np.float32)
    jm = jblocks.ParallelMRFBlock(channels=8)
    params = _randomise(jm.init(jax.random.PRNGKey(0), x), 8)
    want = jm.apply(params, x)
    tm = load_jax_params(tblocks.ParallelMRFBlock(8, gen=_gen()), params)
    assert tm.grc_d5.lora_A.shape[0] == 4
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    _close(got, want)


def test_parallel_mrf_dropout_draws_from_the_generator():
    """Dropout: off when deterministic; otherwise each value of the block's
    pre-residual output is either dropped or scaled by 1 / (1 − rate), the
    mask drawn from the given generator (the same seed, the same mask), and
    about ``rate`` of the values dropped."""
    tm = tblocks.ParallelMRFBlock(24, dropout_rate=0.25, gen=_gen())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 64, 24)).astype(np.float32))
    with torch.no_grad():
        plain = tm(x) - x
        a = tm(x, deterministic=False, gen=torch.Generator().manual_seed(7)) - x
        b = tm(x, deterministic=False, gen=torch.Generator().manual_seed(7)) - x
        c = tm(x, deterministic=False, gen=torch.Generator().manual_seed(8)) - x
        with pytest.raises(ValueError, match="torch.Generator"):
            tm(x, deterministic=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    dropped = a == 0
    torch.testing.assert_close(a[~dropped], plain[~dropped] / 0.75, rtol=1e-6, atol=1e-6)
    assert 0.2 < float(dropped.float().mean()) < 0.3
