"""Each op of the torch port against its JAX function, on the CPU, with the
same seeded numpy inputs (fp32, tolerance 1e-5: both sides compute in fp32
and differ only in summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.ops import conv as jconv
from hifigan_tpu.ops import grc_lora as jlora
from hifigan_tpu.ops import odconv as jod
from hifigan_tpu.ops.film import film as jax_film
from hifigan_tpu_torch.ops import conv as tconv
from hifigan_tpu_torch.ops import grc_lora as tlora
from hifigan_tpu_torch.ops import odconv as tod
from hifigan_tpu_torch.ops.film import film as torch_film


def _arrays(seed, *shapes):
    g = np.random.default_rng(seed)
    return [g.standard_normal(s).astype(np.float32) for s in shapes]


def _conv1d(padding, dilation):
    def case(x, w, b):
        return (jconv.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             padding=padding, dilation=dilation),
                tconv.conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                             padding=padding, dilation=dilation))
    return case


def _conv_t(stride, padding):
    def case(x, w, b):
        return (jconv.dynamic_conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                               stride=stride, padding=padding),
                tconv.dynamic_conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w),
                                               torch.from_numpy(b), stride=stride, padding=padding))
    return case


def _pair(jfn, tfn):
    def case(*arrays):
        return (jfn(*map(jnp.asarray, arrays)), tfn(*map(torch.from_numpy, arrays)))
    return case


CASES = {
    "conv1d_same": (_conv1d(3, 1), [(2, 20, 5), (7, 5, 6), (6,)]),
    "conv1d_dilated": (_conv1d(10, 5), [(2, 33, 8), (5, 8, 8), (8,)]),
    "conv1d_asymmetric": (_conv1d((1, 3), 1), [(2, 17, 4), (5, 4, 3), (3,)]),
    "conv_transpose_exact_f2": (_conv_t(2, 1), [(3, 9, 6), (3, 6, 4, 4), (3, 4)]),
    "conv_transpose_exact_f8": (_conv_t(8, 4), [(2, 5, 8), (2, 8, 3, 16), (2, 3)]),
    "conv_transpose_odd_k": (_conv_t(2, 1), [(2, 7, 3), (2, 3, 5, 5), (2, 5)]),
    "leaky_relu": (_pair(lambda x: jconv.leaky_relu(x, 0.1),
                         lambda x: tconv.leaky_relu(x, 0.1)), [(3, 11, 4)]),
    "mix_kernels": (_pair(jod.mix_kernels, tod.mix_kernels), [(4, 6, 5, 3), (2, 4)]),
    "mix_bias": (_pair(jod.mix_bias, tod.mix_bias), [(4, 5), (3, 4)]),
    "blockdiag_conv_kernel": (_pair(lambda w: jlora.blockdiag_conv_kernel(w, 4),
                                    lambda w: tlora.blockdiag_conv_kernel(w, 4)), [(3, 2, 8)]),
    "lora_block_matrix": (_pair(lambda a, b: jlora.lora_block_matrix(a, b, 4),
                                lambda a, b: tlora.lora_block_matrix(a, b, 4)), [(3, 2), (2, 3)]),
    "group_norm": (_pair(lambda x, g, b: jlora.group_norm(x + 0.5, g, b, 4),
                         lambda x, g, b: tlora.group_norm(x + 0.5, g, b, 4)), [(2, 13, 8), (8,), (8,)]),
    "film": (_pair(jax_film, torch_film), [(2, 9, 6), (2, 6), (2, 6)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    case, shapes = CASES[name]
    want, got = case(*_arrays(sorted(CASES).index(name), *shapes))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_mix_kernels_bf16_rounds_like_jax():
    """With a bf16 compute dtype both round the operands and the result to
    bf16 and sum in fp32: the results agree to one bf16 ulp (2^-8 relative)."""
    kernels, attn = _arrays(7, (4, 6, 5, 3), (2, 4))
    want = np.asarray(jod.mix_kernels(jnp.asarray(kernels), jnp.asarray(attn), jnp.bfloat16)
                      .astype(jnp.float32))
    got = tod.mix_kernels(torch.from_numpy(kernels), torch.from_numpy(attn), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8, atol=1e-6)
