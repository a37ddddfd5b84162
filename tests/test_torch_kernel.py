"""The GRC-step CUDA kernels against their plain version, on the card: bf16
on the tensor cores (512-step tiles, 4 tiles a CTA), fp32 on the CUDA cores.

The kernels have no CPU mode, so every test here skips without a CUDA card.
This file imports torch only (no JAX), so it also runs where JAX is not
installed: ``python -m pytest --noconftest -q tests/test_torch_kernel.py``."""

import numpy as np
import pytest
import torch

from hifigan_tpu_torch.ops.cuda import grc_kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, B, T, k, dtype, device):
    g = np.random.default_rng(seed)
    C = 32
    arrays = [g.standard_normal((B, T, C)) * 2 + 0.5, g.standard_normal((B, C)) * 0.2,
              g.uniform(0.5, 2.0, (B, C)), g.uniform(0.5, 1.5, (B, C)),
              g.standard_normal((B, C)) * 0.1, g.standard_normal((k, C, C)) / np.sqrt(k * C),
              g.standard_normal(C) * 0.1]
    t = [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]
    t[0], t[5] = t[0].to(dtype), t[5].to(dtype)
    return t


def _check_against_plain(got, want, dtype):
    """fp32: 1e-4 (summation order); bf16: 2^-7 relative (at least one bf16
    ulp: a different fp32 summation order may round the other way) plus 1e-5
    of the output's range for outputs near zero; sums: 1e-4 relative."""
    assert got[0].dtype == dtype and got[0].shape == want[0].shape
    pre_g, pre_w = got[0].float(), want[0].float()
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7 * pre_w.abs() + 1e-5 * pre_w.abs().max()
    assert bool(((pre_g - pre_w).abs() <= tol).all())
    for s_g, s_w in zip(got[1:], want[1:]):
        torch.testing.assert_close(s_g, s_w, rtol=1e-4, atol=1e-4 * float(s_w.abs().max()))


def _run(args, lo, d, dtype):
    name = "grc_step_bf16" if dtype == torch.bfloat16 else "grc_step_f32"
    before = grc_kernel.launches[name]
    got = grc_kernel.grc_step(*args, 0.1, lo=lo, dilation=d)
    want = grc_kernel.grc_step_reference(*args, 0.1, lo=lo, dilation=d)
    torch.cuda.synchronize()
    assert grc_kernel.launches[name] == before + 1
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("k,d,T", [(3, 1, 1000), (7, 3, 129), (11, 5, 4096), (11, 5, 37)])
def test_kernel_matches_plain_version(cuda, k, d, T, dtype):
    """Ragged and short T included (T = 37 is shorter than k = 11, d = 5's
    halo of 50 steps)."""
    args = _inputs(k * d + T, 3, T, k, dtype, cuda)
    _check_against_plain(*_run(args, (k - 1) * d // 2, d, dtype), dtype)


@pytest.mark.parametrize("B,T,k,d,lo", [
    (2, 2047, 7, 3, 9),    # 4 tiles less one step: one CTA, ragged last tile
    (2, 2048, 7, 3, 9),    # exactly one CTA of 4 tiles
    (2, 2049, 7, 3, 9),    # one step into a second CTA
    (3, 4796, 11, 5, 25),  # two full CTAs and a ragged third of 2 tiles
    (1, 5000, 11, 5, 25),  # B = 1
    (2, 1500, 11, 5, 0),   # lo = 0: the taps look ahead only
    (2, 1500, 11, 5, 50),  # lo = (k-1)*d: the taps look back only
    (2, 700, 3, 1, 2),     # lo = (k-1)*d at d = 1
])
def test_bf16_tiling_matches_plain_version(cuda, B, T, k, d, lo):
    """The bf16 kernel's tiles and CTAs (grc_kernel.partition) at their
    edges, against the plain version with the tolerances above."""
    args = _inputs(B * T + k + lo, B, T, k, torch.bfloat16, cuda)
    _check_against_plain(*_run(args, lo, d, torch.bfloat16), torch.bfloat16)


def test_kernel_repeats_bit_for_bit(cuda):
    args = _inputs(0, 2, 3000, 7, torch.bfloat16, cuda)
    a = grc_kernel.grc_step(*args, 0.1, lo=9, dilation=3)
    b = grc_kernel.grc_step(*args, 0.1, lo=9, dilation=3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = _inputs(0, 2, 64, 3, torch.float32, cuda)
    with pytest.raises(ValueError, match="C=32"):
        grc_kernel.grc_step(args[0][..., :16].contiguous(), *args[1:], 0.1, lo=1)
    with pytest.raises(ValueError, match="contiguous"):
        grc_kernel.grc_step(args[0].transpose(0, 1).contiguous().transpose(0, 1), *args[1:], 0.1, lo=1)
    with pytest.raises(ValueError, match="lo"):
        grc_kernel.grc_step(*args, 0.1, lo=3)
    shifted = torch.empty(args[0].numel() + 1, device=cuda)[1:].view(args[0].shape)
    with pytest.raises(ValueError, match="aligned"):
        grc_kernel.grc_step(shifted.copy_(args[0]), *args[1:], 0.1, lo=1)
    with pytest.raises(RuntimeError, match="no backward"):
        grc_kernel.grc_step(args[0].requires_grad_(), *args[1:], 0.1, lo=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_window_too_large_for_shared_memory_raises_and_clears(cuda, dtype):
    """A dilation whose haloed window exceeds a CTA's shared memory (fp32:
    (128 + 2000) rows of 128 B; bf16: (512 + 2000) rows of 144 B) fails at
    launch with the CUDA error; the next launch is not affected by it."""
    args = _inputs(0, 1, 4096, 3, dtype, cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        grc_kernel.grc_step(*args, 0.1, lo=0, dilation=1000)
    _check_against_plain(*_run(args, 1, 1, dtype), dtype)
