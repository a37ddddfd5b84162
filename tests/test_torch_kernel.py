"""The GRC-step CUDA kernels against their plain version, on the card, both
on the tensor cores: bf16 (512-step tiles, 4 tiles a CTA) and fp32 by the
3×TF32 split (256-step tiles, 4 tiles a CTA).

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


_TILING_CASES = {
    torch.bfloat16: [  # 512-step tiles, 2048 steps a CTA
        (2, 2047, 7, 3, 9),    # 4 tiles less one step: one CTA, ragged last tile
        (2, 2048, 7, 3, 9),    # exactly one CTA of 4 tiles
        (2, 2049, 7, 3, 9),    # one step into a second CTA
        (3, 4796, 11, 5, 25),  # two full CTAs and a ragged third of 2 tiles
        (1, 5000, 11, 5, 25),  # B = 1
        (2, 1500, 11, 5, 0),   # lo = 0: the taps look ahead only
        (2, 1500, 11, 5, 50),  # lo = (k-1)*d: the taps look back only
        (2, 700, 3, 1, 2),     # lo = (k-1)*d at d = 1
    ],
    torch.float32: [  # 256-step tiles, 1024 steps a CTA
        (2, 1023, 7, 3, 9),    # 4 tiles less one step: one CTA, ragged last tile
        (2, 1024, 7, 3, 9),    # exactly one CTA of 4 tiles
        (2, 1025, 7, 3, 9),    # one step into a second CTA
        (3, 2400, 11, 5, 25),  # two full CTAs and a ragged third of 2 tiles
        (1, 5000, 11, 5, 25),  # B = 1
        (2, 37, 11, 5, 25),    # T shorter than the halo of 50 steps
        (2, 1500, 11, 5, 0),   # lo = 0: the taps look ahead only
        (2, 1500, 11, 5, 50),  # lo = (k-1)*d: the taps look back only
        (2, 700, 3, 1, 2),     # lo = (k-1)*d at d = 1
    ],
}


@pytest.mark.parametrize("dtype,B,T,k,d,lo", [
    pytest.param(dt, *c, id="{}-B{}-T{}-k{}-d{}-lo{}".format(str(dt).removeprefix("torch."), *c))
    for dt, cases in _TILING_CASES.items() for c in cases])
def test_tiling_matches_plain_version(cuda, dtype, B, T, k, d, lo):
    """Each kernel's tiles and CTAs (grc_kernel.partition) at their edges,
    against the plain version with the tolerances above."""
    args = _inputs(B * T + k + lo, B, T, k, dtype, cuda)
    _check_against_plain(*_run(args, lo, d, dtype), dtype)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
    as cvt.rna.tf32.f32 rounds it."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def test_fp32_kernel_keeps_fp32_accuracy_by_the_3xtf32_split(cuda):
    """The fp32 kernel's taps are three TF32 products per product; one TF32
    pass would be ten times less accurate or more.  With |pre| up to 10 and
    neutral statistics (y = pre) at k = 11, the kernel must stay within the
    fp32 tolerance of the plain version (1e-4) and within a tenth of the
    error of one TF32 pass on the same conv: the conv of the operands
    rounded to TF32, whose products are exact in fp32 (11 x 11 significant
    bits), summed in fp32, as a tensor core's single pass is.  That error
    must itself exceed 1e-4, for the comparison to mean anything.  (cuDNN
    with ``allow_tf32`` is no yardstick: it may choose an fp32 algorithm.)"""
    import torch.nn.functional as F

    B, T, k, d, lo, C = 2, 4096, 11, 5, 25, 32
    g = np.random.default_rng(11)
    pre = torch.tensor(g.uniform(-10, 10, (B, T, C)), dtype=torch.float32, device=cuda)
    w = torch.tensor(g.standard_normal((k, C, C)) / np.sqrt(k * C), dtype=torch.float32, device=cuda)
    bias = torch.tensor(g.standard_normal(C) * 0.1, dtype=torch.float32, device=cuda)
    zeros = torch.zeros((B, C), device=cuda)
    ones = torch.ones((B, C), device=cuda)
    args = (pre, zeros, ones, ones, zeros, w, bias)
    before = grc_kernel.launches["grc_step_f32"]
    got = grc_kernel.grc_step(*args, 1.0, lo=lo, dilation=d)
    want = grc_kernel.grc_step_reference(*args, 1.0, lo=lo, dilation=d)
    torch.cuda.synchronize()
    assert grc_kernel.launches["grc_step_f32"] == before + 1
    err = float((got[0] - want[0]).abs().max())

    yt = F.pad(pre.transpose(1, 2), (lo, (k - 1) * d - lo))
    wt = w.permute(2, 1, 0).contiguous()
    exact = F.conv1d(yt, wt, dilation=d)
    one_pass = F.conv1d(_tf32(yt.contiguous()), _tf32(wt), dilation=d)
    err_tf32 = float((one_pass - exact).abs().max())
    assert err_tf32 > 1e-4, f"one TF32 pass erred by only {err_tf32:.3g}"
    assert err <= 1e-4 and err <= err_tf32 / 10, f"kernel err {err:.3g}, one TF32 pass {err_tf32:.3g}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernel_repeats_bit_for_bit(cuda, dtype):
    args = _inputs(0, 2, 3000, 7, dtype, cuda)
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
    (256 + 2000) rows of 416 B, the window's hi and lo rows of 144 B each and
    the staged row of 128 B, beside W2's hi and lo, 2 x 3 x 32 rows of 144 B;
    bf16: (512 + 2000) rows of 144 B) fails at launch with the CUDA error;
    the next launch is not affected by it."""
    args = _inputs(0, 1, 4096, 3, dtype, cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        grc_kernel.grc_step(*args, 0.1, lo=0, dilation=1000)
    _check_against_plain(*_run(args, 1, 1, dtype), dtype)
