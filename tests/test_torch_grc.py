"""The port's GRC-chain step and chain against the JAX Pallas kernel (run in
interpret mode on the CPU), with seeded numpy inputs and every parameter
leaf randomised."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.models.generator import GRCLoRABlock as JaxBlock
from hifigan_tpu.ops.pallas import fused_grc_step, grc_chain as jax_grc_chain
from hifigan_tpu_torch.models.generator import GRCLoRABlock
from hifigan_tpu_torch.ops.cuda import grc_kernel
from hifigan_tpu_torch.weights import load_jax_generator_params


def _step_inputs(seed, B, U, C, k, normalised):
    g = np.random.default_rng(seed)
    x = g.standard_normal((B, U, C)).astype(np.float32)
    w = (0.1 * g.standard_normal((k, C, C))).astype(np.float32)
    bias = g.standard_normal(C).astype(np.float32)
    if normalised:
        stats = [g.standard_normal((B, C)).astype(np.float32) * 0.2,
                 g.uniform(0.5, 2.0, (B, C)).astype(np.float32),
                 g.uniform(0.5, 1.5, (B, C)).astype(np.float32),
                 g.standard_normal((B, C)).astype(np.float32) * 0.1]
        slope = 0.1
    else:
        stats = [np.zeros((B, C), np.float32), np.ones((B, C), np.float32),
                 np.ones((B, C), np.float32), np.zeros((B, C), np.float32)]
        slope = 1.0
    return x, stats, w, bias, slope


@pytest.mark.parametrize("normalised", [False, True], ids=["neutral", "normalised"])
@pytest.mark.parametrize("k,lo", [(3, 1), (5, 0), (7, 6)])
def test_plain_step_matches_pallas_step(k, lo, normalised):
    """d=1 with an arbitrary ``lo``: tolerance 1e-4, as the JAX kernel's own
    test (both fp32; only the summation order differs)."""
    B, U, C = 2, 16, 32
    x, stats, w, bias, slope = _step_inputs(k + lo, B, U, C, k, normalised)
    want = fused_grc_step(jnp.asarray(x), *map(jnp.asarray, stats), jnp.asarray(w),
                          jnp.asarray(bias), slope, lo=lo, k=k, interpret=True)
    got = grc_kernel.grc_step(torch.from_numpy(x), *map(torch.from_numpy, stats),
                              torch.from_numpy(w), torch.from_numpy(bias), slope, lo=lo)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-4, atol=1e-4)


def _jax_blocks(C, F, ks_dil, seed=0):
    blocks, params = [], []
    x = jnp.zeros((2, 8, F * C))
    for j, (k, d) in enumerate(ks_dil):
        m = JaxBlock(channels=C, kernel_size=k, dilation=d, lora_rank=4, fold=F)
        p = m.init(jax.random.PRNGKey(seed + j), x)
        leaves, treedef = jax.tree_util.tree_flatten(p)
        g = np.random.default_rng(seed + j)
        leaves = [g.normal(0, 0.3, l.shape).astype(np.float32) for l in leaves]
        blocks.append(m)
        params.append(jax.tree_util.tree_unflatten(treedef, leaves))
    return blocks, params


@pytest.mark.parametrize("ks_dil", [
    [(3, 1), (3, 3), (3, 5)],
    [(11, 1), (11, 3), (11, 5)],
], ids=["k3", "k11"])
def test_chain_matches_pallas_chain(rng, ks_dil):
    """The unfolded port against the JAX chain on 4×-folded input (C=8,
    F=4), reshaped to compare; tolerance 2e-3, as the JAX chain's test."""
    C, F, B, U = 8, 4, 2, 16
    blocks, params = _jax_blocks(C, F, ks_dil)
    x = rng.standard_normal((B, U, F * C), dtype=np.float32)
    comps = [m.apply(p, jnp.asarray(x), return_fused=True) for m, p in zip(blocks, params)]
    want = jax_grc_chain(jnp.asarray(x), comps, groups=4, channels=C, fold=F, slope=0.1,
                         interpret=True)

    gen = torch.Generator().manual_seed(0)
    ported = [load_jax_generator_params(GRCLoRABlock(C, k, d, lora_rank=4, gen=gen), p)
              for (k, d), p in zip(ks_dil, params)]
    got = grc_kernel.grc_chain(torch.from_numpy(x.reshape(B, U * F, C)),
                               [b.fused() for b in ported], groups=4, slope=0.1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want).reshape(B, U * F, C),
                               rtol=2e-3, atol=2e-3)


def test_chain_matches_blocks_run_one_after_another(rng):
    """The fused chain (block i normalised in step i+1 with block i's γ/β
    and step i's sums, the last one in the epilogue) against the port's
    blocks run one by one as separate ops, every leaf randomised; 2e-3."""
    C, ks_dil = 8, [(7, 1), (7, 3), (7, 5)]
    _, params = _jax_blocks(C, 4, ks_dil)
    gen = torch.Generator().manual_seed(0)
    ported = [load_jax_generator_params(GRCLoRABlock(C, k, d, lora_rank=4, gen=gen), p)
              for (k, d), p in zip(ks_dil, params)]
    x = torch.from_numpy(rng.standard_normal((2, 64, C), dtype=np.float32))
    with torch.no_grad():
        got = grc_kernel.grc_chain(x, [b.fused() for b in ported], groups=4, slope=0.1)
        want = x
        for b in ported:
            want = b(want)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3, atol=2e-3)


def test_cpu_step_runs_plain_version_and_counts_no_launch():
    x, stats, w, bias, slope = _step_inputs(0, 2, 40, 32, 3, True)
    args = (torch.from_numpy(x), *map(torch.from_numpy, stats), torch.from_numpy(w),
            torch.from_numpy(bias), slope)
    before = dict(grc_kernel.launches)
    got = grc_kernel.grc_step(*args, lo=2, dilation=2)
    want = grc_kernel.grc_step_reference(*args, lo=2, dilation=2)
    assert grc_kernel.launches == before
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)


def test_step_rejects_other_devices():
    x = torch.zeros((1, 8, 32), device="meta")
    s = torch.zeros((1, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        grc_kernel.grc_step(x, s, s, s, s, torch.zeros((3, 32, 32), device="meta"),
                            torch.zeros(32, device="meta"), 0.1, lo=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("T", [1, 37, 511, 512, 513, 65536])
def test_partition_covers_each_step_once(T, dtype):
    """The kernel's split of a batch row (tiles of ``tile`` steps, runs of
    ``tiles_per_cta`` tiles a CTA) covers [0, T) exactly once, with no CTA
    left without a tile; the wrapper allocates one partial sum per CTA,
    ``[2, B, n_cta, 32]``.  At the main path's T = 65536 the bf16 kernel runs
    32 CTAs a row, 4 tiles of 512 steps each, and the fp32 kernel 64 CTAs a
    row, 4 tiles of 256 steps each."""
    tile, per, n_cta = grc_kernel.partition(T, dtype)
    covered = []
    for cta in range(n_cta):
        tiles = [j for j in range(cta * per, (cta + 1) * per) if j * tile < T]
        assert tiles, f"CTA {cta} of {n_cta} has no tile"
        for j in tiles:
            covered.extend(range(j * tile, min((j + 1) * tile, T)))
    assert covered == list(range(T))
    if T == 65536:
        assert (tile, per, n_cta) == ((512, 4, 32) if dtype == torch.bfloat16 else (256, 4, 64))


def test_ptxas_summary_names_each_kernel():
    """The build's ``ptxas -v`` report, one line per kernel with its
    demangled name, registers, spills and static shared memory."""
    from hifigan_tpu_torch.ops.cuda.build import summarise_ptxas

    ns = "_INTERNAL_0d1e2f3a_16_grc_step_bf16_cu_a4cf3dff"
    report = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN{len(ns)}{ns}20grc_step_bf16_kernelEPK13__nv_bfloat16PKfS4_' for 'sm_90a'
ptxas info    : Function properties for _ZN{len(ns)}{ns}20grc_step_bf16_kernelEPK13__nv_bfloat16PKfS4_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers, 2688 bytes smem, 480 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115grc_step_kernelIfEEvPKT_PKfS5_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115grc_step_kernelIfEEvPKT_PKfS5_
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 384 bytes cmem[0]
"""
    assert summarise_ptxas(report).splitlines() == [
        "grc_step_bf16_kernel: 127 registers, 0 B spill stores, 0 B spill loads, 2688 B static smem",
        "grc_step_kernel: 48 registers, 8 B spill stores, 4 B spill loads, 0 B static smem",
    ]
