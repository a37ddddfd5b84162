"""The fused GRC-chain step: CUDA kernel, its plain version, and the chain.

Replaces ``hifigan_tpu/ops/pallas/grc_kernel.py`` (``fused_grc_step``, and
``grc_chain``, which runs it along a chain).  One step of the generator's MRF chain, on
``pre [B, T, C]``:

    y[t]       = leaky(γ·(pre[t] − μ)·inv + β, slope)    (0 outside [0, T))
    pre_out[t] = Σ_j y[t + d·j − lo]·W2[j] + bias + y[t]

plus the fp32 per-channel sums Σpre_out and Σpre_out² that the next
GroupNorm needs.  ``y`` is rounded to ``pre``'s dtype before the taps, sums
are fp32, and ``pre_out`` keeps ``pre``'s dtype.

Two kernels, both on the tensor cores by ``mma.sync``: bf16 × bf16 → fp32
(``csrc/grc_step_bf16.cu``, bound by bytes), and fp32 as three TF32
products per product, ``lo·hi + hi·lo + hi·hi`` with ``x ≈ hi + lo`` (the
3×TF32 split, ``csrc/grc_step.cu``), which keeps fp32 accuracy and is bound
by the TF32 rate at k ≥ 7 and by bytes at k = 3.  :func:`grc_step`
launches the one for ``pre``'s dtype for a CUDA tensor and runs
:func:`grc_step_reference` for a CPU tensor; it never falls back from one
to the other.  ``launches`` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from hifigan_tpu_torch.ops.conv import leaky_relu
from hifigan_tpu_torch.ops.grc_lora import group_stats

launches = {"grc_step_f32": 0, "grc_step_bf16": 0}  # CUDA launches of each kernel in this process

# Time steps per tile (kTile in each .cu) and tiles per CTA of each kernel.
_TILING = {torch.float32: (256, 4), torch.bfloat16: (512, 4)}

# pre, mean, inv, gamma, beta, w, bias, slope, out, part1, part2, B, T, k, dil, lo
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_float] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5


@functools.cache
def _library() -> ctypes.CDLL:
    from hifigan_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    lib.grc_step_f32.argtypes = lib.grc_step_bf16.argtypes = (
        _ARGTYPES + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])  # tiles/CTA, CTAs, stream
    lib.grc_step_f32.restype = lib.grc_step_bf16.restype = ctypes.c_int
    lib.grc_step_error_string.argtypes, lib.grc_step_error_string.restype = [ctypes.c_int], ctypes.c_char_p
    tiles = (lib.grc_step_f32_tile(), lib.grc_step_bf16_tile())
    if tiles != (_TILING[torch.float32][0], _TILING[torch.bfloat16][0]):
        raise RuntimeError(f"grc_step: the kernels' tiles {tiles} differ from the wrapper's {_TILING}")
    return lib


def partition(t_len: int, dtype: torch.dtype) -> tuple[int, int, int]:
    """``(tile, tiles_per_cta, n_cta)``: how the kernel for ``dtype`` splits a
    batch row of ``t_len`` steps.  CTA i walks tiles ``[i·tiles_per_cta,
    (i+1)·tiles_per_cta)`` and tile j covers steps ``[j·tile, (j+1)·tile)``,
    both cut at ``t_len``; the ``n_cta`` CTAs of a row cover it once, each
    with at least one tile.  The split depends on ``t_len`` alone, never on
    the card, so the per-CTA sums, and their total, repeat bit for bit."""
    tile, per = _TILING[dtype]
    n_tiles = -(-t_len // tile)
    return tile, per, -(-n_tiles // per)


def grc_step_reference(pre, mean, inv, gamma, beta, w, bias, slope, *, lo, dilation=1):
    """Plain PyTorch version of the step (same arguments as :func:`grc_step`).

    Arithmetic is fp32 throughout, as in the kernel: a bf16 ``y`` and ``W2``
    are upcast before the conv, so only the summation order differs."""
    k = w.shape[0]
    xn = (pre.float() - mean[:, None, :]) * inv[:, None, :]
    xn = xn * gamma[:, None, :] + beta[:, None, :]
    y = torch.where(xn >= 0, xn, slope * xn).to(pre.dtype).float()
    yt = F.pad(y.transpose(1, 2), (lo, (k - 1) * dilation - lo))
    acc = F.conv1d(yt, w.float().permute(2, 1, 0), dilation=dilation).transpose(1, 2)
    acc = acc + bias + y
    return acc.to(pre.dtype), acc.sum(1), acc.square().sum(1)


def _check(pre, mean, inv, gamma, beta, w, bias, lo, dilation, channels):
    B, T, C = pre.shape
    k = w.shape[0]
    if pre.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grc_step: pre must be float32 or bfloat16, got {pre.dtype}")
    if C != channels:
        raise ValueError(f"grc_step: the kernel takes C={channels} channels, got {C}")
    if w.shape != (k, C, C) or w.dtype != pre.dtype:
        raise ValueError(f"grc_step: w must be [k, {C}, {C}] {pre.dtype}, got {tuple(w.shape)} {w.dtype}")
    for name, t in (("mean", mean), ("inv", inv), ("gamma", gamma), ("beta", beta)):
        if t.shape != (B, C) or t.dtype != torch.float32:
            raise ValueError(f"grc_step: {name} must be [{B}, {C}] float32")
    if bias.shape != (C,) or bias.dtype != torch.float32:
        raise ValueError(f"grc_step: bias must be [{C}] float32")
    tensors = (pre, mean, inv, gamma, beta, w, bias)
    if any(t.device != pre.device for t in tensors):
        raise ValueError("grc_step: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("grc_step: all tensors must be contiguous")
    if B < 1 or T < 1:
        raise ValueError(f"grc_step: pre must not be empty, got {tuple(pre.shape)}")
    if pre.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("grc_step: pre and w must be 16-byte aligned")
    if dilation < 1 or not 0 <= lo <= (k - 1) * dilation:
        raise ValueError(f"grc_step: need dilation >= 1 and 0 <= lo <= (k-1)*dilation, got {lo}, {dilation}")


def grc_step(pre, mean, inv, gamma, beta, w, bias, slope, *, lo, dilation=1):
    """One chain step → ``(pre_out [B,T,C], s1 [B,C], s2 [B,C])``.

    ``pre [B, T, C]`` float32 or bfloat16; ``mean, inv, gamma, beta [B, C]``
    and ``bias [C]`` float32; ``w [k, C, C]`` in ``pre``'s dtype."""
    if pre.device.type == "cpu":
        return grc_step_reference(pre, mean, inv, gamma, beta, w, bias, slope, lo=lo, dilation=dilation)
    if pre.device.type != "cuda":
        raise ValueError(f"grc_step: unsupported device {pre.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (pre, mean, inv, gamma, beta, w, bias)):
        raise RuntimeError("grc_step: the CUDA kernel has no backward; run under torch.no_grad(), "
                           "or pass step=grc_step_reference to differentiate the plain version")
    lib = _library()
    _check(pre, mean, inv, gamma, beta, w, bias, lo, dilation, lib.grc_step_channels())
    B, T, C = pre.shape
    _, per, n_cta = partition(T, pre.dtype)
    out = torch.empty_like(pre)
    part = torch.empty((2, B, n_cta, C), dtype=torch.float32, device=pre.device)
    name = "grc_step_bf16" if pre.dtype == torch.bfloat16 else "grc_step_f32"
    with torch.cuda.device(pre.device):
        err = getattr(lib, name)(
            pre.data_ptr(), mean.data_ptr(), inv.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            w.data_ptr(), bias.data_ptr(), float(slope), out.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), B, T, w.shape[0], dilation, lo, per, n_cta,
            torch.cuda.current_stream(pre.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"grc_step: CUDA error {err} at launch "
                           f"({lib.grc_step_error_string(err).decode()}; k={w.shape[0]}, dilation={dilation})")
    launches[name] += 1
    s = part.sum(dim=2)
    return out, s[0], s[1]


def grc_chain(x, blocks, *, groups, slope, eps=1e-5, step=grc_step):
    """Run a chain of fused GRC blocks; returns the activated output of the
    last block (counterpart of the JAX ``grc_chain``, unfolded).

    ``blocks[i]`` holds block i's fused conv (``w2 [k, C, C]``, ``bias [C]``,
    ``lo``, ``dilation``) and its GroupNorm affine (``gamma``, ``beta``
    ``[C]``).  The first step runs with neutral statistics (μ=0, inv=1,
    γ=1, β=0, slope=1) so the raw input passes through; step i normalises
    with block i−1's γ/β and the sums of step i−1's output; the last
    block's GroupNorm and LeakyReLU are applied after the loop.  ``step``
    is :func:`grc_step`, or :func:`grc_step_reference` to run the plain
    version on any device."""
    B, T, C = x.shape
    n = T * (C // groups)
    cur = x.contiguous()
    s1 = s2 = None
    for i, p in enumerate(blocks):
        if i == 0:
            mean = torch.zeros((B, C), dtype=torch.float32, device=x.device)
            inv = torch.ones_like(mean)
            gamma, beta, sl = inv, mean, 1.0
        else:
            mean, inv = group_stats(s1, s2, n, groups, eps)
            prev = blocks[i - 1]
            gamma = prev["gamma"].float().expand(B, C).contiguous()
            beta = prev["beta"].float().expand(B, C).contiguous()
            sl = slope
        cur, s1, s2 = step(cur, mean, inv, gamma, beta, p["w2"], p["bias"], sl,
                           lo=p["lo"], dilation=p["dilation"])
    mean, inv = group_stats(s1, s2, n, groups, eps)
    last = blocks[-1]
    y = (cur.float() - mean[:, None, :]) * inv[:, None, :] * last["gamma"].float() + last["beta"].float()
    return leaky_relu(y, slope).to(x.dtype)
