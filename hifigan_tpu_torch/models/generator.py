"""The flagship generator (ODConv + GRC-LoRA + FiLM) in PyTorch.

Counterpart of ``hifigan_tpu/models/generator.py::Generator``:

    mel [B, 80, T] + speaker [B, 192] + emotion [B, 256]
      → input conv (80→512, k=7) → FiLM
      → 4 ODConv transposed-conv upsamplers (8·8·2·2), LeakyReLU + FiLM each
      → 3 MRF stacks of GRC-LoRA blocks, run in sequence, each with a
        residual and FiLM
      → output conv (→1, k=7) → tanh → wav [B, 1, 256·T]

Activations run channels-last ``[B, T, C]`` and unfolded.  Parameters are
fp32 and carry the JAX package's names and layouts (see
:mod:`hifigan_tpu_torch.weights`); ``dtype`` is the compute dtype.

Also the plain HiFi-GAN V1 generator (``HiFiGANV1Generator``, static
convs), the unit vocoder's, and the standalone forward ODConv
(``ODConv1d``), which the flagship does not use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from hifigan_tpu_torch.models.layers import Dense, _const, _normal
from hifigan_tpu_torch.ops import conv as conv_ops
from hifigan_tpu_torch.ops import grc_lora as lora_ops
from hifigan_tpu_torch.ops import odconv as od_ops
from hifigan_tpu_torch.ops.cuda.grc_kernel import grc_chain, grc_step
from hifigan_tpu_torch.ops.film import film

MRF_BACKENDS = ("auto", "xla", "pallas", "pallas2")


@dataclass(frozen=True)
class GeneratorConfig:
    """Hyper-parameters, the JAX package's ``GeneratorConfig``.

    ``mrf_backend`` keeps the JAX names.  They all compute one function, and
    in the port they all take one path: the GRC chain runs the CUDA kernel on
    a CUDA tensor and its plain version on a CPU tensor."""

    input_channels: int = 80
    hidden_channels: int = 512
    kernel_size: int = 7
    upsample_factors: Tuple[int, ...] = (8, 8, 2, 2)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    speaker_dim: int = 192
    emotion_dim: int = 256
    odconv_k: int = 4
    lora_rank: int = 8
    grc_groups: int = 4
    leaky_slope: float = 0.1
    mrf_backend: str = "auto"

    @property
    def cond_dim(self) -> int:
        return self.speaker_dim + self.emotion_dim

    @property
    def upsample_ratio(self) -> int:
        r = 1
        for f in self.upsample_factors:
            r *= f
        return r


class FiLM(nn.Module):
    """``concat(spk, emo) → Dense → (δ, β)``, applied as ``(1 + δ)·x + β``."""

    def __init__(self, features: int, cond_dim: int, gen: torch.Generator):
        super().__init__()
        self.proj = Dense(cond_dim, 2 * features, gen, std=0.01)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.proj(cond).chunk(2, dim=-1)
        return film(x, 1.0 + gamma, beta)


class _ODAttentionHeads(nn.Module):
    """The four ODConv attention heads over the time-mean of the input."""

    def __init__(self, in_features, out_features, kernel_taps, num_kernels, gen):
        super().__init__()
        self.kernel_head = Dense(in_features, num_kernels, gen, std=0.02)
        self.spatial_head = Dense(in_features, kernel_taps, gen, std=0.02)
        self.in_ch_head = Dense(in_features, in_features, gen, std=0.02)
        self.out_ch_head = Dense(in_features, out_features, gen, std=0.02)

    def forward(self, x: torch.Tensor) -> od_ops.ODAttention:
        pooled = x.float().mean(dim=1)
        return od_ops.ODAttention(
            kernel=torch.softmax(self.kernel_head(pooled), dim=-1),
            spatial=torch.softmax(self.spatial_head(pooled), dim=-1),
            in_channel=torch.sigmoid(self.in_ch_head(pooled)),
            out_channel=torch.sigmoid(self.out_ch_head(pooled)),
        )


class ODConvTranspose1d(nn.Module):
    """Omni-dimensional dynamic transposed conv, the upsampler.

    Per sample, the K banks are mixed by the kernel attention and tap j is
    scaled by the spatial attention; the in-channel attention scales the
    input and the out-channel attention scales conv + bias."""

    def __init__(self, in_features, out_features, kernel_size, stride, padding=0,
                 num_kernels=4, dtype=torch.float32, *, gen):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.attention = _ODAttentionHeads(in_features, out_features, kernel_size, num_kernels, gen)
        self.kernels = _normal(gen, 0.01, num_kernels, in_features, out_features, kernel_size)
        self.bias = _const(0.0, num_kernels, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = self.attention(x)
        b = od_ops.mix_bias(self.bias, attn.kernel)
        w = od_ops.mix_kernels(self.kernels, attn.kernel, self.dtype)  # [B, Cin, Cout, k]
        w = w * attn.spatial[:, None, None, :].to(self.dtype)
        x = (x * attn.in_channel[:, None, :]).to(self.dtype)
        y = conv_ops.dynamic_conv_transpose1d(x, w, b, stride=self.stride, padding=self.padding)
        return (y * attn.out_channel[:, None, :]).to(self.dtype)


class ODConv1d(nn.Module):
    """Omni-dimensional dynamic forward conv: per sample the K banks
    ``[K, k, Cin, Cout]`` are mixed by the kernel attention and tap j is
    scaled by the spatial attention; the in-channel attention scales the
    input and the out-channel attention scales conv + bias."""

    def __init__(self, in_features, out_features, kernel_size, stride=1, padding=0, dilation=1,
                 num_kernels=4, dtype=torch.float32, *, gen):
        super().__init__()
        self.stride, self.padding, self.dilation, self.dtype = stride, padding, dilation, dtype
        self.attention = _ODAttentionHeads(in_features, out_features, kernel_size, num_kernels, gen)
        self.kernels = _normal(gen, 0.01, num_kernels, kernel_size, in_features, out_features)
        self.bias = _const(0.0, num_kernels, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = self.attention(x)
        w = od_ops.mix_kernels(self.kernels, attn.kernel, self.dtype)  # [B, k, Cin, Cout]
        w = w * attn.spatial[:, :, None, None].to(self.dtype)
        b = od_ops.mix_bias(self.bias, attn.kernel)
        x = (x * attn.in_channel[:, None, :]).to(self.dtype)
        y = conv_ops.dynamic_conv1d(x, w, b, stride=self.stride, padding=self.padding, dilation=self.dilation)
        return (y * attn.out_channel[:, None, :]).to(self.dtype)


class GRCLoRABlock(nn.Module):
    """Grouped residual conv + shared low-rank path: grouped dilated conv
    ⊕ α·LoRA(x) → 1×1 mixer → + residual → GroupNorm → LeakyReLU.

    The grouped conv, the LoRA path and the mixer fuse into one conv
    (:meth:`fused`): ``W2 = blockdiag(W)·Wmix`` with ``α·Wlora·Wmix`` added
    at the zero-shift tap, and bias ``wb·Wmix + bm``."""

    def __init__(self, channels, kernel_size=3, dilation=1, groups=4, lora_rank=8,
                 leaky_slope=0.1, dtype=torch.float32, *, gen):
        super().__init__()
        c, g = channels, groups
        self.kernel_size, self.dilation, self.groups = kernel_size, dilation, groups
        self.leaky_slope, self.dtype = leaky_slope, dtype
        self.grouped_kernel = _normal(gen, 0.01, kernel_size, c // g, c)
        self.grouped_bias = _const(0.0, c)
        self.lora_A = _normal(gen, 0.02, lora_rank, c // g)
        self.lora_B = _const(0.0, c // g, lora_rank)
        self.lora_alpha = _const(1.0, 1)
        self.mixer_kernel = _normal(gen, 0.01, 1, c, c)
        self.mixer_bias = _const(0.0, c)
        self.norm_gamma = _const(1.0, c)
        self.norm_beta = _const(0.0, c)

    def fused(self) -> dict:
        """The block as one conv plus its GroupNorm affine, for :func:`grc_chain`."""
        wm = self.mixer_kernel[0].float()
        w2 = torch.einsum(
            "kab,bc->kac", lora_ops.blockdiag_conv_kernel(self.grouped_kernel, self.groups).float(), wm
        )
        w_lora = lora_ops.lora_block_matrix(self.lora_A, self.lora_B, self.groups)
        w2[self.kernel_size // 2] += self.lora_alpha[0] * (w_lora @ wm)  # the zero-shift tap
        return {
            "w2": w2.to(self.dtype),
            "bias": self.grouped_bias @ wm + self.mixer_bias,
            "lo": (self.kernel_size - 1) * self.dilation // 2,
            "dilation": self.dilation,
            "gamma": self.norm_gamma,
            "beta": self.norm_beta,
        }

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The block alone, as separate ops (the JAX block's unfolded path)."""
        x = x.to(self.dtype)
        p = self.fused()
        mixed = conv_ops.conv1d(x, p["w2"], p["bias"], padding=p["lo"], dilation=self.dilation)
        y = lora_ops.group_norm(mixed + x, self.norm_gamma, self.norm_beta, self.groups)
        return conv_ops.leaky_relu(y, self.leaky_slope)


class Generator(nn.Module):
    """``forward(mel [B, n_mels, T], spk [B, 192], emo [B, 256]) → wav [B, 1, T·256]``."""

    def __init__(self, config: GeneratorConfig = GeneratorConfig(), dtype=torch.float32,
                 *, gen: torch.Generator):
        super().__init__()
        cfg = config
        if cfg.mrf_backend not in MRF_BACKENDS:
            raise ValueError(f"mrf_backend must be one of {MRF_BACKENDS}, got {cfg.mrf_backend!r}")
        self.config, self.dtype = cfg, dtype
        self.input_kernel = _normal(gen, 0.01, cfg.kernel_size, cfg.input_channels, cfg.hidden_channels)
        self.input_bias = _const(0.0, cfg.hidden_channels)
        self.film_0 = FiLM(cfg.hidden_channels, cfg.cond_dim, gen)
        ch = cfg.hidden_channels
        n_up = len(cfg.upsample_factors)
        for i, f in enumerate(cfg.upsample_factors):
            self.add_module(f"upsample_{i}", ODConvTranspose1d(
                ch, ch // 2, 2 * f, f, f // 2, cfg.odconv_k, dtype, gen=gen))
            self.add_module(f"film_{i + 1}", FiLM(ch // 2, cfg.cond_dim, gen))
            ch //= 2
        for i, (ks, dils) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations)):
            for j, d in enumerate(dils):
                self.add_module(f"mrf_{i}_grc_{j}", GRCLoRABlock(
                    ch, ks, d, cfg.grc_groups, cfg.lora_rank, cfg.leaky_slope, dtype, gen=gen))
            self.add_module(f"film_{n_up + i + 1}", FiLM(ch, cfg.cond_dim, gen))
        self.output_kernel = _normal(gen, 0.01, 7, ch, 1)
        self.output_bias = _const(0.0, 1)

    def forward(self, mel, speaker_emb, emotion_emb, *, step=grc_step) -> torch.Tensor:
        """``step`` is the GRC chain step: the kernel wrapper :func:`grc_step`,
        or ``grc_step_reference`` to run the plain version on a card."""
        cfg, dt = self.config, self.dtype
        cond = torch.cat([speaker_emb.float(), emotion_emb.float()], dim=-1)
        x = mel.transpose(1, 2).to(dt)
        x = conv_ops.conv1d(x, self.input_kernel.to(dt), self.input_bias, padding=(cfg.kernel_size - 1) // 2)
        x = self.film_0(x, cond)
        n_up = len(cfg.upsample_factors)
        for i in range(n_up):
            x = getattr(self, f"upsample_{i}")(x)
            x = conv_ops.leaky_relu(x, cfg.leaky_slope)
            x = getattr(self, f"film_{i + 1}")(x, cond)
        for i, (_, dils) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations)):
            blocks = [getattr(self, f"mrf_{i}_grc_{j}").fused() for j in range(len(dils))]
            x = x + grc_chain(x, blocks, groups=cfg.grc_groups, slope=cfg.leaky_slope, step=step)
            x = getattr(self, f"film_{n_up + i + 1}")(x, cond)
        x = conv_ops.conv1d(x, self.output_kernel.to(dt), self.output_bias, padding=3)
        return torch.tanh(x.float()).transpose(1, 2)


class _ResBlock1(nn.Module):
    """HiFi-GAN V1 ResBlock: for each dilation d, ``x += conv_k(lrelu(
    conv_k,d(lrelu(x))))``, static convs with "same" padding."""

    def __init__(self, channels: int, kernel_size: int, dilations: Tuple[int, ...], leaky_slope: float = 0.1,
                 dtype=torch.float32, *, gen: torch.Generator):
        super().__init__()
        c, k = channels, kernel_size
        self.kernel_size, self.dilations, self.leaky_slope, self.dtype = k, tuple(dilations), leaky_slope, dtype
        for j in range(len(self.dilations)):
            setattr(self, f"w1_{j}", _normal(gen, 0.01, k, c, c))
            setattr(self, f"b1_{j}", _const(0.0, c))
            setattr(self, f"w2_{j}", _normal(gen, 0.01, k, c, c))
            setattr(self, f"b2_{j}", _const(0.0, c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, dt = self.kernel_size, self.dtype
        for j, d in enumerate(self.dilations):
            h = conv_ops.leaky_relu(x, self.leaky_slope)
            h = conv_ops.conv1d(h, getattr(self, f"w1_{j}").to(dt), getattr(self, f"b1_{j}"),
                                padding=(k - 1) * d // 2, dilation=d)
            h = conv_ops.leaky_relu(h, self.leaky_slope)
            h = conv_ops.conv1d(h, getattr(self, f"w2_{j}").to(dt), getattr(self, f"b2_{j}"), padding=(k - 1) // 2)
            x = x + h
        return x


class HiFiGANV1Generator(nn.Module):
    """The plain (unconditioned) HiFi-GAN V1 generator, static convs
    throughout: ``mel [B, n_mels, T] → wav [B, 1, T·prod(upsample_factors)]``.
    Input conv (k 7) → per factor f: LeakyReLU, transposed conv (k 2f,
    stride f, padding f//2, channels halved), the mean of the ResBlocks →
    LeakyReLU → output conv (k 7) → tanh.  The unit vocoder's generator.
    Unfolded: the JAX package's time folding is a TPU lane layout."""

    def __init__(self, input_channels: int = 80, hidden_channels: int = 512,
                 upsample_factors: Tuple[int, ...] = (8, 8, 2, 2),
                 resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11),
                 resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 leaky_slope: float = 0.1, dtype=torch.float32, *, gen: torch.Generator):
        super().__init__()
        self.upsample_factors, self.resblock_kernel_sizes = tuple(upsample_factors), tuple(resblock_kernel_sizes)
        self.leaky_slope, self.dtype = leaky_slope, dtype
        self.input_kernel = _normal(gen, 0.01, 7, input_channels, hidden_channels)
        self.input_bias = _const(0.0, hidden_channels)
        ch = hidden_channels
        for i, f in enumerate(self.upsample_factors):
            setattr(self, f"up_{i}_kernel", _normal(gen, 0.01, ch, ch // 2, 2 * f))
            setattr(self, f"up_{i}_bias", _const(0.0, ch // 2))
            ch //= 2
            for k, dils in zip(self.resblock_kernel_sizes, resblock_dilations):
                self.add_module(f"res_{i}_{k}", _ResBlock1(ch, k, dils, leaky_slope, dtype, gen=gen))
        self.output_kernel = _normal(gen, 0.01, 7, ch, 1)
        self.output_bias = _const(0.0, 1)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        dt, slope = self.dtype, self.leaky_slope
        x = conv_ops.conv1d(mel.transpose(1, 2).to(dt), self.input_kernel.to(dt), self.input_bias, padding=3)
        for i, f in enumerate(self.upsample_factors):
            x = conv_ops.leaky_relu(x, slope)
            x = conv_ops.conv_transpose1d(x, getattr(self, f"up_{i}_kernel").to(dt), getattr(self, f"up_{i}_bias"),
                                          stride=f, padding=f // 2)
            acc = None
            for k in self.resblock_kernel_sizes:
                h = getattr(self, f"res_{i}_{k}")(x)
                acc = h if acc is None else acc + h
            x = acc / len(self.resblock_kernel_sizes)
        x = conv_ops.leaky_relu(x, slope)
        x = conv_ops.conv1d(x, self.output_kernel.to(dt), self.output_bias, padding=3)
        return torch.tanh(x.float()).transpose(1, 2)
