"""Convolution primitives of the port, channels-last.

Counterpart of ``hifigan_tpu/ops/conv.py``.  The public functions keep the
JAX package's layouts: activations ``[B, T, C]`` (2-D: ``[B, H, W, C]``),
conv kernels ``[k, Cin, Cout]`` (WIO; 2-D: ``[kh, kw, Cin, Cout]``, HWIO),
transposed-conv kernels ``[Cin, Cout, k]`` and per-sample kernels with a
leading batch dim.  PyTorch's convolutions take ``[B, C, T]`` and
``[Cout, Cin, k]``, so each function transposes at its boundary.

The JAX package's polyphase and time-folded formulations
(``folded_polyphase_*``, ``ops/fold.py``) pack four time steps into the
TPU's 128 lanes; the port runs unfolded and needs neither.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    padding: int | tuple[int, int] = 0,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """1-D convolution: ``x [B, T, Cin]``, ``w [k, Cin // groups, Cout]``,
    ``b [Cout]``.

    ``padding`` is symmetric (int) or ``(lo, hi)``.  The bias is cast to
    the activation dtype before the add, as in the JAX package."""
    lo, hi = (padding, padding) if isinstance(padding, int) else padding
    xt = x.transpose(1, 2)
    if lo or hi:
        xt = F.pad(xt, (lo, hi))
    y = F.conv1d(xt, w.permute(2, 1, 0).to(x.dtype), dilation=dilation, groups=groups).transpose(1, 2)
    if b is not None:
        y = y + b.to(y.dtype)
    return y.to(x.dtype)


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    padding: int | tuple[int, int] = 0,
) -> torch.Tensor:
    """2-D convolution: ``x [B, H, W, Cin]``, ``w [kh, kw, Cin, Cout]``,
    ``b [Cout]``; ``padding`` is symmetric on each axis (one int for both,
    or ``(ph, pw)``).  The bias is cast to the activation dtype, as in the
    JAX package."""
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype), padding=(ph, pw))
    y = y.permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.to(y.dtype)
    return y.to(x.dtype)


def avg_pool1d(x: torch.Tensor, window: int, stride: int | None = None) -> torch.Tensor:
    """Average pool over time of ``x [B, T, C]``: VALID windows, the sum in
    fp32 divided by ``window``, cast back to ``x``'s dtype (torch
    ``AvgPool1d`` semantics, as the JAX package's)."""
    y = F.avg_pool1d(x.float().transpose(1, 2), window, stride or window)
    return y.transpose(1, 2).to(x.dtype)


def conv_transpose1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    stride: int,
    padding: int = 0,
) -> torch.Tensor:
    """Static-weight transposed conv: ``x [B, T, Cin]``, ``w [Cin, Cout, k]``
    (torch's layout), ``b [Cout]`` → ``[B, (T-1)·stride − 2·padding + k,
    Cout]``.  The JAX package's polyphase form of the same function is a
    TPU layout; here it is one ``F.conv_transpose1d``.  The bias is added in
    fp32, as there."""
    y = F.conv_transpose1d(x.transpose(1, 2), w.to(x.dtype), stride=stride, padding=padding).transpose(1, 2)
    if b is not None:
        y = y.float() + b.float()
    return y.to(x.dtype)


def dynamic_conv_transpose1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    stride: int,
    padding: int = 0,
) -> torch.Tensor:
    """Per-sample transposed conv (the ODConv upsampler).

    ``x [B, T, Cin]``, ``w [B, Cin, Cout, k]``, ``b [B, Cout]`` or ``[Cout]``
    → ``[B, (T-1)·stride + k - 2·padding, Cout]``.  The B filters run as
    one grouped transposed conv (``groups=B``); the bias is added in fp32.
    """
    B, T, cin = x.shape
    cout, k = w.shape[2], w.shape[3]
    y = F.conv_transpose1d(
        x.transpose(1, 2).reshape(1, B * cin, T),
        w.reshape(B * cin, cout, k).to(x.dtype),
        stride=stride, padding=padding, groups=B,
    )
    y = y.reshape(B, cout, -1).transpose(1, 2)
    if b is not None:
        y = y.float() + (b[:, None, :] if b.dim() == 2 else b).float()
    return y.to(x.dtype)


def extract_patches_1d(
    x: torch.Tensor,
    kernel_size: int,
    *,
    stride: int = 1,
    padding: int = 0,
    dilation: int = 1,
) -> torch.Tensor:
    """Im2col of ``x [B, T, C]`` → ``[B, T_out, kernel_size, C]``, tap i
    the zero-padded input from ``i·dilation`` in steps of ``stride``;
    ``T_out = (T + 2·padding − dilation·(kernel_size − 1) − 1) // stride + 1``."""
    t_out = (x.shape[1] + 2 * padding - dilation * (kernel_size - 1) - 1) // stride + 1
    if padding:
        x = F.pad(x, (0, 0, padding, padding))
    taps = [x[:, i * dilation: i * dilation + (t_out - 1) * stride + 1: stride] for i in range(kernel_size)]
    return torch.stack(taps, dim=2)


def dynamic_conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    stride: int = 1,
    padding: int = 0,
    dilation: int = 1,
) -> torch.Tensor:
    """Per-sample-filter conv as a batched patch product: ``x [B, T, Cin]``,
    ``w [B, k, Cin, Cout]``, ``b [B, Cout]`` or ``[Cout]`` → ``[B, T_out,
    Cout]``.  The products are summed in fp32 and the bias added there, as
    the JAX einsum with ``preferred_element_type=float32`` does; the result
    is cast to ``x``'s dtype."""
    B, k = w.shape[0], w.shape[1]
    patches = extract_patches_1d(x, k, stride=stride, padding=padding, dilation=dilation)
    t_out = patches.shape[1]
    y = torch.bmm(patches.reshape(B, t_out, -1).float(), w.reshape(B, -1, w.shape[-1]).float())
    if b is not None:
        y = y + (b[:, None, :] if b.dim() == 2 else b).float()
    return y.to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)
