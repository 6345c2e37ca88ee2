"""Layers of the VAE stack: gated convolutions and autoregressive masked
layers.

PyTorch counterpart of `umnn_tpu/models/vae/layers.py`. The convolutions
are ``F.conv2d`` and ``F.conv_transpose2d`` (JAX computes them with
``lax.conv_general_dilated``, outside any Pallas kernel). Weights: a
convolution's are ``(out, in, kh, kw)`` as in JAX; a transposed
convolution's are ``(in, out, kh, kw)``, JAX's ``(out, in, kh, kw)`` with
its first two axes swapped and no spatial flip (JAX flips inside
``conv_transpose2d``); a masked linear's are ``nn.Linear``'s ``[dout, din]``
with its mask, a buffer, in the same layout. Inits follow JAX's
distributions (``conv_init``: U(+-1/sqrt(fan_in)) on weight and bias;
``masked_linear_init`` and ``masked_conv2d_init``: kaiming-normal and a
zero bias), drawn from an explicit ``torch.Generator``; every layer lives
on ``device``, the card unless the caller names another.

The float32 rule: :func:`ieee_float32` switches cuDNN's and cuBLAS's TF32
off for what runs under it and puts the caller's flags back after, since
cuDNN convolutions run in TF32 by default. The VAE's forward, encoder and
decoder run under it, the VAE driver's whole run too (its backward
passes included).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from umnn_tpu_torch.nn.core import resolve_device

__all__ = [
    "GatedConv2d",
    "GatedConvTranspose2d",
    "MaskedConv2d",
    "MaskedLinear",
    "build_block_mask",
    "build_pixelcnn_mask",
    "conv2d_layer",
    "ieee_float32",
]


@contextlib.contextmanager
def ieee_float32():
    """Convolutions and matrix products in IEEE float32 on the card inside
    the block (or the function it decorates): cuDNN takes TF32 unless told
    otherwise, cuBLAS as set. The flags are the caller's again on exit."""
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _uniform_fan_in(gen, shape, fan_in, device) -> tuple[nn.Parameter, nn.Parameter]:
    bound = 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape).uniform_(-bound, bound, generator=gen)
    b = torch.empty(shape[0]).uniform_(-bound, bound, generator=gen)
    return nn.Parameter(w.to(device)), nn.Parameter(b.to(device))


def conv2d_layer(
    in_ch: int, out_ch: int, ksize, gen: torch.Generator, stride=1, padding=0, dilation=1,
    device: torch.device | str | None = None,
) -> nn.Conv2d:
    """``nn.Conv2d`` with JAX's ``conv_init`` drawn from ``gen``."""
    device = resolve_device(device)
    kh, kw = _pair(ksize)
    conv = nn.Conv2d(in_ch, out_ch, (kh, kw), stride, padding, dilation, device="meta")
    conv.weight, conv.bias = _uniform_fan_in(gen, (out_ch, in_ch, kh, kw), in_ch * kh * kw, device)
    return conv


def _conv_transpose2d_layer(in_ch, out_ch, ksize, gen, stride, padding, output_padding, device):
    """``nn.ConvTranspose2d``; the init draws JAX's ``(out, in, kh, kw)``
    array and stores it as ``(in, out, kh, kw)``."""
    kh, kw = _pair(ksize)
    conv = nn.ConvTranspose2d(in_ch, out_ch, (kh, kw), stride, padding, output_padding,
                              device="meta")
    w, b = _uniform_fan_in(gen, (out_ch, in_ch, kh, kw), in_ch * kh * kw, device)
    conv.weight, conv.bias = nn.Parameter(w.detach().transpose(0, 1).contiguous()), b
    return conv


class GatedConv2d(nn.Module):
    """``h(x) * sigmoid(g(x))``, two convolutions of one geometry
    (`umnn_tpu/models/vae/layers.py:85-90`); ``h`` is drawn before ``g``."""

    def __init__(
        self, in_ch: int, out_ch: int, ksize, gen: torch.Generator, stride=1, padding=0,
        dilation=1, activation: Optional[Callable] = None,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.activation = activation
        self.h = conv2d_layer(in_ch, out_ch, ksize, gen, stride, padding, dilation, device)
        self.g = conv2d_layer(in_ch, out_ch, ksize, gen, stride, padding, dilation, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.h(x)
        if self.activation is not None:
            h = self.activation(h)
        return h * torch.sigmoid(self.g(x))


class GatedConvTranspose2d(nn.Module):
    """The transposed form (`layers.py:93-100`), torch's ConvTranspose2d
    geometry: ``out = (in - 1) s - 2 p + k + output_padding``."""

    def __init__(
        self, in_ch: int, out_ch: int, ksize, gen: torch.Generator, stride=1, padding=0,
        output_padding=0, activation: Optional[Callable] = None,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.activation = activation
        self.h = _conv_transpose2d_layer(in_ch, out_ch, ksize, gen, stride, padding,
                                         output_padding, device)
        self.g = _conv_transpose2d_layer(in_ch, out_ch, ksize, gen, stride, padding,
                                         output_padding, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.h(x)
        if self.activation is not None:
            h = self.activation(h)
        return h * torch.sigmoid(self.g(x))


def build_block_mask(n_in: int, n_out: int, diagonal_zeros: bool = False) -> np.ndarray:
    """IAF's k-block triangular mask ``[n_in, n_out]``: output block i sees
    input blocks < i (and == i unless ``diagonal_zeros``)."""
    if not (n_in % n_out == 0 or n_out % n_in == 0):
        raise ValueError(f"incompatible sizes {n_in} {n_out}")
    mask = np.ones((n_in, n_out), dtype=np.float32)
    if n_out >= n_in:
        k = n_out // n_in
        for i in range(n_in):
            mask[i + 1 :, i * k : (i + 1) * k] = 0
            if diagonal_zeros:
                mask[i : i + 1, i * k : (i + 1) * k] = 0
    else:
        k = n_in // n_out
        for i in range(n_out):
            mask[(i + 1) * k :, i : i + 1] = 0
            if diagonal_zeros:
                mask[i * k : (i + 1) * k, i : i + 1] = 0
    return mask


class MaskedLinear(nn.Module):
    """``x @ (W * mask) + b`` with ``mask = build_block_mask(n_in, n_out,
    diagonal_zeros)``; weight ``[n_out, n_in]`` kaiming-normal, bias 0."""

    def __init__(
        self, n_in: int, n_out: int, gen: torch.Generator, diagonal_zeros: bool = False,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        device = resolve_device(device)
        w = torch.randn(n_in, n_out, generator=gen) * math.sqrt(2.0 / n_in)
        self.weight = nn.Parameter(w.T.contiguous().to(device))
        self.bias = nn.Parameter(torch.zeros(n_out, device=device))
        mask = build_block_mask(n_in, n_out, diagonal_zeros)
        self.register_buffer("mask", torch.as_tensor(mask.T.copy(), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight * self.mask, self.bias)


def build_pixelcnn_mask(
    n_in: int,
    n_out: int,
    size_kernel: tuple[int, int] = (3, 3),
    diagonal_zeros: bool = False,
) -> np.ndarray:
    """PixelCNN's autoregressive conv mask ``[n_out, n_in, kh, kw]``
    (`layers.py:137-170`): the taps before the kernel's centre in raster
    order are zero, and the centre tap has :func:`build_block_mask`'s
    k-block triangle."""
    if not (n_in % n_out == 0 or n_out % n_in == 0):
        raise ValueError(f"incompatible sizes {n_in} {n_out}")
    l = (size_kernel[0] - 1) // 2
    m = (size_kernel[1] - 1) // 2
    mask = np.ones((n_out, n_in, *size_kernel), dtype=np.float32)
    mask[:, :, :l, :] = 0
    mask[:, :, l, :m] = 0
    if n_out >= n_in:
        k = n_out // n_in
        for i in range(n_in):
            mask[i * k : (i + 1) * k, i + 1 :, l, m] = 0
            if diagonal_zeros:
                mask[i * k : (i + 1) * k, i : i + 1, l, m] = 0
    else:
        k = n_in // n_out
        for i in range(n_out):
            mask[i : i + 1, (i + 1) * k :, l, m] = 0
            if diagonal_zeros:
                mask[i : i + 1, i * k : (i + 1) * k, l, m] = 0
    return mask


class MaskedConv2d(nn.Module):
    """A convolution with :func:`build_pixelcnn_mask`'s mask and "same"
    padding (`layers.py:173-191`); weight kaiming-normal over the fan-in,
    bias 0."""

    def __init__(
        self, n_in: int, n_out: int, gen: torch.Generator, size_kernel=(3, 3),
        diagonal_zeros: bool = False, device: torch.device | str | None = None,
    ):
        super().__init__()
        device = resolve_device(device)
        kh, kw = size_kernel
        w = torch.randn(n_out, n_in, kh, kw, generator=gen) * math.sqrt(2.0 / (n_in * kh * kw))
        self.weight = nn.Parameter(w.to(device))
        self.bias = nn.Parameter(torch.zeros(n_out, device=device))
        mask = build_pixelcnn_mask(n_in, n_out, (kh, kw), diagonal_zeros)
        self.register_buffer("mask", torch.as_tensor(mask, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.weight.shape[-2:]
        return F.conv2d(x, self.weight * self.mask, self.bias, padding=(kh // 2, kw // 2))
