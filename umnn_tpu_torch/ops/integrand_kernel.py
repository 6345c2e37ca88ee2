"""Fused Clenshaw-Curtis integral of the UMNN integrand MLP.

PyTorch counterpart of `umnn_tpu/ops/integrand_kernel.py::fused_cc_integral`
(`:1290-1357`), forward only. Per row r:

    z_r = x_r/2 * sum_n w_n * ELU+1(MLP([x_r * s_n, h_r])),  s_n = (t_n+1)/2

with LeakyReLU(neg_slope) hidden layers. On CUDA tensors the wrapper
launches the hand-written kernel of ``csrc/integrand_fwd.cu`` (the Hopper
port of the TPU kernel `_fwd_kernel`, `:106-153`) or raises; on CPU tensors
it runs :func:`fused_cc_integral_plain`, the same arithmetic in plain
PyTorch. The backward (`_bwd_kernel`) is not ported yet.

Weights follow ``nn.Linear``: ``ws[l]`` is ``[dout, din]``, ``bs[l]`` is
``[dout]``; the first layer's input is ``[x, h]`` and the last has one output.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

__all__ = ["LAUNCHES", "fused_cc_integral", "fused_cc_integral_plain"]

# Kernel launches since the count was last set to 0.
LAUNCHES = 0


def _leaky(v: torch.Tensor, neg_slope: float) -> torch.Tensor:
    return torch.where(v > 0, v, neg_slope * v)


def _eluplus(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v > 0, v + 1.0, torch.exp(torch.clamp(v, max=0.0)))


def fused_cc_integral_plain(
    ws: Sequence[torch.Tensor],
    bs: Sequence[torch.Tensor],
    x: torch.Tensor,
    h: torch.Tensor,
    nodes: torch.Tensor,
    ccw: torch.Tensor,
    neg_slope: float = 0.01,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``[R, K, width]`` activations."""
    e = h.shape[-1]
    xf = x.reshape(-1)
    hf = h.reshape(-1, e)
    s = (nodes.reshape(-1) + 1.0) * 0.5
    ph = hf @ ws[0][:, 1:].T + bs[0]  # node-invariant part of layer 1, [R, H1]
    xs = xf[:, None] * s[None, :]  # [R, K]
    a = _leaky(ph[:, None, :] + xs[..., None] * ws[0][:, 0], neg_slope)
    for w, b in zip(ws[1:-1], bs[1:-1]):
        a = _leaky(a @ w.T + b, neg_slope)
    f = _eluplus(a @ ws[-1][0] + bs[-1][0])  # [R, K]
    return ((f * ccw.reshape(-1)).sum(-1) * xf * 0.5).reshape(x.shape)


def fused_cc_integral(
    ws: Sequence[torch.Tensor],
    bs: Sequence[torch.Tensor],
    x: torch.Tensor,
    h: torch.Tensor,
    nodes: torch.Tensor,
    ccw: torch.Tensor,
    neg_slope: float = 0.01,
) -> torch.Tensor:
    """``∫_0^x f(t, h) dt`` for the UMNN integrand MLP; ``x [...]``,
    ``h [..., e]``, ``nodes``/``ccw`` the K CC nodes and weights.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if len(ws) < 2:
        # the kernel keeps the first (node-invariant) and output layers apart
        raise ValueError(
            "fused_cc_integral requires an integrand MLP with at least one "
            "hidden layer; use the plain quadrature path for single-layer nets"
        )
    if len(bs) != len(ws):
        raise ValueError(f"{len(ws)} weights but {len(bs)} biases")
    tensors = [x, h, nodes, ccw, *ws, *bs]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"fused_cc_integral: tensors on several devices {devices}")
    if x.device.type == "cpu":
        return fused_cc_integral_plain(ws, bs, x, h, nodes, ccw, neg_slope)
    if x.device.type != "cuda":
        raise ValueError(f"fused_cc_integral: no kernel for device {x.device}")
    return _launch(ws, bs, x, h, nodes, ccw, neg_slope, tensors)


def _launch(ws, bs, x, h, nodes, ccw, neg_slope, tensors) -> torch.Tensor:
    global LAUNCHES
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"fused_cc_integral: the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("fused_cc_integral: the kernel takes contiguous tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "fused_cc_integral: the CUDA kernel has no backward yet; "
            "call it under torch.no_grad()"
        )
    if h.dim() != x.dim() + 1 or h.shape[:-1] != x.shape:
        raise ValueError(f"h {tuple(h.shape)} does not match x {tuple(x.shape)} + [e]")
    K = nodes.numel()
    if K < 1 or ccw.numel() != K:
        raise ValueError(f"{K} nodes but {ccw.numel()} weights")
    widths = [h.shape[-1] + 1] + [w.shape[0] for w in ws]
    for l, (w, b) in enumerate(zip(ws, bs)):
        if w.dim() != 2 or w.shape[1] != widths[l] or b.shape != (widths[l + 1],):
            raise ValueError(
                f"layer {l}: weight {tuple(w.shape)}, bias {tuple(b.shape)} do not "
                f"take {widths[l]} inputs"
            )
    if widths[-1] != 1:
        raise ValueError(f"the integrand has {widths[-1]} outputs, the kernel takes 1")

    from umnn_tpu_torch.ops._build import load_library

    lib = load_library()
    c_widths = (ctypes.c_int * len(widths))(*widths)
    smem = lib.umnn_integrand_fwd_smem_bytes(K, ctypes.cast(c_widths, ctypes.c_void_p), len(ws))
    if smem < 0:
        # the C side holds the limits: MAX_LAYERS and MAX_WIDTH of the .cu file
        raise ValueError(
            f"widths {widths}: beyond the layer count or hidden width that "
            f"csrc/integrand_fwd.cu takes"
        )
    props = torch.cuda.get_device_properties(x.device)
    limit = getattr(props, "shared_memory_per_block_optin", smem)
    if smem > limit:
        raise ValueError(
            f"widths {widths} with {K} nodes need {smem} bytes of shared memory; "
            f"the card gives a block {limit}"
        )
    R = x.numel()
    out = torch.empty(R, dtype=torch.float32, device=x.device)
    if R == 0:
        return out.reshape(x.shape)
    # one buffer: per layer W^T [din, dout] row-major, then b
    params = torch.cat([t.reshape(-1) for w, b in zip(ws, bs) for t in (w.T.contiguous(), b)])
    with torch.cuda.device(x.device):
        rc = lib.umnn_integrand_fwd(
            x.data_ptr(), h.data_ptr(), params.data_ptr(), nodes.data_ptr(),
            ccw.data_ptr(), out.data_ptr(), R, K,
            ctypes.cast(c_widths, ctypes.c_void_p), len(ws), float(neg_slope),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"integrand_fwd kernel launch failed: {lib.umnn_cuda_error_string(rc).decode()}"
        )
    LAUNCHES += 1
    return out.reshape(x.shape)
