"""Fused Clenshaw-Curtis integral of the UMNN integrand MLP.

PyTorch counterpart of `umnn_tpu/ops/integrand_kernel.py::fused_cc_integral`
(`:1290-1357`) and its custom VJP (`:1083-1287`). Per row r:

    z_r = x_r/2 * sum_n w_n * ELU+1(MLP([x_r * s_n, h_r])),  s_n = (t_n+1)/2

with LeakyReLU(neg_slope) hidden layers. On CUDA tensors the wrapper runs
an autograd Function whose forward and backward launch one of four kernel
pairs:

- the unpacked pair, ``csrc/integrand_fwd.cu`` (the Hopper port of
  `_fwd_kernel`, `:106-153`) and ``csrc/integrand_bwd.cu`` (the port of
  `_bwd_kernel`, `:156-317`, with the host fold of `_fused_vjp_bwd`);
- the pack-2 pair, ``csrc/integrand_fwd_p2.cu`` and
  ``csrc/integrand_bwd_p2.cu`` (the ports of `_fwd_kernel_p2`, `:333-381`,
  and `_bwd_kernel_p2`, `:384-506`, with the fold of `_fused_vjp_bwd_p2`),
  for integrands whose input and hidden layers are at most 64 wide. They
  take two quadrature nodes at a time;
- the pack-4 pair, ``csrc/integrand_fwd_p4.cu`` and
  ``csrc/integrand_bwd_p4.cu`` (the ports of `_fwd_kernel_pn`, `:522-570`,
  and `_bwd_kernel_pn`, `:573-700`, with the fold of `_fused_vjp_bwd_pn`),
  for integrands at most 32 wide, the route JAX gives four nodes at a time.
  They read each layer's weight and bias in place (their addresses are the
  launch's argument), so this route packs nothing on the host, and their
  launch configuration (the shared memory set on the kernel, the resident
  blocks) is asked of the C helpers once per widths, K and device;
- the streamed pair, ``csrc/integrand_wide.cu``, for what the other three
  pairs' kernels refuse (hidden widths past their limits, more than
  MAX_LAYERS layers, a set past the card's shared memory per block): the
  port of `_fwd_kernel` and `_bwd_kernel` at those widths, which JAX pads
  to 128-lane multiples (`:59-70`). It keeps the weights in device memory
  and computes the rows in chunks (:func:`_wide_chunks`); its backward also
  reads each layer's W in place, in ``nn.Linear``'s layout.

``pack4=None`` and ``pack2=None`` pick the pair as JAX's auto does
(`:1334-1343`): pack-4 where :func:`_pack4_applicable` holds, else pack-2
where :func:`_pack2_applicable` holds, else the unpacked pair; pack-4 wins
over pack-2 whatever ``pack2`` says. Where a kernel of that pair refuses
the widths (its C helper, the one authority on its limits, says so), the
call, forward and backward alike, goes to the streamed pair. The gradient
is the exact derivative of the K-node approximation, x's node path
included. On CPU tensors the wrapper runs :func:`fused_cc_integral_plain`,
the same arithmetic in plain PyTorch, and autograd differentiates it. All four pairs compute that one
function (the packed pairs change only how nodes are grouped and in what
order sums are taken), so the plain versions here are the plain versions
of all four.

Weights follow ``nn.Linear``: ``ws[l]`` is ``[dout, din]``, ``bs[l]`` is
``[dout]``; the first layer's input is ``[x, h]`` and the last has one output.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Sequence

import torch

from umnn_tpu_torch.ops import _build

__all__ = [
    "LAUNCHES",
    "fused_cc_integral",
    "fused_cc_integral_bwd",
    "fused_cc_integral_bwd_plain",
    "fused_cc_integral_plain",
]

# Launches of each kernel since its count was last set to 0.
LAUNCHES = {
    "integrand_fwd": 0, "integrand_bwd": 0, "integrand_fwd_p2": 0, "integrand_bwd_p2": 0,
    "integrand_fwd_p4": 0, "integrand_bwd_p4": 0, "integrand_fwd_wide": 0,
    "integrand_bwd_wide": 0,
}

# Widest input or hidden layer of the pack-2 and pack-4 routes: half and a
# quarter of the TPU's 128 lanes in the JAX package; the packed kernels
# here take them as their compile-time bounds.
PACK2_WIDTH = 64
PACK4_WIDTH = 32
# Device memory the streamed pair's activations of one chunk of rows may
# take, in bytes.
WIDE_BUDGET = 512 << 20


def _packable(ws, width: int) -> bool:
    return (
        len(ws) >= 2
        and ws[0].shape[1] <= width  # 1 + e
        and all(w.shape[0] <= width for w in ws[:-1])  # hidden widths
        and ws[-1].shape[0] == 1  # scalar integrand head
    )


def _pack2_applicable(ws) -> bool:
    """Whether JAX's pack-2 route takes these ``nn.Linear`` weights
    (`umnn_tpu/ops/integrand_kernel.py:893-900`)."""
    return _packable(ws, PACK2_WIDTH)


def _pack4_applicable(ws) -> bool:
    """Whether JAX's pack-4 route takes them (`:746-753`); JAX's auto
    gives it priority over pack-2."""
    return _packable(ws, PACK4_WIDTH)


def _route(ws, pack2: bool | None, pack4: bool | None = None) -> str:
    """The kernel pair's suffix: ``"_p4"``, ``"_p2"`` or ``""`` (unpacked),
    as JAX's auto picks it where an argument is ``None``; raises for
    ``pack4=True`` or ``pack2=True`` on widths that pair cannot take."""
    for packed, applicable, width, name in (
        (pack4, _pack4_applicable, PACK4_WIDTH, "pack4"),
        (pack2, _pack2_applicable, PACK2_WIDTH, "pack2"),
    ):
        if packed and not applicable(ws):
            raise ValueError(
                f"{name}=True needs 1 + e and every hidden width <= {width} and one "
                f"output; got layers {[tuple(w.shape) for w in ws]}"
            )
    if pack4 if pack4 is not None else _pack4_applicable(ws):
        return "_p4"
    if pack2 if pack2 is not None else _pack2_applicable(ws):
        return "_p2"
    return ""


def _leaky(v: torch.Tensor, neg_slope: float) -> torch.Tensor:
    return torch.where(v > 0, v, neg_slope * v)


def _eluplus(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v > 0, v + 1.0, torch.exp(torch.clamp(v, max=0.0)))


def _node_values_plain(ws, bs, x, h, nodes, neg_slope) -> torch.Tensor:
    """``f`` at every (row, node) pair, ``[R, K]``, with ``[R, K, width]``
    activations."""
    e = h.shape[-1]
    xf = x.reshape(-1)
    hf = h.reshape(-1, e)
    s = (nodes.reshape(-1) + 1.0) * 0.5
    ph = hf @ ws[0][:, 1:].T + bs[0]  # node-invariant part of layer 1, [R, H1]
    xs = xf[:, None] * s[None, :]  # [R, K]
    a = _leaky(ph[:, None, :] + xs[..., None] * ws[0][:, 0], neg_slope)
    for w, b in zip(ws[1:-1], bs[1:-1]):
        a = _leaky(a @ w.T + b, neg_slope)
    return _eluplus(a @ ws[-1][0] + bs[-1][0])


def fused_cc_integral_plain(
    ws: Sequence[torch.Tensor],
    bs: Sequence[torch.Tensor],
    x: torch.Tensor,
    h: torch.Tensor,
    nodes: torch.Tensor,
    ccw: torch.Tensor,
    neg_slope: float = 0.01,
) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch."""
    f = _node_values_plain(ws, bs, x, h, nodes, neg_slope)
    return ((f * ccw.reshape(-1)).sum(-1) * x.reshape(-1) * 0.5).reshape(x.shape)


def fused_cc_integral_bwd_plain(
    ws: Sequence[torch.Tensor],
    bs: Sequence[torch.Tensor],
    x: torch.Tensor,
    h: torch.Tensor,
    nodes: torch.Tensor,
    ccw: torch.Tensor,
    g: torch.Tensor,
    neg_slope: float = 0.01,
):
    """The backward kernel's function in plain PyTorch: autograd through
    :func:`fused_cc_integral_plain` with cotangent ``g``.

    Returns ``(dws, dbs, dx, dh, S)``, with ``dx`` the whole derivative
    (node path plus ``g S/2``) and ``S_r = sum_n w_n f_{r,n}``.
    """
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (*ws, *bs, x, h)]
        n = len(ws)
        lws, lbs, lx, lh = leaves[:n], leaves[n : 2 * n], leaves[-2], leaves[-1]
        f = _node_values_plain(lws, lbs, lx, lh, nodes, neg_slope)
        S = (f * ccw.reshape(-1)).sum(-1)
        z = (S * lx.reshape(-1) * 0.5).reshape(x.shape)
        grads = torch.autograd.grad(z, leaves, g)
    return (
        list(grads[:n]), list(grads[n : 2 * n]), grads[-2], grads[-1],
        S.detach().reshape(x.shape),
    )


def fused_cc_integral(
    ws: Sequence[torch.Tensor],
    bs: Sequence[torch.Tensor],
    x: torch.Tensor,
    h: torch.Tensor,
    nodes: torch.Tensor,
    ccw: torch.Tensor,
    neg_slope: float = 0.01,
    pack2: bool | None = None,
    pack4: bool | None = None,
) -> torch.Tensor:
    """``∫_0^x f(t, h) dt`` for the UMNN integrand MLP; ``x [...]``,
    ``h [..., e]`` with ``e >= 1``, ``nodes``/``ccw`` the K CC nodes and
    weights.

    CPU tensors run the plain version; CUDA tensors launch the kernels of
    the pair ``pack4`` and ``pack2`` pick (``None``: as JAX's auto).
    """
    tensors = [x, h, nodes, ccw, *ws, *bs]
    on_card = _on_card("fused_cc_integral", ws, bs, tensors)
    route = _route(ws, pack2, pack4)
    if not on_card:
        return fused_cc_integral_plain(ws, bs, x, h, nodes, ccw, neg_slope)
    widths, route = _check(ws, bs, x, h, nodes, ccw, tensors, route)
    return _FusedIntegral.apply(x, h, nodes, ccw, float(neg_slope), widths, route, *ws, *bs)


def fused_cc_integral_bwd(
    ws: Sequence[torch.Tensor],
    bs: Sequence[torch.Tensor],
    x: torch.Tensor,
    h: torch.Tensor,
    nodes: torch.Tensor,
    ccw: torch.Tensor,
    g: torch.Tensor,
    neg_slope: float = 0.01,
    pack2: bool | None = None,
    pack4: bool | None = None,
):
    """The backward of :func:`fused_cc_integral` for cotangent ``g``:
    ``(dws, dbs, dx, dh, S)`` as :func:`fused_cc_integral_bwd_plain` gives
    them. CPU tensors run that plain version; CUDA tensors launch the
    backward kernel of the pair ``pack4`` and ``pack2`` pick (what the
    autograd Function's backward calls)."""
    tensors = [x, h, nodes, ccw, g, *ws, *bs]
    on_card = _on_card("fused_cc_integral_bwd", ws, bs, tensors)
    route = _route(ws, pack2, pack4)
    if not on_card:
        return fused_cc_integral_bwd_plain(ws, bs, x, h, nodes, ccw, g, neg_slope)
    widths, route = _check(ws, bs, x, h, nodes, ccw, tensors, route)
    return _launch_bwd(ws, bs, x, h, nodes, ccw, g, float(neg_slope), widths, route)


def _on_card(name: str, ws, bs, tensors) -> bool:
    """Whether the call goes to a kernel (CUDA tensors) or to the plain
    version (CPU tensors); raises on what neither takes."""
    if len(ws) < 2:
        # the kernels keep the first (node-invariant) and output layers apart
        raise ValueError(
            f"{name} requires an integrand MLP with at least one "
            "hidden layer; use the plain quadrature path for single-layer nets"
        )
    if len(bs) != len(ws):
        raise ValueError(f"{len(ws)} weights but {len(bs)} biases")
    if ws[0].shape[-1] < 2:
        # h with no column: no kernel was built or checked for it
        raise ValueError(
            f"{name}: the first layer takes [x, h] with at least one column of h; "
            f"got weight {tuple(ws[0].shape)}"
        )
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    device = tensors[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {device}")
    return device.type == "cuda"


class _FusedIntegral(torch.autograd.Function):
    """Forward: ``integrand_fwd{route}``; backward: ``integrand_bwd{route}``
    of the same pair, which recomputes the forward from the saved inputs
    (nothing of the node sweep is saved) and returns dW in ``nn.Linear``'s
    layout."""

    @staticmethod
    def forward(ctx, x, h, nodes, ccw, neg_slope, widths, route, *wbs):
        n = len(wbs) // 2
        ctx.neg_slope, ctx.widths, ctx.route = neg_slope, widths, route
        ctx.save_for_backward(x, h, nodes, ccw, *wbs)
        return _launch_fwd(wbs[:n], wbs[n:], x, h, nodes, ccw, neg_slope, widths, route)

    @staticmethod
    def backward(ctx, g):
        x, h, nodes, ccw, *wbs = ctx.saved_tensors
        n = len(wbs) // 2
        dws, dbs, dx, dh, _ = _launch_bwd(
            wbs[:n], wbs[n:], x, h, nodes, ccw, g.contiguous(), ctx.neg_slope, ctx.widths,
            ctx.route,
        )
        return dx, dh, None, None, None, None, None, *dws, *dbs


def _wide_chunks(R: int, K: int, widths, budget: int = WIDE_BUDGET) -> list:
    """The streamed pair's chunks of rows, ``[(start, stop), ...]`` in order,
    covering ``range(R)`` once: as many rows each as keep the activations
    of every hidden layer, ``n_hidden x rows x K x max_width`` floats,
    within ``budget`` bytes (at least one row)."""
    per_row = 4 * (len(widths) - 2) * K * max(widths[1:-1])
    rows = max(1, min(R, budget // per_row))
    return [(a, min(a + rows, R)) for a in range(0, R, rows)]


def _check(ws, bs, x, h, nodes, ccw, tensors, route) -> tuple:
    """What the kernels take: ``(widths, route)``, the widths ``[1+e, ...,
    1]`` and the pair's suffix, ``"_wide"`` where either kernel of
    ``route``'s pair refuses them, so that a forward and its backward never
    take different pairs."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"fused_cc_integral: the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("fused_cc_integral: the kernel takes contiguous tensors")
    if h.dim() != x.dim() + 1 or h.shape[:-1] != x.shape:
        raise ValueError(f"h {tuple(h.shape)} does not match x {tuple(x.shape)} + [e]")
    K = nodes.numel()
    if K < 1 or ccw.numel() != K:
        raise ValueError(f"{K} nodes but {ccw.numel()} weights")
    widths = (h.shape[-1] + 1, *(w.shape[0] for w in ws))
    for l, (w, b) in enumerate(zip(ws, bs)):
        if w.dim() != 2 or w.shape[1] != widths[l] or b.shape != (widths[l + 1],):
            raise ValueError(
                f"layer {l}: weight {tuple(w.shape)}, bias {tuple(b.shape)} do not "
                f"take {widths[l]} inputs"
            )
    if widths[-1] != 1:
        raise ValueError(f"the integrand has {widths[-1]} outputs, the kernel takes 1")
    if min(widths) < 1:
        raise ValueError(f"widths {widths}: every layer must be at least 1 wide")
    lib = _build.load_library()
    if not all(_staged_takes(lib, kind + route, widths, K, x.device) for kind in ("fwd", "bwd")):
        route = "_wide"
    return widths, route


@functools.cache
def _c_widths(widths: tuple):
    """The widths as a C int array, behind a pointer that keeps it alive;
    one per set of widths."""
    c_widths = (ctypes.c_int * len(widths))(*widths)
    ptr = ctypes.cast(c_widths, ctypes.c_void_p)
    ptr._keep = c_widths
    return ptr


@functools.cache
def _staged_takes(lib, kernel: str, widths: tuple, K: int, device) -> bool:
    """Whether a staged kernel takes the widths: its own C helper (the one
    authority on its limits) gives a shared-memory size, -1 past MAX_LAYERS
    of csrc/common.cuh or the .cu file's MAX_WIDTH, and the card gives a
    block that much. Asked once per library, kernel, widths, K and device."""
    smem = getattr(lib, f"umnn_integrand_{kernel}_smem_bytes")(K, _c_widths(widths),
                                                                  len(widths) - 1)
    props = torch.cuda.get_device_properties(device)
    return 0 <= smem <= getattr(props, "shared_memory_per_block_optin", smem)


@functools.cache
def _slots(lib, kernel: str, widths: tuple, K: int, device) -> int:
    """A pack-4 kernel's resident blocks on the card for these widths and K:
    its C helper lets the kernel take the card's shared memory and counts
    them, once per library, kernel, widths, K and device."""
    with _on(device):
        slots = getattr(lib, f"umnn_integrand_{kernel}_slots")(K, _c_widths(widths),
                                                               len(widths) - 1)
    if slots < 1:
        _raise_on(-slots or 1, lib, f"integrand_{kernel}")
    return slots


def _layer_pointers(ws, bs) -> ctypes.Array:
    """Each layer's weight and bias addresses, ``[w0, b0, w1, b1, ...]``,
    which the pack-4 kernels read in place."""
    ptrs = [t.data_ptr() for w, b in zip(ws, bs) for t in (w, b)]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


@contextlib.contextmanager
def _on(device):
    """The device made current; yields its current stream's handle."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def _packed_params(ws, bs) -> torch.Tensor:
    """One buffer: per layer W^T ``[din, dout]`` row-major, then b (what the
    unpacked, pack-2 and streamed pairs take)."""
    return torch.cat([t.reshape(-1) for w, b in zip(ws, bs) for t in (w.T.contiguous(), b)])


def _raise_on(rc: int, lib, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{kernel} kernel launch failed: {lib.umnn_cuda_error_string(rc).decode()}"
        )


def _at(t: torch.Tensor, offset: int) -> int:
    """The address of ``t``'s float32 element ``offset``."""
    return t.data_ptr() + 4 * offset


def _wide_scratch(lib, chunks, K: int, ptr, n: int, device) -> torch.Tensor:
    """The streamed pair's scratch for its largest (first) chunk."""
    floats = lib.umnn_integrand_wide_scratch_floats(chunks[0][1] - chunks[0][0], K, ptr, n)
    return torch.empty(floats, dtype=torch.float32, device=device)


def _launch_fwd(ws, bs, x, h, nodes, ccw, neg_slope, widths, route) -> torch.Tensor:
    kernel = "fwd" + route
    K, R, e = nodes.numel(), x.numel(), widths[0] - 1
    lib, ptr, n = _build.load_library(), _c_widths(widths), len(widths) - 1
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)  # x is contiguous
    if R == 0:
        return out
    fn = getattr(lib, f"umnn_integrand_{kernel}")
    if route == "_p4":
        slots = _slots(lib, kernel, widths, K, x.device)
        with _on(x.device) as stream:
            rc = fn(x.data_ptr(), h.data_ptr(), _layer_pointers(ws, bs), nodes.data_ptr(),
                    ccw.data_ptr(), out.data_ptr(), R, K, slots, ptr, n, float(neg_slope), stream)
        _raise_on(rc, lib, f"integrand_{kernel}")
        LAUNCHES[f"integrand_{kernel}"] += 1
        return out
    params = _packed_params(ws, bs)
    with _on(x.device) as stream:
        if route == "_wide":
            chunks = _wide_chunks(R, K, widths)
            scratch = _wide_scratch(lib, chunks, K, ptr, n, x.device)
            for a, b in chunks:
                rc = fn(_at(x, a), _at(h, a * e), params.data_ptr(), nodes.data_ptr(),
                        ccw.data_ptr(), _at(out, a), b - a, K, ptr, n, float(neg_slope),
                        scratch.data_ptr(), stream)
                _raise_on(rc, lib, f"integrand_{kernel}")
        else:
            rc = fn(x.data_ptr(), h.data_ptr(), params.data_ptr(), nodes.data_ptr(),
                    ccw.data_ptr(), out.data_ptr(), R, K, ptr, n, float(neg_slope), stream)
            _raise_on(rc, lib, f"integrand_{kernel}")
    LAUNCHES[f"integrand_{kernel}"] += 1
    return out


def _launch_bwd(ws, bs, x, h, nodes, ccw, g, neg_slope, widths, route):
    """``(dws, dbs, dx, dh, S)`` as :func:`fused_cc_integral_bwd_plain`
    gives them; the kernel itself adds ``g S/2`` to dx."""
    kernel = "bwd" + route
    K, R, e = nodes.numel(), x.numel(), widths[0] - 1
    lib, ptr, n = _build.load_library(), _c_widths(widths), len(widths) - 1
    if g.shape != x.shape or g.dtype != torch.float32 or g.device != x.device:
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype} does not match x")
    dev = x.device
    sizes = [t.numel() for w, b in zip(ws, bs) for t in (w, b)]
    n_params = sum(sizes)
    dx = torch.empty(x.shape, dtype=torch.float32, device=dev)  # x is contiguous
    dh = torch.empty(h.shape, dtype=torch.float32, device=dev)
    S = torch.empty(x.shape, dtype=torch.float32, device=dev)
    # dparams: per layer dW in nn.Linear's [dout, din] layout, then db; the
    # staged pairs' reductions write every element, the streamed pair adds
    # into it
    alloc = torch.zeros if R == 0 or route == "_wide" else torch.empty
    dparams = alloc(n_params, dtype=torch.float32, device=dev)
    if R > 0 and route == "_p4":
        slots = _slots(lib, kernel, widths, K, dev)
        # one slice of dW/db partial sums per block the grid may have
        partial = torch.empty(slots * n_params, dtype=torch.float32, device=dev)
        fn = getattr(lib, f"umnn_integrand_{kernel}")
        with _on(dev) as stream:
            rc = fn(x.data_ptr(), h.data_ptr(), _layer_pointers(ws, bs), nodes.data_ptr(),
                    ccw.data_ptr(), g.data_ptr(), dx.data_ptr(), dh.data_ptr(), S.data_ptr(),
                    partial.data_ptr(), dparams.data_ptr(), R, K, slots, ptr, n,
                    float(neg_slope), stream)
        _raise_on(rc, lib, f"integrand_{kernel}")
        LAUNCHES[f"integrand_{kernel}"] += 1
    elif R > 0:
        params = _packed_params(ws, bs)
        fn = getattr(lib, f"umnn_integrand_{kernel}")
        with _on(dev) as stream:
            if route == "_wide":
                # each chunk adds its dW/db to dparams, in chunk order; the
                # dz and dh products read each layer's W in place
                chunks = _wide_chunks(R, K, widths)
                scratch = _wide_scratch(lib, chunks, K, ptr, n, dev)
                weights = (ctypes.c_void_p * len(ws))(*(w.data_ptr() for w in ws))
                for a, b in chunks:
                    rc = fn(_at(x, a), _at(h, a * e), params.data_ptr(), weights,
                            nodes.data_ptr(), ccw.data_ptr(), _at(g, a), _at(dx, a),
                            _at(dh, a * e), _at(S, a), dparams.data_ptr(), b - a, K, ptr, n,
                            float(neg_slope), scratch.data_ptr(), stream)
                    _raise_on(rc, lib, f"integrand_{kernel}")
            else:
                # the unpacked grid: one block per SM; the pack-2 grid: as
                # many blocks as fit on the card at once, at most one per
                # row tile
                grid = getattr(lib, f"umnn_integrand_{kernel}_grid")
                blocks = grid(R, K, ptr, n) if route else grid(R)
                if blocks < 1:
                    _raise_on(-blocks or 1, lib, f"integrand_{kernel}")
                # one slice of dW/db partial sums per block of the grid
                partial = torch.empty(blocks * n_params, dtype=torch.float32, device=dev)
                rc = fn(x.data_ptr(), h.data_ptr(), params.data_ptr(), nodes.data_ptr(),
                        ccw.data_ptr(), g.data_ptr(), dx.data_ptr(), dh.data_ptr(),
                        S.data_ptr(), partial.data_ptr(), dparams.data_ptr(), R, K, blocks,
                        ptr, n, float(neg_slope), stream)
                _raise_on(rc, lib, f"integrand_{kernel}")
        LAUNCHES[f"integrand_{kernel}"] += 1
    parts = dparams.split(sizes)  # views: dW, db of each layer in turn
    dws = [d.view(w.shape) for d, w in zip(parts[::2], ws)]
    return dws, list(parts[1::2]), dx, dh, S
