"""Clenshaw-Curtis quadrature engine.

PyTorch counterpart of `umnn_tpu/ops/quadrature.py`: the node/weight rule
(`:62-127`), the plain node-megabatch quadrature of the reference's
"CCParallel" solver (`integrate`, `:154-175`), the node-sequential
quadrature of its "CC" solver (`integrate_sequential`, `:183-215`), the
gradient oracle `integrate_autodiff` (`:218-248`) and
:func:`neural_integral` with the memory-efficient Leibniz-rule backward
(`:251-331`), which saves only its inputs and recomputes the node megabatch
in the backward.

With nodes ``t_i = cos(i*pi/N)`` (from +1 down to -1) and CC weights ``w_i``:

    I(x0, xT) = (xT - x0)/2 * sum_i w_i f(x0 + (xT - x0)(t_i + 1)/2, h)
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = [
    "cc_quadrature",
    "cc_tensors",
    "integrate",
    "integrate_autodiff",
    "integrate_sequential",
    "neural_integral",
    "padded_cc_quadrature",
]

# f(x, h) -> values, on the last axis; leading batch axes broadcast.
Integrand = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_cc_cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}


def cc_quadrature(nb_steps: int) -> tuple[np.ndarray, np.ndarray]:
    """Nodes and weights of (N+1)-point Clenshaw-Curtis quadrature on [-1, 1].

    Nodes are the Chebyshev extrema ``t_i = cos(i*pi/N)``, ordered +1 to -1.
    Weights come from the even Chebyshev moments ``2/(1-k^2)``; both the node
    sum and the moment sum are double-primed, so the k=N moment is halved
    too, which makes the rule exact for polynomials of degree <= N.

    Returns float64 numpy arrays (cast at use sites); cached per step count.
    """
    if nb_steps < 1:
        raise ValueError(f"nb_steps must be >= 1, got {nb_steps}")
    if nb_steps in _cc_cache:
        return _cc_cache[nb_steps]
    n = nb_steps
    i = np.arange(n + 1)
    nodes = np.cos(i * np.pi / n)
    k = i.astype(np.float64)
    with np.errstate(divide="ignore"):
        moments = np.where(i % 2 == 0, 2.0 / (1.0 - k**2), 0.0)
    moments[0] = 1.0  # half of 2/(1-0^2)
    if n % 2 == 0:
        moments[-1] *= 0.5
    cosmat = np.cos(np.outer(i, i) * np.pi / n) * (2.0 / n)
    weights = cosmat @ moments
    weights[0] *= 0.5
    weights[-1] *= 0.5
    _cc_cache[nb_steps] = (nodes, weights)
    return nodes, weights


def cc_tensors(
    nb_steps: int, device: torch.device | str, dtype=torch.float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`cc_quadrature` as tensors on ``device``."""
    nodes, weights = cc_quadrature(nb_steps)
    return (
        torch.as_tensor(nodes, dtype=dtype, device=device),
        torch.as_tensor(weights, dtype=dtype, device=device),
    )


def padded_cc_quadrature(
    nb_steps: int, max_steps: int, device: torch.device | str, dtype=torch.float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """CC nodes and weights padded to a fixed length ``max_steps + 1``.

    Padding nodes repeat the last abscissa (t = -1) and carry weight 0, so
    one shape serves any step count (randomized-steps training).
    """
    pad = max_steps - nb_steps
    if pad < 0:
        raise ValueError(f"max_steps {max_steps} < nb_steps {nb_steps}")
    nodes, weights = cc_quadrature(nb_steps)
    nodes = np.concatenate([nodes, np.full(pad, nodes[-1])])
    weights = np.concatenate([weights, np.zeros(pad)])
    return (
        torch.as_tensor(nodes, dtype=dtype, device=device),
        torch.as_tensor(weights, dtype=dtype, device=device),
    )


def _node_positions(x0: torch.Tensor, xT: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
    """Nodes on [x0, xT]: ``[..., K, D]`` from ``[..., D]``, xT down to x0."""
    half = (xT - x0) * 0.5
    return x0[..., None, :] + half[..., None, :] * (nodes[:, None] + 1.0)


def _eval_nodes(integrand, X, h, inv_f):
    K = X.shape[-2]
    f = integrand(X, h[..., None, :].expand(*h.shape[:-1], K, h.shape[-1]))
    return 1.0 / f if inv_f else f


def integrate(
    integrand: Integrand,
    x0: torch.Tensor,
    xT: torch.Tensor,
    h: torch.Tensor,
    nodes: torch.Tensor,
    weights: torch.Tensor,
    inv_f: bool = False,
) -> torch.Tensor:
    """Plain Clenshaw-Curtis quadrature over every node in one megabatch.

    ``x0, xT: [..., D]``, ``h: [..., E]`` -> integral ``[..., D]``. The node
    axis is a leading batch axis of one integrand call, shape ``[..., K, D]``.
    """
    f = _eval_nodes(integrand, _node_positions(x0, xT, nodes), h, inv_f)
    return torch.einsum("...kd,k->...d", f, weights) * (xT - x0) * 0.5


def integrate_sequential(
    integrand: Integrand,
    x0: torch.Tensor,
    xT: torch.Tensor,
    h: torch.Tensor,
    nodes: torch.Tensor,
    weights: torch.Tensor,
    inv_f: bool = False,
) -> torch.Tensor:
    """Node-sequential Clenshaw-Curtis quadrature (the reference's ``"CC"``
    solver, `NeuralIntegral.py:37-66`).

    One integrand call per node on ``[..., D]`` rows, ``w_i f_i`` summed in
    node order: without a graph (under ``torch.no_grad`` or
    ``torch.inference_mode``) the activations of one node at a time are
    alive, O(batch) memory against :func:`integrate`'s O(batch x K), at K
    calls in place of one. With a graph, autograd keeps every node's.
    """
    half = (xT - x0) * 0.5
    acc = torch.zeros(torch.broadcast_shapes(x0.shape, xT.shape), dtype=xT.dtype,
                      device=xT.device)
    for t, w in zip(nodes, weights):
        f = integrand(x0 + half * (t + 1.0), h)
        acc = acc + w * (1.0 / f if inv_f else f)
    return acc * half


def integrate_autodiff(
    integrand: Integrand,
    x0: torch.Tensor,
    xT: torch.Tensor,
    h: torch.Tensor,
    nb_steps: int,
    inv_f: bool = False,
    dtype=torch.float32,
) -> torch.Tensor:
    """:func:`integrate` at ``nb_steps``, differentiated by autograd through
    the node sum: the gradient oracle of the tests."""
    nodes, weights = cc_tensors(nb_steps, xT.device, dtype)
    return integrate(integrand, x0, xT, h, nodes, weights, inv_f)


class _NeuralIntegral(torch.autograd.Function):
    """:func:`integrate` with the Leibniz-rule backward of `_ni_fwd`/`_ni_bwd`.

    The integrand's parameters come in as inputs (``params``) so that their
    gradients come out; the forward runs without a graph and saves only the
    inputs. The backward gives the endpoints ``+-g f(x)`` (``1/f`` under
    ``inv_f``) and, for the parameters and ``h``, one VJP through the node
    megabatch with per-node cotangent ``g (xT-x0)/2 w_i``, the node
    positions held constant.
    """

    @staticmethod
    def forward(ctx, integrand, inv_f, x0, xT, h, nodes, weights, *params):
        ctx.integrand, ctx.inv_f = integrand, inv_f
        ctx.save_for_backward(x0, xT, h, nodes, weights, *params)
        return integrate(integrand, x0, xT, h, nodes, weights, inv_f)

    @staticmethod
    def backward(ctx, g):
        x0, xT, h, nodes, weights, *params = ctx.saved_tensors
        integrand, inv_f = ctx.integrand, ctx.inv_f
        need = ctx.needs_input_grad

        def f_ends(x):
            f = integrand(x, h)
            return 1.0 / f if inv_f else f

        with torch.no_grad():
            dx0 = -f_ends(x0) * g if need[2] else None
            dxT = f_ends(xT) * g if need[3] else None
        wrt = [p for p, n in zip(params, need[7:]) if n]
        dh, dparams = None, [None] * len(params)
        if need[4] or wrt:
            with torch.enable_grad():
                hh = h.detach().requires_grad_(need[4])
                X = _node_positions(x0, xT, nodes).detach()
                f = _eval_nodes(integrand, X, hh, inv_f)
                ct = (g * (xT - x0) * 0.5)[..., None, :] * weights[:, None]
                inputs = ([hh] if need[4] else []) + wrt
                grads = list(torch.autograd.grad(f, inputs, ct, allow_unused=True))
            if need[4]:
                dh = grads.pop(0)
            it = iter(grads)
            dparams = [next(it) if n else None for n in need[7:]]
        return (None, None, dx0, dxT, dh, None, None, *dparams)


def neural_integral(
    integrand: Integrand,
    x0: torch.Tensor,
    xT: torch.Tensor,
    h: torch.Tensor,
    nb_steps: int | None = None,
    *,
    nodes: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    inv_f: bool = False,
) -> torch.Tensor:
    """``∫_{x0}^{xT} f(t, h) dt`` with the Leibniz-rule backward; pass
    ``nb_steps`` or explicit nodes/weights. A module's parameters get
    gradients; a plain function's closure does not."""
    if nodes is None or weights is None:
        if nb_steps is None:
            raise ValueError("pass nb_steps or explicit nodes/weights")
        nodes, weights = cc_tensors(nb_steps, xT.device, xT.dtype)
    params = tuple(integrand.parameters()) if isinstance(integrand, torch.nn.Module) else ()
    return _NeuralIntegral.apply(integrand, inv_f, x0, xT, h, nodes, weights, *params)
