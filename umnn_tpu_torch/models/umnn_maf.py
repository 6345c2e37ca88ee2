"""UMNN-MAF: one autoregressive monotone flow block and its networks.

PyTorch counterpart of `umnn_tpu/models/umnn_maf.py` (`:50-60,64-130,
133-185,188-409`). One block computes

    z_d = exp(s_d) * ( ∫_0^{x_d} f_d(t, h_d(x_{<d})) dt + z0_d )

where ``h = MADE(x)`` is the autoregressive embedding (its first D-block is
the offset ``z0``), the integrands ``f_d`` share one MLP evaluated on folded
rows, and ``s`` is a frozen per-dimension scaling. The exact log-Jacobian is
``log f_d(x_d, h_d) + s_d``. With ``cond_in > 0`` the embedding is a
ConditionalMADE of ``(x, context)``, and every method takes ``context=``.

The integral's ``backend``: ``"kernel"`` (counterpart of JAX's ``"pallas"``)
calls :func:`~umnn_tpu_torch.ops.integrand_kernel.fused_cc_integral`, which
launches the CUDA kernels on the card (the pair that ``pack2`` and ``pack4``
pick, ``None`` as JAX's auto) and their plain version on the CPU;
``"torch"`` (counterpart of ``"xla"``) is the plain node-megabatch
quadrature with the Leibniz-rule backward; ``"auto"`` takes the kernel on
CUDA and the plain path on CPU. ``solver="CC"`` (the reference's
node-sequential solver, `:318-332`) integrates one node at a time on any
backend, with no kernel. Gradients reach every parameter on both
routes; the scaling is a buffer and gets none, as JAX's ``stop_gradient``
makes it (`:235-237,267,363`).
On the kernel route, under ``"auto"`` on the card too, an integrand whose
widths a kernel pair refuses goes to the streamed pair; one no kernel
computes (an output other than ELU+1, no hidden layer) raises before any
launch, and only ``"torch"`` runs it on the card.

Lipschitz control (`UMNNMAF.py:26-34,289-301`): ``compute_lipschitz``
multiplies power-iteration estimates of the integrand layers' spectral
norms, and ``force_lipschitz`` divides each layer's weight by
``max(sigma / L, 1)`` in place, biases kept.

Inversion (`umnn_tpu/models/umnn_maf.py:411-527`), under
``torch.inference_mode()``: ``invert_newton`` iterates Jacobi-Newton over
every dimension at once, each iteration one forward; ``invert`` is the
reference's gridded bisection, one dimension at a time, whose candidates'
integrals go to :func:`fused_cc_integral` (rows ``[B, C]``, features
``[B, C, e]``) on the kernel route, so both run on the forward kernels on
the card.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from umnn_tpu_torch.nn.core import MLP, resolve_device
from umnn_tpu_torch.nn.made import MADE, ConditionalMADE
from umnn_tpu_torch.ops.integrand_kernel import fused_cc_integral
from umnn_tpu_torch.ops.quadrature import (
    cc_tensors,
    integrate,
    integrate_sequential,
    neural_integral,
)

__all__ = [
    "BACKENDS", "EmbeddingNetwork", "IntegrandNetwork", "SOLVERS", "UMNNMAF",
    "power_iteration_sigma",
]

BACKENDS = ("auto", "kernel", "torch")
SOLVERS = ("CCParallel", "CC")


def power_iteration_sigma(
    w: torch.Tensor,
    init: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    nb_iter: int = 10,
) -> torch.Tensor:
    """Estimate of the spectral norm of ``w`` ``[dout, din]`` by power
    iteration on ``w^T w`` (`umnn_tpu/models/umnn_maf.py:50-60`).

    ``init``: the start vector, ``din`` values; else one drawn standard
    normal from ``generator`` (on the generator's device). The estimate
    never exceeds the norm: it approaches it from below.
    """
    if init is None:
        gen_device = generator.device if generator is not None else w.device
        init = torch.randn(w.shape[1], 1, generator=generator, device=gen_device)
    x = init.reshape(-1, 1).to(device=w.device, dtype=w.dtype)
    for _ in range(nb_iter):
        x = w.T @ (w @ x)
        x = x / torch.linalg.norm(x)
    return torch.sqrt(torch.linalg.norm(w.T @ (w @ x)) / torch.linalg.norm(x))


class IntegrandNetwork(nn.Module):
    """D positive scalar integrands with one shared MLP.

    ``forward``: ``x [..., D], h [..., D*e] -> f [..., D]`` with
    ``f_d = act(MLP([x_d, h[0*D+d], ..., h[(e-1)*D+d]]))``: LeakyReLU(0.01)
    hidden layers, output ELU+1 (``act_func="ELU"``) or another activation.
    """

    def __init__(
        self,
        nnets: int,
        nin: int,
        hidden_sizes: Sequence[int],
        gen: torch.Generator,
        nout: int = 1,
        act_func: str = "ELU",
        device: torch.device | str | None = None,
    ):
        super().__init__()
        self.nnets = nnets
        out_act = "ELUPlus" if act_func == "ELU" else act_func
        self.mlp = MLP([nin, *hidden_sizes, nout], gen, "LeakyReLU", out_act, device)

    @property
    def layers(self) -> nn.ModuleList:
        return self.mlp.layers

    def fold_features(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """``[..., D], [..., D*e] -> [..., D, 1+e]``; ``h[..., k*D+d]`` is the
        k-th feature of dimension d."""
        return torch.cat([x[..., None], self.fold_embedding(h)], dim=-1)

    def fold_embedding(self, h: torch.Tensor) -> torch.Tensor:
        """``[..., D*e] -> [..., D, e]``."""
        D = self.nnets
        return h.reshape(*h.shape[:-1], h.shape[-1] // D, D).transpose(-1, -2)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return self.mlp(self.fold_features(x, h))[..., 0]

    # JAX iterates on its ``w.T``, ``[dout, din]``: nn.Linear's weight is
    # that matrix, so sigma here is the norm of the same matrix, from the
    # same start vector the same estimate.

    @torch.no_grad()
    def compute_lipschitz(
        self, generator: torch.Generator | None = None, inits=None, nb_iter: int = 10
    ) -> torch.Tensor:
        """Product of the layers' estimated spectral norms; ``inits[i]``:
        layer i's start vector, else drawn from ``generator``."""
        L = torch.ones((), device=self.layers[0].weight.device)
        for i, layer in enumerate(self.layers):
            init = inits[i] if inits is not None else None
            L = L * power_iteration_sigma(layer.weight, init, generator, nb_iter)
        return L

    @torch.no_grad()
    def force_lipschitz(
        self, L: float = 1.5, generator: torch.Generator | None = None, inits=None
    ) -> None:
        """Divide each layer's weight by ``max(sigma / L, 1)``, in place;
        biases kept (`umnn_tpu/models/umnn_maf.py:123-130`)."""
        for i, layer in enumerate(self.layers):
            init = inits[i] if inits is not None else None
            sigma = power_iteration_sigma(layer.weight, init, generator, 10)
            layer.weight.div_(torch.clamp(sigma / L, min=1.0))


class EmbeddingNetwork(nn.Module):
    """A MADE embedder (a ConditionalMADE where ``cond_in > 0``) paired with
    the integrand networks, on ``device`` (the card unless the caller names
    another)."""

    def __init__(
        self,
        in_d: int,
        hidden_embedding: Sequence[int],
        hidden_integrand: Sequence[int],
        out_made: int,
        gen: torch.Generator,
        act_func: str = "ELU",
        device: torch.device | str | None = None,
        cond_in: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        self.cond_in = cond_in
        if cond_in > 0:
            self.made = ConditionalMADE(
                in_d, cond_in, hidden_embedding, (in_d + cond_in) * out_made, gen, device
            )
        else:
            self.made = MADE(in_d, hidden_embedding, in_d * out_made, gen, device)
        self.integrand = IntegrandNetwork(
            in_d, 1 + out_made, hidden_integrand, gen, 1, act_func, device
        )

    def embed(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        if self.cond_in > 0:
            if context is None:
                raise ValueError("conditional EmbeddingNetwork requires context")
            return self.made(x, context)
        return self.made(x)


class UMNNMAF(nn.Module):
    """One autoregressive monotone flow block.

    ``pack2`` and ``pack4`` (JAX's ``pallas_pack2`` and ``pallas_pack4``)
    go to :func:`fused_cc_integral` on the kernel route: ``None`` picks the
    kernel pair as JAX's auto does; a bool forces a pair on or off.

    ``solver``: ``"CCParallel"`` integrates every node in one call (the
    kernel route, or the Leibniz megabatch under ``"torch"``); ``"CC"``
    integrates node by node through :func:`integrate_sequential` on every
    backend, and never takes the kernel, as JAX's ``use_pallas`` requires
    ``"CCParallel"`` (`umnn_tpu/models/umnn_maf.py:283`). The block lives on
    ``device``, the card unless the caller names another.
    """

    def __init__(
        self,
        input_size: int,
        gen: torch.Generator,
        embedding_s: int = 20,
        hidden_embedding: Sequence[int] = (50, 50, 50, 50),
        hidden_derivative: Sequence[int] = (50, 50, 50, 50),
        nb_steps: int = 50,
        act_func: str = "ELU",
        backend: str = "auto",
        device: torch.device | str | None = None,
        cond_in: int = 0,
        pack2: bool | None = None,
        pack4: bool | None = None,
        solver: str = "CCParallel",
    ):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
        if solver not in SOLVERS:
            raise ValueError(f"solver {solver!r} is not one of {SOLVERS}")
        device = resolve_device(device)
        self.input_size = input_size
        self.solver = solver
        self.nb_steps = nb_steps
        self.act_func = act_func
        self.backend = backend
        self.pack2, self.pack4 = pack2, pack4
        # EmbeddingNetwork draws the MADE and then the integrand from ``gen``
        self.net = EmbeddingNetwork(
            input_size, hidden_embedding, hidden_derivative, embedding_s, gen,
            act_func, device, cond_in,
        )
        # frozen per-dimension scaling; a buffer, so no gradient reaches it
        self.register_buffer("scaling", torch.zeros(input_size, device=device))

    def embed(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        return self.net.embed(x, context)

    def _use_kernel(self, x: torch.Tensor) -> bool:
        """Whether the integral goes to the kernel; it never falls back to
        the plain path: an integrand the kernel cannot take raises there.
        The sequential solver never takes it."""
        use = self.solver == "CCParallel" and (
            self.backend == "kernel" or (self.backend == "auto" and x.is_cuda)
        )
        if use and self.act_func != "ELU":
            raise ValueError(
                f"the integrand kernel computes ELU+1 outputs; act_func="
                f"{self.act_func!r} needs backend='torch'"
            )
        return use

    def _integral(self, x: torch.Tensor, h_dm: torch.Tensor, nodes, weights) -> torch.Tensor:
        """``∫_0^x f(t, h) dt`` on the kernel route; ``h_dm`` is ``[..., e]``
        per entry of ``x``."""
        layers = self.net.integrand.layers
        return fused_cc_integral(
            [l.weight for l in layers],
            [l.bias for l in layers],
            x.contiguous(),
            h_dm.contiguous(),
            nodes,
            weights,
            neg_slope=0.01,
            pack2=self.pack2,
            pack4=self.pack4,
        )

    def forward_with_embedding(
        self,
        x: torch.Tensor,
        h: torch.Tensor,
        nb_steps: int | None = None,
        nodes: torch.Tensor | None = None,
        weights: torch.Tensor | None = None,
    ) -> torch.Tensor:
        z0 = h[..., : self.input_size]
        if nodes is None or weights is None:
            nodes, weights = cc_tensors(nb_steps or self.nb_steps, x.device, x.dtype)
        integrand = self.net.integrand
        if self._use_kernel(x):
            z = self._integral(x, integrand.fold_embedding(h), nodes, weights)
        elif self.solver == "CC":
            z = integrate_sequential(integrand, torch.zeros_like(x), x, h, nodes, weights)
        else:
            z = neural_integral(
                integrand, torch.zeros_like(x), x, h, nodes=nodes, weights=weights
            )
        return torch.exp(self.scaling) * (z + z0)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None, **quad) -> torch.Tensor:
        return self.forward_with_embedding(x, self.embed(x, context), **quad)

    def _log_jac(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return torch.log(self.net.integrand(x, h) + 1e-10) + self.scaling

    def compute_log_jac(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        """Exact diagonal log-Jacobian: ``log f(x, h) + s``."""
        return self._log_jac(x, self.embed(x, context))

    def compute_log_jac_bis(self, x: torch.Tensor, context: torch.Tensor | None = None, **quad):
        h = self.embed(x, context)
        return self.forward_with_embedding(x, h, **quad), self._log_jac(x, h)

    def compute_ll(self, x: torch.Tensor, context: torch.Tensor | None = None, **quad):
        z, log_jac = self.compute_log_jac_bis(x, context, **quad)
        z = torch.clamp(z, -10.0, 10.0)  # Gaussian-tail guard
        log_prob_gauss = -0.5 * torch.sum(math.log(2 * math.pi) + z**2, dim=-1)
        return log_prob_gauss + torch.sum(log_jac, dim=-1), z

    def compute_bpp(
        self, x: torch.Tensor, alpha: float = 1e-6, context: torch.Tensor | None = None
    ):
        """Bits per pixel for logit-dequantized images."""
        ll, z = self.compute_ll(x, context)
        return bits_per_pixel(ll, x, alpha), ll, z

    def invert_newton(
        self,
        z: torch.Tensor,
        iters: int = 30,
        context: torch.Tensor | None = None,
        x_bound: float = 50.0,
        damping: float = 1.0,
    ) -> torch.Tensor:
        """Parallel Jacobi-Newton inversion, every dimension at once
        (`umnn_tpu/models/umnn_maf.py:411-444`).

        From ``x = 0``, each iteration re-embeds, runs the forward and takes
        ``x <- clip(x - damping (forward(x) - z) / max(J, 1e-6), +-x_bound)``
        with the diagonal Jacobian ``J = exp(s) f(x, h)``: one launch of the
        forward kernel an iteration on the kernel route.
        """
        with torch.inference_mode():
            s = torch.exp(self.scaling)
            x = torch.zeros_like(z)
            for _ in range(iters):
                h = self.embed(x, context)
                zx = self.forward_with_embedding(x, h)
                jac = s * self.net.integrand(x, h)
                step = (zx - z) / torch.clamp(jac, min=1e-6)
                x = torch.clamp(x - damping * step, -x_bound, x_bound)
        return x.clone()  # a normal tensor, usable outside inference mode

    def invert(
        self,
        z: torch.Tensor,
        iters: int = 10,
        context: torch.Tensor | None = None,
        nb_candidates: int = 10,
        x_bound: float = 50.0,
    ) -> torch.Tensor:
        """The reference's gridded bisection, one dimension at a time
        (`umnn_tpu/models/umnn_maf.py:446-527`).

        For dimension ``j``: re-embed the partly inverted ``x`` (``h_j``
        depends only on ``x_{<j}``), then ``iters`` times evaluate
        ``nb_candidates`` abscissae spread over the bracket ``[left,
        right]`` (from ``+-x_bound``), take the candidate whose ``z`` is
        nearest ``z_j`` (the first on ties) and keep the grid cell between
        it and its neighbour on ``z_j``'s side; ``x_j`` is the final
        bracket's midpoint. The bracket shrinks by ``1 / (nb_candidates -
        1)`` a round. The candidates' integrals are one
        :func:`fused_cc_integral` call a round on the kernel route (one
        launch of the block's forward kernel), JAX's ``integrate`` of the
        same integrand on the plain route.
        """
        B, D = z.shape
        C = nb_candidates
        use_kernel = self._use_kernel(z)
        integrand = self.net.integrand

        def integrals(xc, h_c):  # [B, C], [B, C, e] -> [B, C]
            if use_kernel:
                return self._integral(xc, h_c, nodes, weights)
            return integrate(
                lambda t, hh: integrand.mlp(torch.cat([t, hh], dim=-1)),
                torch.zeros_like(xc)[..., None], xc[..., None], h_c, nodes, weights,
            )[..., 0]

        with torch.inference_mode():
            grid = _unit_grid(C, z.dtype, z.device)
            s_all = torch.exp(self.scaling)
            nodes, weights = cc_tensors(self.nb_steps, z.device, z.dtype)
            x_inv = torch.zeros_like(z)
            for j in range(D):
                h_j = integrand.fold_embedding(self.embed(x_inv, context))[:, j, :]  # [B, e]
                offset = h_j[:, :1]  # the first embedding block is z0_j
                z_j = z[:, j]
                h_c = h_j[:, None, :].expand(B, C, h_j.shape[-1]).contiguous()
                left = torch.full((B,), -x_bound, dtype=z.dtype, device=z.device)
                right = torch.full((B,), x_bound, dtype=z.dtype, device=z.device)
                for _ in range(iters):
                    xc = left[:, None] + grid[None, :] * (right - left)[:, None]  # [B, C]
                    z_est = s_all[j] * (offset + integrals(xc, h_c))
                    c_star = torch.argmin(torch.abs(z_est - z_j[:, None]), dim=1, keepdim=True)
                    z_val = z_est.gather(1, c_star)[:, 0]
                    x_mid = xc.gather(1, c_star)[:, 0]
                    x_lo = xc.gather(1, torch.clamp(c_star - 1, 0, C - 1))[:, 0]
                    x_hi = xc.gather(1, torch.clamp(c_star + 1, 0, C - 1))[:, 0]
                    below = z_val < z_j  # the transform increases
                    left = torch.where(below, x_mid, x_lo)
                    right = torch.where(below, x_hi, x_mid)
                x_inv[:, j] = 0.5 * (left + right)
        return x_inv.clone()

    def compute_lipschitz(self, generator=None, inits=None, nb_iter: int = 10) -> torch.Tensor:
        """The integrand's Lipschitz estimate (`:395-398`)."""
        return self.net.integrand.compute_lipschitz(generator, inits, nb_iter)

    def force_lipschitz(self, L: float = 1.5, generator=None, inits=None) -> None:
        """Project the integrand's layers (`:400-409`); MADE and the
        scaling are untouched."""
        self.net.integrand.force_lipschitz(L, generator, inits)


def _unit_grid(n: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` to the bit, as XLA computes it: ``i``
    times the float32 reciprocal of ``n - 1``, then the endpoint 1."""
    if n < 2:
        return torch.zeros(n, dtype=dtype, device=device)
    inner = torch.arange(n - 1, dtype=dtype, device=device) * (1.0 / (n - 1))
    return torch.cat([inner, torch.ones(1, dtype=dtype, device=device)])


def bits_per_pixel(ll: torch.Tensor, x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Bits per pixel of logit-space rows ``x`` with log-likelihood ``ll``."""
    d = x.shape[-1]
    sig = torch.sigmoid(x)
    return (
        -ll / (d * math.log(2))
        - math.log2(1 - 2 * alpha)
        + 8
        + torch.sum(torch.log2(sig) + torch.log2(1 - sig), dim=-1) / d
    )
