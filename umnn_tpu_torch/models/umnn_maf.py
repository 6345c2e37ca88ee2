"""UMNN-MAF: one autoregressive monotone flow block and its networks.

PyTorch counterpart of `umnn_tpu/models/umnn_maf.py` (`:64-111,133-185,
188-391`). One block computes

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
CUDA and the plain path on CPU. Gradients reach every parameter on both
routes; the scaling is a buffer and gets none, as JAX's ``stop_gradient``
makes it (`:235-237,267,363`).
On the kernel route, under ``"auto"`` on the card too, an integrand whose
widths a kernel pair refuses goes to the streamed pair; one no kernel
computes (an output other than ELU+1, no hidden layer) raises before any
launch, and only ``"torch"`` runs it on the card.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from umnn_tpu_torch.nn.core import MLP
from umnn_tpu_torch.nn.made import MADE, ConditionalMADE
from umnn_tpu_torch.ops.integrand_kernel import fused_cc_integral
from umnn_tpu_torch.ops.quadrature import cc_tensors, neural_integral

__all__ = ["IntegrandNetwork", "EmbeddingNetwork", "UMNNMAF", "BACKENDS"]

BACKENDS = ("auto", "kernel", "torch")


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
        device: torch.device | str = "cpu",
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


class EmbeddingNetwork(nn.Module):
    """A MADE embedder (a ConditionalMADE where ``cond_in > 0``) paired with
    the integrand networks."""

    def __init__(
        self,
        in_d: int,
        hidden_embedding: Sequence[int],
        hidden_integrand: Sequence[int],
        out_made: int,
        gen: torch.Generator,
        act_func: str = "ELU",
        device: torch.device | str = "cpu",
        cond_in: int = 0,
    ):
        super().__init__()
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
        device: torch.device | str = "cpu",
        cond_in: int = 0,
        pack2: bool | None = None,
        pack4: bool | None = None,
    ):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
        self.input_size = input_size
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
        the plain path: an integrand the kernel cannot take raises there."""
        use = self.backend == "kernel" or (self.backend == "auto" and x.is_cuda)
        if use and self.act_func != "ELU":
            raise ValueError(
                f"the integrand kernel computes ELU+1 outputs; act_func="
                f"{self.act_func!r} needs backend='torch'"
            )
        return use

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
            layers = integrand.layers
            z = fused_cc_integral(
                [l.weight for l in layers],
                [l.bias for l in layers],
                x.contiguous(),
                integrand.fold_embedding(h).contiguous(),
                nodes,
                weights,
                neg_slope=0.01,
                pack2=self.pack2,
                pack4=self.pack4,
            )
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
