"""MonotonicNN: a scalar regressor that increases strictly in its first input.

PyTorch counterpart of `umnn_tpu/models/monotonic.py` (`:28-100`), the
reference's `models/UMNN/MonotonicNN.py`:

    y(x, h) = exp(s(h)) * ∫_0^x f(t, h) dt + o(h)

with the integrand ``f = ELU(MLP([t, h])) + 1 > 0`` (ReLU hidden layers,
:class:`IntegrandNN`) and a free network ``hnet`` of ``h`` whose two
outputs are the offset ``o`` (column 0) and the log-scale ``s`` (column 1).

The integral's ``backend``, as elsewhere in the port (JAX's ``"pallas"``,
``"xla"`` and ``"auto"``): ``"kernel"`` calls
:func:`~umnn_tpu_torch.ops.integrand_kernel.fused_cc_integral` with
``neg_slope=0.0`` (ReLU), which launches the kernel pair JAX's auto would
pick on the card (3-100-100-100-1: the unpacked pair; every layer at most
64 wide: pack-2; at most 32: pack-4) and runs its plain version on the CPU;
``"torch"`` is :func:`~umnn_tpu_torch.ops.quadrature.neural_integral` from
``x0 = 0`` with the Leibniz-rule backward; ``"auto"`` takes the kernel on
CUDA tensors and the plain path on the CPU.

Two cases differ from the JAX package by design:

- no hidden layer: JAX's ``"pallas"`` quietly integrates with
  ``neural_integral`` (`:74-77`); here the kernel route (``"kernel"``, or
  ``"auto"`` on the card) raises ``ValueError`` before any launch, and only
  ``"torch"`` computes it;
- ``in_d = 1`` (no conditioning input): ``h`` has no column. The kernel
  wrapper takes at least one column of ``h``, so the kernel route gives the
  first layer a zero column for a zero column of ``h``: the same function
  and the same gradients, through the same kernels.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from umnn_tpu_torch.models.umnn_maf import BACKENDS
from umnn_tpu_torch.nn.core import MLP, resolve_device
from umnn_tpu_torch.ops.integrand_kernel import fused_cc_integral
from umnn_tpu_torch.ops.quadrature import cc_tensors, neural_integral

__all__ = ["IntegrandNN", "MonotonicNN"]


class IntegrandNN(nn.Module):
    """Positive MLP integrand ``[x, h] -> (0, inf)``: ReLU hidden layers,
    ELU+1 output (`umnn_tpu/models/monotonic.py:28-43`)."""

    def __init__(
        self,
        in_d: int,
        hidden_layers: Sequence[int],
        gen: torch.Generator,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        self.mlp = MLP([in_d, *hidden_layers, 1], gen, "ReLU", "ELUPlus", device)

    @property
    def layers(self) -> nn.ModuleList:
        return self.mlp.layers

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return self.mlp(torch.cat([x, h], dim=-1))


class MonotonicNN(nn.Module):
    """Monotone in ``x``; ``in_d`` counts ``x`` and the conditioning inputs.

    ``forward(x [B, 1], h [B, in_d - 1]) -> [B, 1]``. Weights are drawn from
    a ``torch.Generator`` seeded with ``seed``, the integrand's first. The
    model lives on ``device``: the card unless the caller names another,
    and with no card and no ``device`` the constructor raises.
    """

    def __init__(
        self,
        in_d: int,
        hidden_layers: Sequence[int],
        nb_steps: int = 50,
        backend: str = "auto",
        seed: int = 0,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.in_d, self.hidden_layers = in_d, tuple(hidden_layers)
        self.nb_steps, self.backend = nb_steps, backend
        self.integrand = IntegrandNN(in_d, self.hidden_layers, gen, device)
        # the free net h -> (offset, log-scale) (`MonotonicNN.py:33-42`)
        self.hnet = MLP([in_d - 1, *self.hidden_layers, 2], gen, "ReLU", "Identity", device)

    def _use_kernel(self, x: torch.Tensor) -> bool:
        """Whether the integral goes to the kernel; it never falls back to
        the plain path: an integrand with no hidden layer raises there."""
        use = self.backend == "kernel" or (self.backend == "auto" and x.is_cuda)
        if use and not self.hidden_layers:
            raise ValueError(
                "the integrand kernel needs at least one hidden layer; "
                "an integrand with none needs backend='torch'"
            )
        return use

    def _integral(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """``∫_0^x f(t, h) dt`` on the kernel route; ``x [B]``, ``h [B, e]``."""
        layers = self.integrand.layers
        ws = [l.weight for l in layers]
        if h.shape[-1] == 0:  # in_d = 1: a zero column of h, a zero column of W1
            h = h.new_zeros(*h.shape[:-1], 1)
            ws[0] = torch.cat([ws[0], ws[0].new_zeros(ws[0].shape[0], 1)], dim=1)
        nodes, weights = cc_tensors(self.nb_steps, x.device, x.dtype)
        return fused_cc_integral(
            ws, [l.bias for l in layers], x.contiguous(), h.contiguous(), nodes, weights,
            neg_slope=0.0,  # ReLU hidden layers (`MonotonicNN.py:19-22`)
        )

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        out = self.hnet(h)
        offset, scaling = out[..., 0:1], torch.exp(out[..., 1:2])
        if self._use_kernel(x):
            integral = self._integral(x[..., 0], h)[..., None]
        else:
            integral = neural_integral(
                self.integrand, torch.zeros_like(x), x, h, self.nb_steps
            )
        return scaling * integral + offset
