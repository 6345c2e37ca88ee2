"""Layers shared by the port's models.

PyTorch counterpart of `umnn_tpu/nn/core.py:23-86`: the ``torch.nn.Linear``
default init drawn from an explicit ``torch.Generator``, the activation
table, and a plain MLP. Weights are ``nn.Linear``'s ``[dout, din]``; the JAX
package keeps ``[din, dout]`` (see :mod:`umnn_tpu_torch.bridge`).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "ACTIVATIONS",
    "MLP",
    "elu_plus",
    "resolve_device",
    "torch_linear_init",
]


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With no CUDA device and no explicit request this raises: the port never
    carries on quietly on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def torch_linear_init(
    gen: torch.Generator, din: int, dout: int, device: torch.device | str | None = None
) -> nn.Linear:
    """``nn.Linear(din, dout)`` with its default init drawn from ``gen``.

    W and b ~ U(-1/sqrt(din), 1/sqrt(din)), as torch's kaiming-uniform with
    a=sqrt(5). ``gen`` lives on the CPU; the layer is moved to ``device``
    (:func:`resolve_device`: the card unless the caller names another).
    """
    device = resolve_device(device)
    layer = nn.Linear(din, dout, device="meta")
    bound = 1.0 / math.sqrt(din) if din > 0 else 0.0
    w = torch.empty(dout, din).uniform_(-bound, bound, generator=gen)
    b = torch.empty(dout).uniform_(-bound, bound, generator=gen)
    layer.weight = nn.Parameter(w.to(device))
    layer.bias = nn.Parameter(b.to(device))
    return layer


def elu_plus(x: torch.Tensor) -> torch.Tensor:
    """ELU(x) + 1 > 0: the output activation of every integrand network."""
    return F.elu(x) + 1.0


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "ReLU": F.relu,
    "LeakyReLU": lambda x: F.leaky_relu(x, 0.01),
    "ELU": F.elu,
    "ELUPlus": elu_plus,
    "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh,
    "Softplus": F.softplus,
    "Identity": lambda x: x,
}


class MLP(nn.Module):
    """Layer widths ``sizes = [din, h1, ..., dout]``; ``hidden_act`` between
    layers, ``out_act`` after the last. On ``device``, the card unless the
    caller names another."""

    def __init__(
        self,
        sizes: Sequence[int],
        gen: torch.Generator,
        hidden_act: str = "LeakyReLU",
        out_act: str = "Identity",
        device: torch.device | str | None = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.layers = nn.ModuleList(
            torch_linear_init(gen, d0, d1, device) for d0, d1 in zip(sizes[:-1], sizes[1:])
        )
        self.hidden_act = ACTIVATIONS[hidden_act]
        self.out_act = ACTIVATIONS[out_act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = self.hidden_act(layer(x))
        return self.out_act(self.layers[-1](x))
