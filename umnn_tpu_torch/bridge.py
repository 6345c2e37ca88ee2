"""Carries weights between the JAX package's layout and the port's.

The JAX package keeps a flow's parameters as a list over blocks of
``{"net": {"made": {"layers": [{"w", "b"}, ...]}, "integrand": {"layers":
[...]}}, "scaling": [D]}`` with Linear weights ``[din, dout]``; the port
keeps ``nn.Linear`` weights ``[dout, din]``. A conditional flow's
ConditionalMADE has the same ``{"layers": [...]}`` tree, its first layer
``nin + cond_in`` wide, so it crosses the same way. A MonotonicNN's tree is
``{"integrand": {"layers": [...]}, "hnet": [...]}``. Leaves cross as numpy
arrays, so this module needs neither package's random draws to match.
"""

from __future__ import annotations

import numpy as np
import torch

from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.models.monotonic import MonotonicNN

__all__ = [
    "flow_params_to_numpy",
    "load_jax_flow_params",
    "load_jax_monotonic_params",
    "monotonic_params_to_numpy",
]


def _block_parts(block):
    return {"made": block.net.made.layers, "integrand": block.net.integrand.layers}


@torch.no_grad()
def _load_layers(name: str, layers, src: list) -> None:
    """Copy JAX-layout ``[{"w": [din, dout], "b": [dout]}, ...]`` into
    ``nn.Linear`` layers, in place."""
    if len(src) != len(layers):
        raise ValueError(f"{name}: {len(src)} layers for {len(layers)}")
    for layer, lp in zip(layers, src):
        w = torch.tensor(np.asarray(lp["w"], np.float32).T)
        b = torch.tensor(np.asarray(lp["b"], np.float32))
        if w.shape != layer.weight.shape or b.shape != layer.bias.shape:
            raise ValueError(f"{name}: weight {tuple(w.shape)} for {tuple(layer.weight.shape)}")
        layer.weight.copy_(w)
        layer.bias.copy_(b)


def _layers_to_numpy(layers) -> list:
    return [
        {"w": layer.weight.detach().cpu().numpy().T.copy(),
         "b": layer.bias.detach().cpu().numpy().copy()}
        for layer in layers
    ]


@torch.no_grad()
def load_jax_flow_params(flow: UMNNMAFFlow, params: list) -> UMNNMAFFlow:
    """Copy JAX-layout flow parameters (numpy leaves) into ``flow``, in place."""
    if len(params) != len(flow.blocks):
        raise ValueError(f"{len(params)} parameter blocks for {len(flow.blocks)} flow blocks")
    for block, p in zip(flow.blocks, params):
        for name, layers in _block_parts(block).items():
            _load_layers(name, layers, p["net"][name]["layers"])
        block.scaling.copy_(torch.tensor(np.asarray(p["scaling"], np.float32)))
    return flow


def flow_params_to_numpy(flow: UMNNMAFFlow) -> list:
    """The port's flow parameters in the JAX layout, as numpy arrays."""
    return [
        {"net": {name: {"layers": _layers_to_numpy(layers)}
                 for name, layers in _block_parts(block).items()},
         "scaling": block.scaling.detach().cpu().numpy().copy()}
        for block in flow.blocks
    ]


def load_jax_monotonic_params(model: MonotonicNN, params: dict) -> MonotonicNN:
    """Copy JAX-layout MonotonicNN parameters (numpy leaves) into ``model``,
    in place."""
    _load_layers("integrand", model.integrand.layers, params["integrand"]["layers"])
    _load_layers("hnet", model.hnet.layers, params["hnet"])
    return model


def monotonic_params_to_numpy(model: MonotonicNN) -> dict:
    """The port's MonotonicNN parameters in the JAX layout, as numpy arrays."""
    return {"integrand": {"layers": _layers_to_numpy(model.integrand.layers)},
            "hnet": _layers_to_numpy(model.hnet.layers)}
