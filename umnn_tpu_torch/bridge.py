"""Carries weights between the JAX package's layout and the port's.

The JAX package keeps a flow's parameters as a list over blocks of
``{"net": {"made": {"layers": [{"w", "b"}, ...]}, "integrand": {"layers":
[...]}}, "scaling": [D]}`` with Linear weights ``[din, dout]``; the port
keeps ``nn.Linear`` weights ``[dout, din]``. A conditional flow's
ConditionalMADE has the same ``{"layers": [...]}`` tree, its first layer
``nin + cond_in`` wide, so it crosses the same way. A MonotonicNN's tree is
``{"integrand": {"layers": [...]}, "hnet": [...]}``. A VAE's tree is a
dict with ``q_z_nn`` and ``p_x_nn`` (lists of gated layers ``{"h": {"w",
"b"}, "g": {...}}``), ``q_z_mean``, ``q_z_var``, ``p_x_mean`` (a list of
convolutions) and, by family, ``amor_*``, ``h_context`` and ``flow`` (IAF:
``{"flows": [{"z_feat", "zh_feats": [...], "mean", "std"}, ...]}``, masked
linears ``[din, dout]``; MMAF: a flow's list of blocks). Convolution
weights are ``(out, in, kh, kw)`` in both packages; a transposed
convolution's JAX ``(out, in, kh, kw)`` is the port's ``(in, out, kh, kw)``
with the first two axes swapped and no spatial flip. Leaves cross as numpy
arrays, so this module needs neither package's random draws to match.
"""

from __future__ import annotations

import numpy as np
import torch

from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.models.monotonic import MonotonicNN
from umnn_tpu_torch.models.vae.flows import IAF, MMAF

__all__ = [
    "flow_params_to_numpy",
    "load_jax_flow_params",
    "load_jax_monotonic_params",
    "load_jax_vae_params",
    "monotonic_params_to_numpy",
    "vae_params_to_numpy",
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


# how a layer's weight crosses: "linear" transposes [din, dout] to
# [dout, din], "conv" crosses as it is, "conv_t" swaps its first two axes
_TO_PORT = {
    "linear": lambda w: w.T,
    "conv": lambda w: w,
    "conv_t": lambda w: np.swapaxes(w, 0, 1),
}


def _vae_layers(model) -> dict:
    """The model's tree of ``(layer, kind)`` leaves, the MMAF flow as itself."""
    def gated(layers, kind):
        return [{"h": (l.h, kind), "g": (l.g, kind)} for l in layers]

    tree = {
        "q_z_nn": gated(model.q_z_nn, "conv"),
        "q_z_mean": (model.q_z_mean, "linear"),
        "q_z_var": (model.q_z_var, "linear"),
        "p_x_nn": gated(model.p_x_nn, "conv_t"),
        "p_x_mean": [(l, "conv") for l in model.p_x_mean],
    }
    for name, child in model.named_children():
        if name.startswith("amor_") or name == "h_context":
            tree[name] = (child, "linear")
    flow = getattr(model, "flow", None)
    if isinstance(flow, IAF):
        tree["flow"] = {"flows": [
            {"z_feat": (s.z_feat, "linear"), "zh_feats": [(l, "linear") for l in s.zh_feats],
             "mean": (s.mean, "linear"), "std": (s.std, "linear")}
            for s in flow.flows]}
    elif isinstance(flow, MMAF):
        tree["flow"] = flow.flow
    return tree


@torch.no_grad()
def _load_tree(name: str, tree, src) -> None:
    if isinstance(tree, UMNNMAFFlow):
        load_jax_flow_params(tree, src)
    elif isinstance(tree, dict):
        if set(tree) != set(src):
            raise ValueError(f"{name}: keys {sorted(src)} for {sorted(tree)}")
        for k in tree:
            _load_tree(f"{name}.{k}", tree[k], src[k])
    elif isinstance(tree, list):
        if len(tree) != len(src):
            raise ValueError(f"{name}: {len(src)} entries for {len(tree)}")
        for i, (t, p) in enumerate(zip(tree, src)):
            _load_tree(f"{name}[{i}]", t, p)
    else:
        layer, kind = tree
        w = torch.tensor(np.ascontiguousarray(_TO_PORT[kind](np.asarray(src["w"], np.float32))))
        b = torch.tensor(np.asarray(src["b"], np.float32))
        if w.shape != layer.weight.shape or b.shape != layer.bias.shape:
            raise ValueError(f"{name}: weight {tuple(w.shape)} for {tuple(layer.weight.shape)}")
        layer.weight.copy_(w)
        layer.bias.copy_(b)


def _tree_to_numpy(tree):
    if isinstance(tree, UMNNMAFFlow):
        return flow_params_to_numpy(tree)
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to_numpy(v) for v in tree]
    layer, kind = tree
    w = layer.weight.detach().cpu().numpy()
    # each crossing is its own inverse
    return {"w": np.ascontiguousarray(_TO_PORT[kind](w)), "b": layer.bias.detach().cpu().numpy().copy()}


def load_jax_vae_params(model, params: dict):
    """Copy JAX-layout VAE parameters (numpy leaves) into ``model``, any
    family, in place."""
    _load_tree("vae", _vae_layers(model), params)
    return model


def vae_params_to_numpy(model) -> dict:
    """The port's VAE parameters in the JAX layout, as numpy arrays."""
    return _tree_to_numpy(_vae_layers(model))
