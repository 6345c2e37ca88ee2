"""The IWAE importance-sampled log-likelihood.

PyTorch counterpart of `umnn_tpu/models/vae/iwae.py`: per datapoint, S
samples in minibatches, ``ll = logsumexp(-loss) - log S``. ``data_chunk``
datapoints ride each call, each repeated ``minibatch`` times
(datapoint-major rows: row ``j * minibatch + r`` is particle r of
datapoint j); the last chunk runs at its own size. Under a
``torch.distributed`` process group each rank evaluates its contiguous
share of a chunk's rows, on its rows of the noise one rank would draw for
them all, and ``all_gather`` joins the per-row losses; a chunk is padded
with copies of its first datapoint until the group's world size divides
its rows (1 without a group), as JAX pads for its mesh.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from umnn_tpu_torch.models.vae.losses import calculate_loss_array

__all__ = ["calculate_likelihood", "make_iwae_step", "pad_chunk"]


def make_iwae_step(model, apply_kwargs: Optional[dict] = None):
    """``step(x_rep [R, ...], generator, eps=None) -> per-row loss [R]``,
    under ``torch.inference_mode()``: no graph is kept. ``eps`` [R, z], when
    given, is the posterior's noise in place of a draw from ``generator``.
    ``apply_kwargs`` go to the model's forward, e.g. MMAF's evaluation nodes
    and weights."""

    def step(x_rep, generator, eps=None):
        with torch.inference_mode():
            x_mean, z_mu, z_var, ldj, z0, zk = model(x_rep, generator, eps=eps,
                                                     **(apply_kwargs or {}))
            return calculate_loss_array(x_mean, x_rep, z_mu, z_var, z0, zk, ldj,
                                        model.input_type, model.input_size)

    return step


def pad_chunk(xc: np.ndarray, minibatch: int, world: int) -> np.ndarray:
    """``xc`` with copies of its first datapoint appended until ``world``
    divides its rows, ``len * minibatch`` (at most ``world - 1`` copies)."""
    c_pad = len(xc)
    while (c_pad * minibatch) % world:
        c_pad += 1
    if c_pad > len(xc):
        xc = np.concatenate([xc, xc[:1].repeat(c_pad - len(xc), axis=0)])
    return xc


def _group_world() -> tuple[int, int, object]:
    """This rank, the world size and the default group where
    ``torch.distributed`` is up; else 0, 1 and None."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1, None
    group = dist.group.WORLD
    return dist.get_rank(group), dist.get_world_size(group), group


def calculate_likelihood(
    model,
    x_data: np.ndarray,
    generator: torch.Generator,
    n_samples: int = 5000,
    minibatch: int = 500,
    verbose: bool = False,
    data_chunk: int | None = None,
    apply_kwargs: Optional[dict] = None,
) -> tuple[float, np.ndarray]:
    """Mean IWAE log-likelihood over ``x_data`` (nats a datapoint) and each
    datapoint's. Where ``torch.distributed`` is up, the default group's
    ranks share the rows; every rank must call with the same data and a
    ``generator`` in the same state, and gets one rank's result."""
    n_data = x_data.shape[0]
    if data_chunk is None:
        data_chunk = max(4096 // minibatch, 1)
    data_chunk = min(data_chunk, n_data)
    rank, world, group = _group_world()
    step = make_iwae_step(model, apply_kwargs)
    n_mb = max(n_samples // minibatch, 1)
    device = model.device
    lls = np.zeros(n_data)
    for i0 in range(0, n_data, data_chunk):
        xc = np.asarray(x_data[i0 : i0 + data_chunk])
        c = xc.shape[0]
        xc = pad_chunk(xc, minibatch, world)
        c_pad = xc.shape[0]
        x_rep = torch.as_tensor(np.repeat(xc, minibatch, axis=0), device=device)
        share = x_rep.shape[0] // world
        rows = slice(rank * share, (rank + 1) * share)
        x_local = x_rep[rows]
        parts = []
        for _ in range(n_mb):
            if group is None:
                loss = step(x_local, generator)
            else:
                # the noise one rank draws for the chunk's real rows, every
                # row its own; none for the padding, whose losses are dropped
                eps = torch.randn((c * minibatch, model.z_size), generator=generator,
                                  device=device)
                pad = eps.new_zeros((x_rep.shape[0] - eps.shape[0], eps.shape[1]))
                loss = step(x_local, generator, torch.cat([eps, pad])[rows])
                gathered = [torch.empty_like(loss) for _ in range(world)]
                dist.all_gather(gathered, loss, group=group)
                loss = torch.cat(gathered)
            parts.append(loss.reshape(c_pad, minibatch))
        a = -torch.cat(parts, dim=1)  # [C_pad, S]
        ll_chunk = torch.logsumexp(a, dim=1) - math.log(a.shape[1])
        lls[i0 : i0 + c] = ll_chunk.cpu().numpy()[:c]
        if verbose:
            print(f"iwae {i0 + c}/{n_data}: {lls[: i0 + c].mean():.2f}")
    return float(lls.mean()), lls
