"""Optimizer, train step and the host-side helpers of a training loop.

PyTorch counterpart of `umnn_tpu/training/loops.py`: ``make_optimizer``
(`:83-108`), the train step with its non-finite guard (`:111-191`),
``finite_mean`` (`:194-207`), the gradient-accumulation step
(`:209-256`), the evaluation step (`:259-266`), ``ReduceLROnPlateau``
(`:270-307`) and ``batch_iter`` (`:310-332`); the step's ``post_update``
(`:128`, `:174-175`) carries the Lipschitz projection, and its
``has_aux`` returns the loss function's auxiliary values (`:127`). Under a
``torch.distributed`` process group the step is data-parallel, as JAX's
single SPMD step over a mesh is: each rank's gradients are all-reduced and
divided by the world size before the clip and the guard. Not ported, by
decision: the retry of transient compile failures (a TPU workaround) and
the mesh shardings.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "Optimizer",
    "ReduceLROnPlateau",
    "batch_iter",
    "finite_mean",
    "make_accum_train_step",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
]


class Optimizer:
    """Value clip of the gradient, then torch's Adam or Adamax.

    The order is JAX's: ``optax.clip``, then ``add_decayed_weights`` (L2
    decay added to the gradient, which ``torch.optim.Adam(weight_decay=)``
    does), then the Adam scaling and ``-lr``. As in JAX, ``"adamax"`` takes
    eps 1e-7 and no weight decay.
    """

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        name: str = "adam",
        lr: float = 1e-3,
        weight_decay: float = 0.0,
        grad_clip: Optional[float] = 1.0,
    ):
        self.params = [p for p in params if p.requires_grad]
        self.grad_clip = grad_clip
        if name == "adam":
            self.inner = torch.optim.Adam(self.params, lr=lr, weight_decay=weight_decay)
        elif name == "adamax":
            self.inner = torch.optim.Adamax(self.params, lr=lr, eps=1e-7)
        else:
            raise ValueError(f"unknown optimizer {name}")

    @property
    def lr(self) -> float:
        return self.inner.param_groups[0]["lr"]

    @lr.setter
    def lr(self, value: float) -> None:
        for group in self.inner.param_groups:
            group["lr"] = value

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        """The inner optimizer's state: Adam's moments and step counts, and
        the learning rate (JAX keeps it in the injected hyperparameters)."""
        return self.inner.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state)

    def reset(self, lr: float) -> None:
        """Fresh moments and step counts at learning rate ``lr``: JAX's
        ``optimizer.init`` followed by ``set_learning_rate``."""
        self.inner.state.clear()
        self.lr = lr

    def step(self) -> None:
        """Clip the gradients in place and update the parameters."""
        if self.grad_clip is not None:
            torch.nn.utils.clip_grad_value_(self.params, self.grad_clip)
        self.inner.step()


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    name: str = "adam",
    lr: float = 1e-3,
    weight_decay: float = 0.0,
    grad_clip: Optional[float] = 1.0,
) -> Optimizer:
    """:class:`Optimizer` over ``params``, with JAX's argument order after them."""
    return Optimizer(params, name, lr, weight_decay, grad_clip)


def _grads_finite(loss: torch.Tensor, params: Iterable[torch.Tensor]) -> torch.Tensor:
    """One boolean tensor: the loss and every gradient are finite."""
    flags = [torch.isfinite(loss).all()]
    flags += [torch.isfinite(p.grad).all() for p in params if p.grad is not None]
    return torch.stack(flags).all()


def _detach(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_detach(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def _all_reduce_mean(loss: torch.Tensor, params: list, group) -> torch.Tensor:
    """Each gradient and the loss replaced by their means over ``group``'s
    ranks, in one all-reduce. A parameter without a gradient keeps none, as
    the optimizer skips it on one process; every rank runs the same graph,
    so every rank has the same set."""
    world = dist.get_world_size(group)
    params = [p for p in params if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss.detach().reshape(1)])
    dist.all_reduce(flat, group=group)
    flat.div_(world)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[offset : offset + n].view_as(p.grad))
        offset += n
    return flat[-1]


def make_train_step(
    loss_fn: Callable[..., torch.Tensor],
    optimizer: Optimizer,
    post_update: Optional[Callable[..., None]] = None,
    has_aux: bool = False,
    process_group=None,
) -> Callable[..., torch.Tensor]:
    """``step(batch, *extras) -> loss``: ``loss_fn(batch, *extras)``,
    backward, clip, update. With ``has_aux``, ``loss_fn`` returns ``(loss,
    aux)`` and the step ``(loss, aux)``, ``aux`` detached.

    ``process_group`` (a ``torch.distributed`` group, e.g.
    ``torch.distributed.group.WORLD``): the gradients and the loss are
    all-reduced and divided by the world size right after the backward, so
    every rank clips the global gradient, takes the same branch of the
    guard and returns the mean loss. Each rank's ``loss_fn`` is the mean
    over its own rows, an equal share of the global batch.

    Non-finite guard: when the loss or any gradient is not finite, the
    update is skipped and the parameters, Adam's moments and its step count
    stay as they were (JAX selects the old state with ``jnp.where``). The
    check costs one read of a boolean by the host per step.

    ``post_update(*extras)`` runs after the guarded update on every step, a
    skipped one too, as JAX's runs inside its compiled step: e.g. the
    Lipschitz projection the reference applies after every ``opt.step()``
    (`UCIExperiments.py:145-147`). It changes the parameters in place.
    """

    def step(batch, *extras):
        optimizer.zero_grad()
        out = loss_fn(batch, *extras)
        loss, aux = out if has_aux else (out, None)
        loss.backward()
        loss = loss.detach()
        if process_group is not None:
            loss = _all_reduce_mean(loss, optimizer.params, process_group)
        if bool(_grads_finite(loss, optimizer.params)):
            optimizer.step()
        if post_update is not None:
            post_update(*extras)
        return (loss, _detach(aux)) if has_aux else loss

    return step


def make_accum_train_step(
    loss_fn: Callable[..., torch.Tensor],
    optimizer: Optimizer,
    accum_steps: int,
) -> Callable[..., torch.Tensor]:
    """``step(*batch) -> loss``: each tensor of ``batch`` split on its
    leading axis into ``accum_steps`` equal microbatches, one backward of
    ``loss_fn(*microbatch)`` each, the summed gradients divided by
    ``accum_steps``, then one :meth:`Optimizer.step` (clip, L2 decay, Adam).

    The reference's ``max_forward`` sub-batching
    (`MNISTExperiment.py:46,160-165`): the activations of one microbatch
    at a time, the same mean-of-means loss, which it returns. As JAX's, it
    has no non-finite guard. A batch whose leading axis ``accum_steps``
    does not divide raises ``ValueError``.
    """

    def step(*batch) -> torch.Tensor:
        n = batch[0].shape[0]
        if n % accum_steps or any(b.shape[0] != n for b in batch):
            raise ValueError(
                f"a batch of {[b.shape[0] for b in batch]} rows does not split into "
                f"{accum_steps} equal microbatches"
            )
        optimizer.zero_grad()
        losses = []
        for micro in zip(*(b.chunk(accum_steps) for b in batch)):
            loss = loss_fn(*micro)
            loss.backward()  # gradients add up in .grad
            losses.append(loss.detach())
        for p in optimizer.params:
            if p.grad is not None:
                p.grad.div_(accum_steps)
        optimizer.step()
        return torch.stack(losses).mean()

    return step


def make_eval_step(loss_fn: Callable[..., torch.Tensor]) -> Callable[..., torch.Tensor]:
    """``loss_fn`` under ``torch.inference_mode()``: no graph, no gradient."""

    def step(*args) -> torch.Tensor:
        with torch.inference_mode():
            return loss_fn(*args)

    return step


def finite_mean(losses) -> tuple[float, int]:
    """Mean of the finite entries of per-batch losses, and how many were not.

    A batch whose loss was not finite was skipped by the step's guard, so
    the epoch metric leaves it out. The mean is ``inf`` if no loss is finite.
    """
    arr = torch.stack([torch.as_tensor(l).detach().cpu() for l in losses]).numpy()
    finite = np.isfinite(arr)
    mean = float(arr[finite].mean()) if finite.any() else float("inf")
    return mean, int((~finite).sum())


@dataclasses.dataclass
class ReduceLROnPlateau:
    """torch's ReduceLROnPlateau as the reference configures it: mode
    'min', relative threshold 1e-2, the rate cut by ``factor`` once more
    than ``patience`` epochs in a row did not improve, cuts below ``eps``
    skipped."""

    factor: float = 0.5
    patience: int = 5
    threshold: float = 1e-2
    min_lr: float = 0.0
    eps: float = 1e-8
    best: float = float("inf")
    bad_epochs: int = 0

    def _is_better(self, metric: float) -> bool:
        return metric < self.best * (1.0 - self.threshold)

    def update(self, metric: float, lr: float) -> float:
        if self._is_better(metric):
            self.best = metric
            self.bad_epochs = 0
            return lr
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.bad_epochs = 0
            new_lr = max(lr * self.factor, self.min_lr)
            if lr - new_lr > self.eps:
                return new_lr
        return lr


def batch_iter(
    x: np.ndarray,
    batch_size: int,
    rng: np.random.RandomState,
    shuffle: bool = True,
    with_counts: bool = False,
) -> Iterator:
    """Host-side minibatches; the last is filled up by wrapping round to the
    start, so every batch has one shape. With ``with_counts`` it yields
    ``(batch, n_valid)``, so that an evaluation can skip the repeated rows."""
    n = x.shape[0]
    idx = rng.permutation(n) if shuffle else np.arange(n)
    for i in range(0, n, batch_size):
        sel = idx[i : i + batch_size]
        n_valid = len(sel)
        if n_valid < batch_size:
            sel = np.concatenate([sel, idx[: batch_size - n_valid]])
        yield (x[sel], n_valid) if with_counts else x[sel]
