"""Checkpoints with best-k tags, and compact float16 parameter snapshots.

PyTorch counterpart of `umnn_tpu/training/checkpoint.py`, with
``torch.save`` in place of Orbax:

* :class:`CheckpointManager` (`:31-124`) keeps periodic checkpoints of the
  flow's ``state_dict`` and the optimizer's (Adam's moments and step
  counts, and the learning rate) under ``steps/<step>/``, at most
  ``max_to_keep`` of them, the loss history (the resume cursor) in
  ``history.json``, and best-k tagged parameters under ``best_<tag>/``
  (tags ``train``, ``valid``, ``train_valid``);
* :class:`BestTracker` (`:173-222`) holds the best parameters as copies on
  the device and writes them only when flushed;
* :func:`save_params_npz` / :func:`load_params_npz` (`:127-169`) write and
  read the float16 snapshots of the JAX package's ``-load_npz`` flag in
  JAX's leaf order, so that a file written by either package loads in the
  other; for a flow or any VAE family (the MMAF's flow subtree as a flow's).
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from umnn_tpu_torch.bridge import (
    flow_params_to_numpy,
    load_jax_flow_params,
    load_jax_vae_params,
    vae_params_to_numpy,
)
from umnn_tpu_torch.models.flow import UMNNMAFFlow

__all__ = ["BestTracker", "CheckpointManager", "load_params_npz", "save_params_npz"]

STATE_FILE = "state.pt"


@dataclasses.dataclass
class CheckpointManager:
    """Save and restore (model state, optimizer state, step, history), with
    best-k tags. States are the ``state_dict``s of the flow and of the
    optimizer; restoring gives them back for ``load_state_dict``."""

    directory: str | Path
    max_to_keep: int = 5

    def __post_init__(self):
        self.directory = Path(self.directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self._steps = self.directory / "steps"
        self._history_path = self.directory / "history.json"

    # --- periodic checkpoints ----------------------------------------------

    def all_steps(self) -> list[int]:
        """The steps saved here, in order (a directory without this
        package's state file is not one)."""
        if not self._steps.is_dir():
            return []
        return sorted(
            int(p.name) for p in self._steps.iterdir()
            if p.name.isdigit() and (p / STATE_FILE).exists()
        )

    def save(self, step: int, model_state: dict, opt_state: dict, history: Optional[dict] = None):
        path = self._steps / str(step)
        path.mkdir(parents=True, exist_ok=True)
        torch.save({"model": model_state, "optimizer": opt_state}, path / STATE_FILE)
        for old in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(self._steps / str(old))
        if history is not None:
            self._history_path.write_text(json.dumps(history))

    def restore(self, step: Optional[int] = None, map_location=None):
        """``(step, model_state, opt_state)`` of ``step`` (default: the
        latest), or None where there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        state = torch.load(self._steps / str(step) / STATE_FILE, map_location=map_location)
        return step, state["model"], state["optimizer"]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def delete_steps_from(self, first_bad_step: int):
        """Drop periodic checkpoints at or after ``first_bad_step``: a resume
        that rolls the history back must not find them, nor collide with
        them when it saves those steps again."""
        for s in self.all_steps():
            if s >= first_bad_step:
                shutil.rmtree(self._steps / str(s))

    def load_history(self) -> dict:
        """The loss history, which is also the resume cursor
        (`UCIExperiments.py:116-122`: the epoch to start from is its length)."""
        if self._history_path.exists():
            return json.loads(self._history_path.read_text())
        return {"train": [], "valid": [], "test": []}

    # --- best-k tagged parameters (`UCIExperiments.py:172-180`) -------------

    def save_best(self, tag: str, model_state: dict):
        path = self.directory / f"best_{tag}"
        path.mkdir(parents=True, exist_ok=True)
        torch.save(model_state, path / STATE_FILE)

    def load_best(self, tag: str, map_location=None) -> Optional[dict]:
        path = self.directory / f"best_{tag}" / STATE_FILE
        if not path.exists():
            return None
        return torch.load(path, map_location=map_location)


def _flatten(tree) -> list:
    """Leaves in ``jax.tree_util.tree_flatten``'s order: a dict's values by
    sorted key, a list's in turn."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, list):
        return [leaf for item in tree for leaf in _flatten(item)]
    return [tree]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken from the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_unflatten(item, leaves) for item in tree]
    return next(leaves)


def _treedef(tree) -> str:
    """The tree as ``str(jax.tree_util.tree_structure(tree))`` writes it."""
    def inner(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"'{k}': {inner(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(inner(item) for item in t) + "]"
        return "*"

    return f"PyTreeDef({inner(tree)})"


def _to_numpy(model):
    """The model's JAX-layout tree: a flow's, else a VAE's."""
    if isinstance(model, UMNNMAFFlow):
        return flow_params_to_numpy(model)
    return vae_params_to_numpy(model)


def save_params_npz(path: str | Path, flow, dtype=np.float16) -> Path:
    """Write the parameters of a flow or a VAE as one compressed file
    (default float16).

    The leaves are those of the JAX package's flow parameters, in its order
    (per block ``net`` then ``scaling``; in ``net``, ``integrand`` then
    ``made``; per layer ``b`` then ``w``, ``w`` as ``[din, dout]``), under
    the names ``leaf_<i>``, beside a ``__treedef__`` string; the frozen
    scaling, a buffer here, is one of them.
    """
    path = Path(path)
    params = _to_numpy(flow)
    arrays = {f"leaf_{i}": x.astype(dtype) for i, x in enumerate(_flatten(params))}
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, __treedef__=np.array(_treedef(params)), **arrays)
    return path


def load_params_npz(path: str | Path, flow):
    """Load a :func:`save_params_npz` snapshot, or one the JAX package
    wrote, into ``flow`` (a flow or a VAE) in place (float32). Leaf count
    and shapes must match the model's: a mismatch means the snapshot came
    from another model configuration."""
    template = _to_numpy(flow)
    leaves = _flatten(template)
    with np.load(path) as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        if n != len(leaves):
            raise ValueError(f"{path}: snapshot has {n} leaves, template has {len(leaves)}")
        new = []
        for i, leaf in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{path}: leaf_{i} shape {arr.shape} != template {leaf.shape}")
            new.append(arr.astype(np.float32))
    tree = _unflatten(template, iter(new))
    if isinstance(flow, UMNNMAFFlow):
        return load_jax_flow_params(flow, tree)
    return load_jax_vae_params(flow, tree)


@dataclasses.dataclass
class BestTracker:
    """Best-valid / best-train / best-train-valid parameters, the
    reference's three-way policy (`UCIExperiments.py:172-180`).

    Each stash is a copy of the model's ``state_dict`` made on its device
    (``clone``, no read by the host), written to disk only by :meth:`flush`.
    ``CheckpointManager.load_best`` reads only what is on disk, so a driver
    flushes first (or takes :meth:`best_params`, which serves the stashes).
    """

    manager: CheckpointManager
    best_train: float = float("inf")
    best_valid: float = float("inf")

    def __post_init__(self):
        self._pending: dict = {}

    def update(self, train_loss: float, valid_loss: float, model_state: dict):
        if train_loss < self.best_train:
            self.best_train = train_loss
            self._stash("train", model_state)
            if valid_loss < self.best_valid:
                self._stash("train_valid", model_state)
        if valid_loss < self.best_valid:
            self.best_valid = valid_loss
            self._stash("valid", model_state)

    def _stash(self, tag: str, model_state: dict):
        # the live tensors change in place at the next step
        self._pending[tag] = {k: v.detach().clone() for k, v in model_state.items()}

    def flush(self):
        for tag, state in self._pending.items():
            self.manager.save_best(tag, state)
        self._pending.clear()

    def best_params(self, tag: str, fallback: dict) -> dict:
        """The stashed state if tracked, else the one on disk, else ``fallback``."""
        if tag in self._pending:
            return self._pending[tag]
        loaded = self.manager.load_best(tag)
        return loaded if loaded is not None else fallback
