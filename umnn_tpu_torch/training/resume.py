"""Rebuilding the training state from a checkpoint, for a driver's ``-load``.

PyTorch counterpart of `umnn_tpu/training/resume.py:36`. The reference
resumes by reloading `model_best_train.pt` and the pickled loss history as
an epoch cursor (`UCIExperiments.py:93-122`), and resets the optimizer's
moments and the scheduler. This restores the flow's and the optimizer's
states of the latest periodic checkpoint, and also:

* replays the plateau schedule over the saved validation history, so its
  best and bad-epoch counters carry on;
* seeds the best-checkpoint tracker from the history, so the first epochs
  after a resume cannot overwrite a better earlier best;
* recovers from a non-finite checkpoint (a diverged run that saved NaN
  parameters): the history is cut to its finite prefix, the best-valid
  parameters are loaded, the periodic checkpoints from the cut on are
  deleted, and a fresh optimizer takes the learning rate the replayed
  plateau gives.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resume_training_state"]


def _all_finite(state: dict) -> bool:
    return all(
        bool(torch.isfinite(v).all()) for v in state.values() if torch.is_floating_point(v)
    )


def resume_training_state(
    ckpt,
    model: torch.nn.Module,
    optimizer,
    *,
    history: dict,
    plateau,
    best=None,
    init_lr: float,
    logger=None,
):
    """Restore ``model`` and ``optimizer`` in place from ``ckpt``'s latest
    checkpoint; returns ``(lr, start_epoch, history)``.

    ``history`` must already be loaded (its length is the epoch cursor);
    ``plateau`` is advanced by replaying the finite validation history;
    ``best`` (a BestTracker) is seeded from the history when given.
    """
    info = logger.info if logger is not None else (lambda *a: None)
    start_epoch = len(history["valid"])
    lr = init_lr
    restored = ckpt.restore(map_location="cpu")
    if restored is not None:
        _, model_state, opt_state = restored
        if _all_finite(model_state):
            model.load_state_dict(model_state)
            # the (possibly plateau-cut) learning rate rides in the
            # optimizer's state: restarting from init_lr would let the next
            # plateau raise the rate
            optimizer.load_state_dict(opt_state)
            lr = optimizer.lr
            # replay the plateau's counters; the rate itself is the restored one
            replay_lr = init_lr
            for v in history["valid"]:
                replay_lr = plateau.update(v, replay_lr)
            info("resumed at epoch %d (lr %g)", start_epoch, lr)
        else:
            n_ok = next(
                (i for i, v in enumerate(history["valid"]) if not np.isfinite(v)),
                len(history["valid"]),
            )
            history["train"] = history["train"][:n_ok]
            history["valid"] = history["valid"][:n_ok]
            start_epoch = n_ok
            best_state = ckpt.load_best("valid", map_location="cpu")
            if best_state is None:
                raise RuntimeError(
                    "latest checkpoint is non-finite and no best-valid fallback exists"
                )
            model.load_state_dict(best_state)
            ckpt.delete_steps_from(n_ok)  # the NaN periodic checkpoints
            for v in history["valid"]:
                lr = plateau.update(v, lr)
            optimizer.reset(lr)
            info(
                "restored checkpoint was non-finite: resuming from best-valid params "
                "at epoch %d (replayed lr %g)", start_epoch, lr,
            )
        if best is not None:
            finite_t = [v for v in history["train"] if np.isfinite(v)]
            finite_v = [v for v in history["valid"] if np.isfinite(v)]
            if finite_t:
                best.best_train = min(finite_t)
            if finite_v:
                best.best_valid = min(finite_v)
    return lr, start_epoch, history
