"""Process-group bring-up and batch helpers: the data-parallel layer.

PyTorch counterpart of `umnn_tpu/parallel/mesh.py`. JAX builds one mesh
over every process's devices and lets XLA insert the gradient all-reduce;
here every rank is one process with one device, the group is brought up
explicitly (``initialize_distributed``), each rank feeds its contiguous
share of the global batch (``host_local_rows``, the counterpart of
``host_local_batch_to_global``), and the train step all-reduces the
gradients (:func:`umnn_tpu_torch.training.loops.make_train_step` with
``process_group``). Not ported, by
decision: ``data_mesh``, ``replicated`` and ``batch_sharded`` on one card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from umnn_tpu_torch.nn.core import resolve_device

__all__ = ["host_local_rows", "initialize_distributed"]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: torch.device | str | None = None,
) -> None:
    """Bring up the default process group: NCCL on the card, gloo on the
    CPU, rendezvous at ``tcp://<coordinator_address>`` (``host:port``).
    Nothing happens for one process. ``device`` as every entry point's: the
    card unless the caller names another."""
    device = resolve_device(device)
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("more than one process needs coordinator_address and process_id")
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )


def host_local_rows(batch: np.ndarray, rank: int, world: int) -> np.ndarray:
    """Rank ``rank``'s contiguous share of the global batch's rows."""
    n = batch.shape[0]
    if n % world:
        raise ValueError(f"{n} rows do not split into {world} equal shares")
    share = n // world
    return batch[rank * share : (rank + 1) * share]

