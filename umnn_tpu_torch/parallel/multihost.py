"""The per-process body of a data-parallel training step.

PyTorch counterpart of `umnn_tpu/parallel/multihost.py`: every process
brings up the group (:func:`~umnn_tpu_torch.parallel.mesh.initialize_distributed`),
builds the same flow from the same seed (2 blocks, D = 4, MADE (32, 32),
integrand (16, 16), embedding 4, 12 steps, backend "torch"), takes Adam at
lr 1e-3 with no decay, and runs 3 steps on the ``RandomState(0)`` 32 x 4
batch, each rank feeding its contiguous rows; the gradients are
all-reduced, so every rank holds the same parameters. With one process and
no group it is the plain step on the whole batch; with a group of one
already up (e.g. NCCL on one card) it all-reduces over it.

Run one worker (``--device cpu``: gloo on the CPU; default the card, NCCL):

    python -m umnn_tpu_torch.parallel.multihost --process_id I --num_processes N \\
        --coordinator 127.0.0.1:PORT --device cpu

It prints one line ``MULTIHOST_RESULT {...}`` with the per-step losses and
a parameter checksum.
"""

from __future__ import annotations

import json

import numpy as np
import torch
import torch.distributed as dist

from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.nn.core import resolve_device
from umnn_tpu_torch.parallel.mesh import host_local_rows, initialize_distributed
from umnn_tpu_torch.training.loops import make_optimizer, make_train_step

__all__ = ["FLOW_KW", "GLOBAL_BATCH_ROWS", "N_STEPS", "global_batch", "run_multihost_step"]

GLOBAL_BATCH_ROWS = 32
N_FEATURES = 4
N_STEPS = 3
FLOW_KW = dict(nb_flow=2, nb_in=N_FEATURES, hidden_embedding=(32, 32), hidden_derivative=(16, 16),
               embedding_s=4, nb_steps=12, backend="torch")


def global_batch() -> np.ndarray:
    """The global batch every process derives, feeding only its own rows."""
    return np.asarray(np.random.RandomState(0).randn(GLOBAL_BATCH_ROWS, N_FEATURES), np.float32)


def run_multihost_step(
    num_processes: int,
    process_id: int,
    coordinator: str | None = None,
    device: torch.device | str | None = None,
) -> dict:
    """``{"losses", "param_sum", "n_devices", "n_local"}``: the mean loss of
    each step over every rank's rows, the sum of the absolute values of the
    parameters after the last (the scaling buffers too, as in JAX's tree),
    the ranks in the group and the devices of this process."""
    device = resolve_device(device)
    initialize_distributed(coordinator, num_processes, process_id, device)
    group = dist.group.WORLD if dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    rank = dist.get_rank() if group is not None else 0
    flow = UMNNMAFFlow(**FLOW_KW, seed=0, device=device)
    opt = make_optimizer(flow.parameters(), "adam", lr=1e-3, weight_decay=0.0)
    step = make_train_step(lambda xb: -flow.compute_ll(xb)[0].mean(), opt, process_group=group)
    local = torch.as_tensor(host_local_rows(global_batch(), rank, world), device=device)
    losses = [float(step(local)) for _ in range(N_STEPS)]
    param_sum = float(sum(float(v.abs().sum()) for v in flow.state_dict().values()))
    return {"losses": losses, "param_sum": param_sum, "n_devices": world, "n_local": 1}


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--process_id", type=int, required=True)
    p.add_argument("--num_processes", type=int, required=True)
    p.add_argument("--coordinator", required=True, help="host:port of the rendezvous")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)
    out = run_multihost_step(args.num_processes, args.process_id, args.coordinator, args.device)
    print("MULTIHOST_RESULT " + json.dumps(out), flush=True)
    if dist.is_initialized():  # every rank leaves the group together
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
