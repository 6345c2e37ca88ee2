"""umnn_tpu_torch: the PyTorch and CUDA port of umnn_tpu for NVIDIA Hopper.

It stands beside the JAX package, which stays the reference, and imports
nothing of it. It scores, trains, inverts and samples the UMNN-MAF flow,
plain and conditional: the flow, its blocks (with the "CCParallel" and
node-sequential "CC" solvers), MADE and ConditionalMADE, the
Clenshaw-Curtis quadrature with its Leibniz-rule backward, the Lipschitz
projection; the monotone regressor MonotonicNN (``models.monotonic``);
the optimizer, train, accumulation and evaluation steps
(``training.loops``), checkpoints, resume and float16 snapshots that cross
with the JAX package (``training.checkpoint``, ``training.resume``), the
validity report, profiling and plots (``utils``); the 2-D toy densities,
the UCI datasets, MNIST and their seeded stand-ins and downloader
(``data``); the VAE stack with its six flow posteriors, the UMNN MMAF
among them, ELBO and IWAE (``models.vae``), and its four datasets; the
data-parallel layer over ``torch.distributed`` (``parallel``); the MNIST,
calibration, toy, UCI, monotonic and VAE drivers (``examples``); and the
hand-written CUDA kernels of the fused integrand
sweep, forward and backward: one pair for any width, a pair that takes
two nodes at a time for integrands at most 64 wide, a pair that takes
four at a time for integrands at most 32 wide, and a streamed pair for
what the others refuse. Every entry point runs on the card unless the
caller names the CPU.
"""

from umnn_tpu_torch.data.toy import TOY_DATASETS, inf_train_gen
from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.models.monotonic import MonotonicNN
from umnn_tpu_torch.nn.made import ConditionalMADE

__version__ = "0.1.0"

__all__ = ["ConditionalMADE", "MonotonicNN", "TOY_DATASETS", "UMNNMAFFlow", "inf_train_gen"]
