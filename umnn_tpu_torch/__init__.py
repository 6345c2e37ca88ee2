"""umnn_tpu_torch: the PyTorch and CUDA port of umnn_tpu for NVIDIA Hopper.

It stands beside the JAX package, which stays the reference, and imports
nothing of it. So far it serves the UMNN-MAF flow's likelihood: the flow,
its blocks, MADE, the Clenshaw-Curtis quadrature and the hand-written CUDA
kernel of the fused integrand sweep (forward only).
"""

from umnn_tpu_torch.models.flow import UMNNMAFFlow

__version__ = "0.1.0"

__all__ = ["UMNNMAFFlow"]
