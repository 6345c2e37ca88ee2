"""umnn_tpu_torch: the PyTorch and CUDA port of umnn_tpu for NVIDIA Hopper.

It stands beside the JAX package, which stays the reference, and imports
nothing of it. So far it scores and trains the UMNN-MAF flow: the flow, its
blocks, MADE, the Clenshaw-Curtis quadrature with its Leibniz-rule
backward, the optimizer and train step (``training.loops``), the MNIST
training driver (``examples.train_mnist``), the known-entropy calibration
gate (``examples.train_calibration``) and the hand-written CUDA kernels of
the fused integrand sweep, forward and backward: one pair for any width
and a pair that takes two nodes at a time for integrands at most 64 wide.
"""

from umnn_tpu_torch.models.flow import UMNNMAFFlow

__version__ = "0.1.0"

__all__ = ["UMNNMAFFlow"]
