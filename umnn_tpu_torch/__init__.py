"""umnn_tpu_torch: the PyTorch and CUDA port of umnn_tpu for NVIDIA Hopper.

It stands beside the JAX package, which stays the reference, and imports
nothing of it. So far it scores and trains the UMNN-MAF flow, plain and
conditional: the flow, its blocks, MADE and ConditionalMADE, the
Clenshaw-Curtis quadrature with its Leibniz-rule backward, the Lipschitz
projection, the optimizer and train step (``training.loops``),
checkpoints, resume and float16 snapshots that cross with the JAX
package (``training.checkpoint``, ``training.resume``), the validity
report (``utils.validity``), the 2-D toy densities (``data.toy``), the
UCI datasets and their synthetic stand-ins (``data.uci``), the MNIST
training driver (``examples.train_mnist``), the known-entropy
calibration gate (``examples.train_calibration``), the toy density
driver (``examples.train_toy``), the UCI density driver
(``examples.train_uci``) and the hand-written CUDA kernels
of the fused integrand sweep, forward and backward: one pair for any width,
a pair that takes two nodes at a time for integrands at most 64 wide and a
pair that takes four at a time for integrands at most 32 wide.
"""

from umnn_tpu_torch.data.toy import TOY_DATASETS, inf_train_gen
from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.nn.made import ConditionalMADE

__version__ = "0.1.0"

__all__ = ["ConditionalMADE", "TOY_DATASETS", "UMNNMAFFlow", "inf_train_gen"]
