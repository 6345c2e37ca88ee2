"""Where the time of a forward kernel goes, phase by phase.

Usage, from the root of a checkout on a machine with a CUDA card and nvcc::

    python -m umnn_tpu_torch.ops.fwd_phase_clock [--kernel fwd|fwd_p2|fwd_p4]
        [--rows R] [--calls 5] [--source FILE]

It compiles a copy of the forward kernel (``--kernel fwd``:
``csrc/integrand_fwd.cu`` on the MNIST block, widths 31-100-50-50-50-50-1,
78,400 rows; ``--kernel fwd_p2``: ``csrc/integrand_fwd_p2.cu`` on the
calibration block, widths 31-50-50-50-50-1, 3,000 rows; both 51 nodes;
``--kernel fwd_p4``: ``csrc/integrand_fwd_p4.cu`` at 4,096 rows, widths
9-32-32-1 and 17 nodes; the backward's phase clock's seeded weights and
inputs; ``--source``: another version of the file, e.g. a parent commit's,
with the same C interface, compiled with the headers beside it) in which
thread 0 of every block adds the ``clock64()`` cycles between
consecutive ``__syncthreads()`` to one counter per barrier, checks the result
against the plain version, and prints the cycles per SM and call spent before
each barrier (all blocks' counts over the card's SMs, so that a grid of one
block per row tile and a persistent grid compare; where several blocks share
an SM all are counted), with the first comment of its phase, and the call
time with the clocks in. Nothing here runs at import.
"""

from __future__ import annotations

import argparse
import ctypes
from pathlib import Path

import torch

from umnn_tpu_torch.ops import _build
from umnn_tpu_torch.ops.bwd_phase_clock import KERNELS as BWD_KERNELS
from umnn_tpu_torch.ops.bwd_phase_clock import (build, layer_pointers, mnist_inputs, report,
                                                slots)

# each kernel's parameter list, and the first line past the kernel
FWD_MARKERS = ("integrand_fwd_kernel(const float*", "}  // namespace")
FWD_P2_MARKERS = ("integrand_fwd_p2_kernel(const float*", "}  // namespace")
FWD_P4_MARKERS = ("integrand_fwd_p4_kernel(const float*", "}  // namespace")
# per kernel: its source, markers, widths, rows and nodes (the blocks of the
# backward's phase clock)
KERNELS = {
    "fwd": ("integrand_fwd.cu", FWD_MARKERS, *BWD_KERNELS["bwd"][2:]),
    "fwd_p2": ("integrand_fwd_p2.cu", FWD_P2_MARKERS, *BWD_KERNELS["bwd_p2"][2:]),
    "fwd_p4": ("integrand_fwd_p4.cu", FWD_P4_MARKERS, *BWD_KERNELS["bwd_p4"][2:]),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=list(KERNELS), default="fwd")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--source", type=Path, default=None)
    args = ap.parse_args()
    file, markers, widths, rows, K = KERNELS[args.kernel]
    source = args.source or _build.CSRC / file
    name = f"integrand_{args.kernel}"
    lib, labels, ptxas = build(source.read_text(), f"{name}_kernel", *markers, source.parent)
    print(f"source {source}", flush=True)
    print(f"ptxas {name}_kernel:", ptxas, flush=True)

    from umnn_tpu_torch.ops.integrand_kernel import fused_cc_integral_plain

    dev = torch.device("cuda:0")
    R = args.rows or rows
    layers, params, h, x, _, nodes, ccw = mnist_inputs(R, dev, widths, K)
    out = torch.empty(R, device=dev)
    c_widths = (ctypes.c_int * len(widths))(*widths)
    p_widths = ctypes.cast(c_widths, ctypes.c_void_p)
    n_layers = len(widths) - 1
    fn = getattr(lib, f"umnn_{name}")
    # the pack-4 forward reads the layers in place and takes its resident
    # blocks, the other forwards take the packed weights
    head = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
    tail = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    if args.kernel == "fwd_p4":
        ptrs = layer_pointers(layers)
        extra = [slots(lib, args.kernel, K, p_widths, n_layers)]
        weights, fn.argtypes = ctypes.cast(ptrs, ctypes.c_void_p), head + [ctypes.c_int] + tail
    else:
        extra, weights, fn.argtypes = [], params.data_ptr(), head + tail
    fn.restype = ctypes.c_int

    def call() -> None:
        rc = fn(x.data_ptr(), h.data_ptr(), weights, nodes.data_ptr(), ccw.data_ptr(),
                out.data_ptr(), R, K, *extra, p_widths, n_layers, 0.01,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

    call()
    with torch.no_grad():
        want = fused_cc_integral_plain([l.weight for l in layers], [l.bias for l in layers],
                                       x, h, nodes, ccw)
    err = float((out - want).abs().max())
    print(f"max abs error against the plain version: {err:.3g}", flush=True)
    report(lib, labels, call, args.calls, torch.cuda.get_device_properties(dev).multi_processor_count)


if __name__ == "__main__":
    main()
