"""Where the time of ``csrc/integrand_fwd.cu`` goes, phase by phase.

Usage, from the root of a checkout on a machine with a CUDA card and nvcc::

    python -m umnn_tpu_torch.ops.fwd_phase_clock [--rows 78400] [--calls 5]
        [--source FILE]

It compiles a copy of the forward kernel (``--source``: another version of
the file, e.g. a parent commit's, with the same C interface) in which thread
0 of every block adds the ``clock64()`` cycles between consecutive
``__syncthreads()`` to one counter per barrier, runs it on the MNIST block
(the backward's phase clock's seeded weights and inputs, widths
31-100-50-50-50-50-1, 51 nodes), checks the result against the plain
version, and prints the cycles per SM and call spent before each barrier
(all blocks' counts over the card's SMs, so that a grid of one block per row
tile and a persistent grid compare), with the first comment of its phase,
and the call time with the clocks in. Nothing here runs at import.
"""

from __future__ import annotations

import argparse
import ctypes
from pathlib import Path

import torch

from umnn_tpu_torch.ops import _build
from umnn_tpu_torch.ops.bwd_phase_clock import NODES, WIDTHS, build, mnist_inputs, report

# the kernel's parameter list, and the first line past the kernel
FWD_MARKERS = ("integrand_fwd_kernel(const float*", "}  // namespace")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=78400)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--source", type=Path, default=_build.CSRC / "integrand_fwd.cu")
    args = ap.parse_args()
    lib, labels, ptxas = build(args.source.read_text(), "integrand_fwd_kernel", *FWD_MARKERS)
    print(f"source {args.source}", flush=True)
    print("ptxas integrand_fwd_kernel:", ptxas, flush=True)

    from umnn_tpu_torch.ops.integrand_kernel import fused_cc_integral_plain

    dev = torch.device("cuda:0")
    layers, params, h, x, _, nodes, ccw = mnist_inputs(args.rows, dev)
    out = torch.empty(args.rows, device=dev)
    c_widths = (ctypes.c_int * len(WIDTHS))(*WIDTHS)
    fn = lib.umnn_integrand_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call() -> None:
        rc = fn(x.data_ptr(), h.data_ptr(), params.data_ptr(), nodes.data_ptr(), ccw.data_ptr(),
                out.data_ptr(), args.rows, NODES, ctypes.cast(c_widths, ctypes.c_void_p),
                len(WIDTHS) - 1, 0.01, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"integrand_fwd launch failed: CUDA error {rc}")

    call()
    with torch.no_grad():
        want = fused_cc_integral_plain([l.weight for l in layers], [l.bias for l in layers],
                                       x, h, nodes, ccw)
    err = float((out - want).abs().max())
    print(f"max abs error against the plain version: {err:.3g}", flush=True)
    report(lib, labels, call, args.calls, torch.cuda.get_device_properties(dev).multi_processor_count)


if __name__ == "__main__":
    main()
