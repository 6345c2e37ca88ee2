"""Where the time of ``csrc/integrand_bwd.cu`` goes, phase by phase.

Usage, from the root of a checkout on a machine with a CUDA card and nvcc::

    python -m umnn_tpu_torch.ops.bwd_phase_clock [--rows 78400] [--calls 5]

It compiles a copy of the backward kernel in which thread 0 of every block
adds the ``clock64()`` cycles between consecutive ``__syncthreads()`` to one
counter per barrier, runs the copy on the MNIST block (random weights and
inputs from a seed, widths 31-100-50-50-50-50-1, 51 nodes), and prints the
cycles per block and call spent before each barrier, with the first comment
of its phase, and the call time with the clocks in (a little above
``chip_smoke.py``'s device time: thread 0 adds to the counters). ptxas's
line for the instrumented kernel comes first (its registers can differ by
one or two from the library's build). Nothing here runs at import.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess

import torch

from umnn_tpu_torch.ops import _build

WIDTHS = [31, 100, 50, 50, 50, 50, 1]  # examples/train_mnist.py's integrand
NODES = 51
OUT = _build.BUILD_DIR / "phase_clock"


def instrument(src: str) -> tuple[str, list[str]]:
    """The kernel source with a counter after every ``__syncthreads()`` of
    ``integrand_bwd_kernel``, and for each counter the comment that opens
    its phase."""
    start = src.index("integrand_bwd_kernel(const float*")
    end = src.index("// out[p] = sum over the grid's blocks")
    body, labels = src[start:end], []
    comment = None  # the first comment line after the last barrier

    def tick(match: re.Match) -> str:
        nonlocal comment
        labels.append(comment or "")
        comment = None
        return f"__syncthreads(); TICK({len(labels) - 1});"

    out_lines = []
    for line in body.splitlines(keepends=True):
        stripped = line.strip()
        if stripped.startswith("//") and comment is None:
            comment = stripped[2:].strip()
        out_lines.append(re.sub(r"__syncthreads\(\);", tick, line))
    body = "".join(out_lines).replace(
        "extern __shared__ __align__(16) float sm[];",
        "extern __shared__ __align__(16) float sm[];\n  long long t_prev = clock64();")
    head = (
        '#include "common.cuh"\n'
        "__device__ unsigned long long g_phase[64];\n"
        "#define TICK(i) do { if (threadIdx.x == 0) { const long long t_now = clock64(); "
        "atomicAdd(&g_phase[i], (unsigned long long)(t_now - t_prev)); "
        "t_prev = t_now; } } while (0)\n"
    )
    api = (
        'extern "C" {\n'
        "int umnn_phase_clocks(unsigned long long* out, int clear) {\n"
        "  unsigned long long z[64] = {};\n"
        "  if (clear) return cudaMemcpyToSymbol(g_phase, z, sizeof z);\n"
        "  return cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * 64);\n}\n"
    )
    src = src[:start] + body + src[end:]
    src = src.replace('#include "common.cuh"', head, 1).replace('extern "C" {', api, 1)
    return src, labels


def build() -> tuple[ctypes.CDLL, list[str], str]:
    """The instrumented library, its phase labels and ptxas's line."""
    src, labels = instrument((_build.CSRC / "integrand_bwd.cu").read_text())
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    shutil.copy(_build.CSRC / "common.cuh", OUT / "common.cuh")
    (OUT / "integrand_bwd_clock.cu").write_text(src)
    lib = OUT / "libintegrand_bwd_clock.so"
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(OUT / "integrand_bwd_clock.cu")],
        capture_output=True, text=True, check=True,
    )
    lines = proc.stderr.splitlines()
    ptxas = next((" | ".join(s.strip() for s in lines[i + 2 : i + 4])
                  for i, s in enumerate(lines) if "integrand_bwd_kernel" in s), "")
    return ctypes.CDLL(str(lib)), labels, ptxas


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=78400)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    lib, labels, ptxas = build()
    print("ptxas integrand_bwd_kernel:", ptxas, flush=True)

    from umnn_tpu_torch.nn.core import torch_linear_init
    from umnn_tpu_torch.ops.quadrature import cc_tensors

    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    layers = [torch_linear_init(gen, a, b, dev) for a, b in zip(WIDTHS[:-1], WIDTHS[1:])]
    params = torch.cat([t.detach().reshape(-1) for l in layers
                        for t in (l.weight.T.contiguous(), l.bias)])
    R, e = args.rows, WIDTHS[0] - 1
    h = torch.randn(R, e, generator=gen).to(dev)
    x = (3 * torch.randn(R, generator=gen)).to(dev)
    g = torch.randn(R, generator=gen).to(dev)
    nodes, ccw = cc_tensors(NODES - 1, dev)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    P = params.numel()
    partial = torch.empty(blocks * P, device=dev)
    dparams = torch.empty(P, device=dev)
    dx, S = torch.empty(R, device=dev), torch.empty(R, device=dev)
    dh = torch.empty(R, e, device=dev)
    c_widths = (ctypes.c_int * len(WIDTHS))(*WIDTHS)
    fn = lib.umnn_integrand_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call() -> None:
        rc = fn(x.data_ptr(), h.data_ptr(), params.data_ptr(), nodes.data_ptr(), ccw.data_ptr(),
                g.data_ptr(), dx.data_ptr(), dh.data_ptr(), S.data_ptr(), partial.data_ptr(),
                dparams.data_ptr(), R, NODES, blocks, ctypes.cast(c_widths, ctypes.c_void_p),
                len(WIDTHS) - 1, 0.01, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"integrand_bwd launch failed: CUDA error {rc}")

    call()
    torch.cuda.synchronize()
    counts = (ctypes.c_ulonglong * 64)()
    lib.umnn_phase_clocks(counts, 1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.calls):
        call()
    end.record()
    torch.cuda.synchronize()
    lib.umnn_phase_clocks(counts, 0)
    per_block = [counts[i] / (blocks * args.calls) for i in range(len(labels))]
    total = sum(per_block)
    print(f"ms per call, clocks in: {start.elapsed_time(end) / args.calls:.3f}", flush=True)
    print("cycles per block and call before each barrier, and the first comment of its phase:")
    for i, (cycles, label) in enumerate(zip(per_block, labels)):
        print(f"  {i:2d} {cycles:14.0f} {100 * cycles / total:5.1f}%  {label[:70]}")


if __name__ == "__main__":
    main()
