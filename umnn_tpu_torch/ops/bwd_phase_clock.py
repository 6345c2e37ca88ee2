"""Where the time of a backward kernel goes, phase by phase.

Usage, from the root of a checkout on a machine with a CUDA card and nvcc::

    python -m umnn_tpu_torch.ops.bwd_phase_clock [--kernel bwd|bwd_p2|bwd_p4]
        [--rows R] [--calls 5] [--source FILE]

It compiles a copy of the backward kernel (``--kernel bwd``:
``csrc/integrand_bwd.cu`` on the MNIST block, widths 31-100-50-50-50-50-1;
``--kernel bwd_p2``: ``csrc/integrand_bwd_p2.cu`` on the calibration block,
widths 31-50-50-50-50-1, 3,000 rows; both 51 nodes; ``--kernel bwd_p4``:
``csrc/integrand_bwd_p4.cu`` on the flagship's widths 9-32-32-1 at 4,096
rows and 17 nodes, the toy flow's node count; random weights and inputs
from a seed; ``--source``: another version of the file, e.g. a parent
commit's, with the same C interface, compiled with the headers beside it)
in which thread 0 of every block adds
the ``clock64()`` cycles between consecutive ``__syncthreads()`` to one
counter per barrier, checks its dx against the plain version, and prints the
cycles per SM and call spent before each barrier (all blocks' counts over
the card's SMs; where two blocks share an SM both are counted), with the
first comment of its phase, and the call time with the clocks in (a little
above ``chip_smoke.py``'s device time: thread 0 adds to the counters).
ptxas's line for the instrumented kernel comes first (its registers can
differ by one or two from the library's build). Nothing here runs at import.
``ops/fwd_phase_clock.py`` does the same for the forward.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import torch

from umnn_tpu_torch.ops import _build

WIDTHS = [31, 100, 50, 50, 50, 50, 1]  # examples/train_mnist.py's integrand
NODES = 51
OUT = _build.BUILD_DIR / "phase_clock"
BWD_MARKERS = ("integrand_bwd_kernel(const float*", "// out[p] = sum over the grid's blocks")
BWD_P2_MARKERS = ("integrand_bwd_p2_kernel(const float*", "// out[p] = sum over the grid's blocks")
BWD_P4_MARKERS = ("integrand_bwd_p4_kernel(const float*", "// out[p] = sum over the grid's blocks")
# per kernel: its source, markers, widths, rows and nodes (the MNIST block;
# the calibration block of examples/train_calibration.py, 500 x 6 rows; the
# flagship's integrand at scripts/pack4_ab.py's larger batch, 2,048 x 2
# rows, at the toy flow's 17 nodes)
KERNELS = {
    "bwd": ("integrand_bwd.cu", BWD_MARKERS, WIDTHS, 78400, NODES),
    "bwd_p2": ("integrand_bwd_p2.cu", BWD_P2_MARKERS, [31, 50, 50, 50, 50, 1], 3000, NODES),
    "bwd_p4": ("integrand_bwd_p4.cu", BWD_P4_MARKERS, [9, 32, 32, 1], 4096, 17),
}


def instrument(src: str, start: str, end: str) -> tuple[str, list[str]]:
    """The kernel source with a counter after every ``__syncthreads()``
    between the markers ``start`` (the kernel's parameter list) and ``end``
    (the first line past the kernel), and for each counter the comment that
    opens its phase (else its first line of code)."""
    start_at = src.index(start)
    end_at = src.index(end, start_at)
    body, labels = src[start_at:end_at], []
    comment = code = None  # the first comment and code lines after the last barrier

    def tick(match: re.Match) -> str:
        nonlocal comment, code
        labels.append(comment or code or "")
        comment = code = None
        return f"__syncthreads(); TICK({len(labels) - 1});"

    out_lines = []
    for line in body.splitlines(keepends=True):
        stripped = line.strip()
        if stripped.startswith("//") and comment is None:
            comment = stripped[2:].strip()
        elif stripped and code is None and "__syncthreads();" not in stripped:
            code = stripped
        out_lines.append(re.sub(r"__syncthreads\(\);", tick, line))
    body = "".join(out_lines).replace(
        "extern __shared__ __align__(16) float sm[];",
        "extern __shared__ __align__(16) float sm[];\n  long long t_prev = clock64();")
    include = re.search(r'#include "[a-z0-9_]+\.cuh"', src).group(0)  # the file's own header
    head = (
        f"{include}\n"
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
    src = src[:start_at] + body + src[end_at:]
    src = src.replace(include, head, 1).replace('extern "C" {', api, 1)
    return src, labels


def build(source: str, kernel: str, start: str, end: str,
          headers: Path = _build.CSRC) -> tuple[ctypes.CDLL, list[str], dict]:
    """The instrumented library of the CUDA source text ``source`` (its
    kernel ``kernel`` between the markers, compiled with the ``.cuh`` files
    of the directory ``headers``), its phase labels and ptxas's report of the
    kernel (registers, stack and spills)."""
    src, labels = instrument(source, start, end)
    out = OUT / kernel
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for header in headers.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    (out / f"{kernel}_clock.cu").write_text(src)
    lib = out / f"lib{kernel}_clock.so"
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(out / f"{kernel}_clock.cu")],
        capture_output=True, text=True, check=True,
    )
    ptxas = _build.parse_ptxas(proc.stderr).get(kernel, {})
    return ctypes.CDLL(str(lib)), labels, ptxas


def report(lib: ctypes.CDLL, labels: list[str], call, calls: int, sms: int) -> None:
    """Runs ``call`` once, then ``calls`` times with the counters set to 0,
    and prints the call time and the cycles per SM and call before each
    barrier (all blocks' counts over the card's SMs), with their labels."""
    call()
    torch.cuda.synchronize()
    counts = (ctypes.c_ulonglong * 64)()
    lib.umnn_phase_clocks(counts, 1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        call()
    end.record()
    torch.cuda.synchronize()
    lib.umnn_phase_clocks(counts, 0)
    per_sm = [counts[i] / (sms * calls) for i in range(len(labels))]
    total = sum(per_sm)
    print(f"ms per call, clocks in: {start.elapsed_time(end) / calls:.3f}", flush=True)
    print(f"cycles per SM and call before each barrier (total {total:.0f}), and the first "
          "comment (else line) of its phase:")
    for i, (cycles, label) in enumerate(zip(per_sm, labels)):
        print(f"  {i:2d} {cycles:14.0f} {100 * cycles / total:5.1f}%  {label[:70]}")


def mnist_inputs(rows: int, dev: torch.device, widths: list = WIDTHS, nodes: int = NODES) -> tuple:
    """Seeded integrand weights at ``widths``, packed as the kernels take
    them, and h, x, a cotangent g for ``rows`` rows, ``nodes`` CC nodes and
    their weights."""
    from umnn_tpu_torch.nn.core import torch_linear_init
    from umnn_tpu_torch.ops.quadrature import cc_tensors

    gen = torch.Generator().manual_seed(0)
    layers = [torch_linear_init(gen, a, b, dev) for a, b in zip(widths[:-1], widths[1:])]
    params = torch.cat([t.detach().reshape(-1) for l in layers
                        for t in (l.weight.T.contiguous(), l.bias)])
    h = torch.randn(rows, widths[0] - 1, generator=gen).to(dev)
    x = (3 * torch.randn(rows, generator=gen)).to(dev)
    g = torch.randn(rows, generator=gen).to(dev)
    return layers, params, h, x, g, *cc_tensors(nodes - 1, dev)


def layer_pointers(layers) -> ctypes.Array:
    """Each layer's weight and bias addresses, ``[w0, b0, w1, b1, ...]``: the
    pack-4 kernels' weights argument (they read ``nn.Linear``'s tensors in
    place)."""
    ptrs = [t.data_ptr() for l in layers for t in (l.weight, l.bias)]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def slots(lib: ctypes.CDLL, kernel: str, K: int, p_widths, n_layers: int) -> int:
    """A pack-4 kernel's resident blocks on the card, from its C helper."""
    fn = getattr(lib, f"umnn_integrand_{kernel}_slots")
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = fn(K, p_widths, n_layers)
    if n < 1:
        raise RuntimeError(f"umnn_integrand_{kernel}_slots failed: CUDA error {-n}")
    return n


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=list(KERNELS), default="bwd")
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

    from umnn_tpu_torch.ops.integrand_kernel import fused_cc_integral_bwd_plain

    dev = torch.device("cuda:0")
    R = args.rows or rows
    layers, params, h, x, g, nodes, ccw = mnist_inputs(R, dev, widths, K)
    e = widths[0] - 1
    c_widths = (ctypes.c_int * len(widths))(*widths)
    p_widths = ctypes.cast(c_widths, ctypes.c_void_p)
    n_layers = len(widths) - 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    weights, count = params.data_ptr(), sms
    if args.kernel == "bwd_p4":
        ptrs = layer_pointers(layers)
        weights = ctypes.cast(ptrs, ctypes.c_void_p)
        count = slots(lib, args.kernel, K, p_widths, n_layers)
        blocks = count
    elif args.kernel == "bwd":
        blocks = sms
    else:
        grid = getattr(lib, f"umnn_{name}_grid")
        grid.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        blocks = count = grid(R, K, p_widths, n_layers)
        if blocks < 1:
            raise RuntimeError(f"{name}_grid failed: CUDA error {-blocks}")
    P = params.numel()
    partial = torch.empty(blocks * P, device=dev)
    dparams = torch.empty(P, device=dev)
    dx, S = torch.empty(R, device=dev), torch.empty(R, device=dev)
    dh = torch.empty(R, e, device=dev)
    fn = getattr(lib, f"umnn_{name}")
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call() -> None:
        rc = fn(x.data_ptr(), h.data_ptr(), weights, nodes.data_ptr(), ccw.data_ptr(),
                g.data_ptr(), dx.data_ptr(), dh.data_ptr(), S.data_ptr(), partial.data_ptr(),
                dparams.data_ptr(), R, K, count, p_widths, n_layers, 0.01,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

    call()
    want = fused_cc_integral_bwd_plain([l.weight.detach() for l in layers],
                                       [l.bias.detach() for l in layers], x, h, nodes, ccw, g)[2]
    err = float((dx - want).abs().max() / want.abs().max())
    print(f"grid {count} blocks; dx's max error against the plain version, over its largest "
          f"entry: {err:.3g}", flush=True)
    report(lib, labels, call, args.calls, sms)


if __name__ == "__main__":
    main()
