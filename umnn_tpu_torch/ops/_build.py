"""Builds the port's CUDA sources with ``nvcc`` and binds them.

The sources ``umnn_tpu_torch/csrc/*.cu`` and the header they share,
``common.cuh``, have a plain C interface, so they compile in seconds
without PyTorch's headers: one ``nvcc`` process per source, all started
together, then one more that links the objects. The shared library goes into
``build/umnn_tpu_torch/`` at the root of the checkout (listed in
``.gitignore``), under a name keyed on a hash of the sources and flags, so a
stale library is never loaded; ptxas's report of each kernel's registers,
stack and spills goes beside it (:func:`ptxas_report`). Nothing here runs
at import: the build happens at the first call of :func:`load_library`, on
a machine with ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "find_nvcc", "load_library", "parse_ptxas",
           "ptxas_report"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "umnn_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C functions of csrc/: name -> (argtypes, restype). Every pointer, the
# stream included, is a c_void_p, or ctypes would cut it to 32 bits.
SIGNATURES = {
    "umnn_integrand_fwd": ([_P, _P, _P, _P, _P, _P, _I, _I, _P, _I, ctypes.c_float, _P], _I),
    "umnn_integrand_fwd_smem_bytes": ([_I, _P, _I], ctypes.c_longlong),
    "umnn_integrand_bwd": ([_P] * 11 + [_I, _I, _I, _P, _I, ctypes.c_float, _P], _I),
    "umnn_integrand_bwd_smem_bytes": ([_I, _P, _I], ctypes.c_longlong),
    "umnn_integrand_bwd_grid": ([_I], _I),
    "umnn_integrand_fwd_p2": ([_P, _P, _P, _P, _P, _P, _I, _I, _P, _I, ctypes.c_float, _P], _I),
    "umnn_integrand_fwd_p2_smem_bytes": ([_I, _P, _I], ctypes.c_longlong),
    "umnn_integrand_fwd_p2_occupancy": ([_I, _I, _P, _I, _P], _I),
    "umnn_integrand_bwd_p2": ([_P] * 11 + [_I, _I, _I, _P, _I, ctypes.c_float, _P], _I),
    "umnn_integrand_bwd_p2_smem_bytes": ([_I, _P, _I], ctypes.c_longlong),
    "umnn_integrand_bwd_p2_grid": ([_I, _I, _P, _I], _I),
    "umnn_integrand_fwd_p4": ([_P] * 6 + [_I, _I, _I, _P, _I, ctypes.c_float, _P], _I),
    "umnn_integrand_fwd_p4_smem_bytes": ([_I, _P, _I], ctypes.c_longlong),
    "umnn_integrand_fwd_p4_slots": ([_I, _P, _I], _I),
    "umnn_integrand_fwd_p4_occupancy": ([_I, _I, _P, _I, _P], _I),
    "umnn_integrand_bwd_p4": ([_P] * 11 + [_I, _I, _I, _P, _I, ctypes.c_float, _P], _I),
    "umnn_integrand_bwd_p4_smem_bytes": ([_I, _P, _I], ctypes.c_longlong),
    "umnn_integrand_bwd_p4_slots": ([_I, _P, _I], _I),
    "umnn_integrand_bwd_p4_occupancy": ([_I, _I, _P, _I, _P], _I),
    "umnn_integrand_fwd_wide": ([_P] * 6 + [_I, _I, _P, _I, ctypes.c_float, _P, _P], _I),
    "umnn_integrand_bwd_wide": ([_P] * 11 + [_I, _I, _P, _I, ctypes.c_float, _P, _P], _I),
    "umnn_integrand_wide_scratch_floats": ([_I, _I, _P, _I], ctypes.c_longlong),
    "umnn_cuda_error_string": ([_I], ctypes.c_char_p),
}

_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found in $CUDA_HOME/bin, /usr/local/cuda/bin or PATH: the "
            "CUDA kernels of umnn_tpu_torch need the CUDA toolkit to build"
        )
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libumnn_tpu_torch_{digest.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Runs the commands side by side; their stderr, or raises with the
    first failure's."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errs = [p.communicate()[1] for p in procs]
    for cmd, proc, err in zip(cmds, procs, errs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    return errs


def build() -> Path:
    """Compile ``csrc/*.cu`` into one shared library unless it is there."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in _sources()]
    tmp = out.with_name(f"{stem}.tmp.so")
    try:
        errs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                         for src, o in zip(_sources(), objs)])
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    out.with_suffix(".ptxas.txt").write_text("".join(errs))
    os.replace(tmp, out)
    return out


def ptxas_report() -> dict:
    """Per kernel of the built library: ``{"registers", "stack_bytes",
    "spill_stores_bytes", "spill_loads_bytes", "smem_bytes"}``, from ptxas's
    output."""
    return parse_ptxas(library_path().with_suffix(".ptxas.txt").read_text())


def parse_ptxas(text: str) -> dict:
    """:func:`ptxas_report`'s dictionary from the text ptxas printed; a
    template's instances as ``name<arg,...>``."""
    out, name = {}, None
    for line in text.splitlines():
        # the mangled name ends in <length><name>E<parameters>, a template
        # instance's in <length><name>I<arguments>E...
        m = re.search(r"Compiling entry function '.*\d(integrand_[a-z0-9_]+?_(?:kernel|reduce))"
                      r"(?:E|I((?:L[a-z]+-?\d+E)+)E)", line)
        if m:
            name = m.group(1)
            if m.group(2):
                name += f"<{','.join(re.findall(r'L[a-z]+(-?\d+)E', m.group(2)))}>"
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                      r"(\d+) bytes spill loads", line)):
            out[name].update(stack_bytes=int(m[1]), spill_stores_bytes=int(m[2]),
                             spill_loads_bytes=int(m[3]))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m[1])
            if m := re.search(r"(\d+) bytes smem", line):
                out[name]["smem_bytes"] = int(m[1])
    return out


def load_library() -> ctypes.CDLL:
    """The bound library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib
