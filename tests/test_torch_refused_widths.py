"""What the kernel route does with an integrand its kernels cannot take.

On the card, under ``backend="kernel"`` and ``"auto"`` alike, the wrapper asks
each kernel's own C helper (``umnn_integrand_{fwd,bwd}[_p2|_p4]_smem_bytes``)
before any launch, and raises where one refuses the widths (-1) or asks for
more shared memory than the card gives a block, naming ``backend='torch'``,
which computes such an integrand on the card. The CUDA library cannot be
built here, so its helpers are stubbed with the limits of the kernels'
sources; on the card ``chip_smoke.py`` pins the same against the real ones.
"""

import ctypes
from types import SimpleNamespace

import pytest
import torch

from umnn_tpu_torch.models.umnn_maf import UMNNMAF
from umnn_tpu_torch.ops import _build
from umnn_tpu_torch.ops import integrand_kernel as ik

OPTIN = 232448  # an H100 block's opt-in shared memory, in bytes
MNIST = [31, 100, 50, 50, 50, 50, 1]


class FakeLibrary:
    """The C helpers of the kernels: -1 past a hidden width of 128, else 4
    bytes per weight and per K x width, and 1 MB (past the card's limit) for
    the kernels listed in ``too_big``. Records every call; launching
    anything raises."""

    def __init__(self, too_big=()):
        self.calls = []
        self.too_big = set(too_big)
        for suffix in ("", "_p2", "_p4"):
            for kind in ("fwd", "bwd"):
                name = f"umnn_integrand_{kind}{suffix}"
                setattr(self, f"{name}_smem_bytes", self._helper(f"{kind}{suffix}"))
                setattr(self, name, self._launch)

    def _helper(self, kernel):
        def smem_bytes(K, ptr, n_layers):
            widths = list(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int))[: n_layers + 1])
            self.calls.append((kernel, widths, K))
            if max(widths[1:-1]) > 128:
                return -1
            if kernel in self.too_big:
                return 1 << 20
            return 4 * sum(a * b for a, b in zip(widths[:-1], widths[1:])) + 4 * K * max(widths)
        return smem_bytes

    def _launch(self, *args):
        raise AssertionError("a refused integrand must launch nothing")


@pytest.fixture
def fake_card(monkeypatch):
    def install(**kw):
        lib = FakeLibrary(**kw)
        monkeypatch.setattr(_build, "load_library", lambda: lib)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda device: SimpleNamespace(shared_memory_per_block_optin=OPTIN))
        return lib
    return install


def _inputs(widths, rows=3, K=51):
    gen = torch.Generator().manual_seed(0)
    ws = [torch.randn(b, a, generator=gen) for a, b in zip(widths[:-1], widths[1:])]
    bs = [torch.randn(b, generator=gen) for b in widths[1:]]
    x = torch.randn(rows, generator=gen)
    h = torch.randn(rows, widths[0] - 1, generator=gen)
    nodes, ccw = torch.linspace(-1, 1, K), torch.full((K,), 2.0 / K)
    return ws, bs, x, h, nodes, ccw


def _check(widths, route="", grad=False):
    ws, bs, x, h, nodes, ccw = _inputs(widths)
    return ik._check(ws, bs, x, h, nodes, ccw, [x, h, nodes, ccw, *ws, *bs], route, grad=grad)


@pytest.mark.parametrize("widths, too_big, grad, refuser, asked", [
    ([31, 129, 1], (), False, "integrand_fwd.cu", ["fwd"]),
    ([31, 100, 129, 1], (), True, "integrand_fwd.cu", ["fwd"]),
    ([31, 128, 128, 1], ("fwd",), False, "integrand_fwd;", ["fwd"]),
    ([31, 128, 128, 1], ("bwd",), True, "integrand_bwd;", ["fwd", "bwd"]),
], ids=["w129", "w100_129_grad", "fwd_past_the_card", "bwd_past_the_card"])
def test_a_refused_integrand_raises_before_any_launch_and_names_the_torch_backend(
        fake_card, widths, too_big, grad, refuser, asked):
    lib = fake_card(too_big=too_big)
    with pytest.raises(ValueError, match="backend='torch'") as err:
        _check(widths, grad=grad)
    assert refuser in str(err.value)
    assert [c[0] for c in lib.calls] == asked


@pytest.mark.parametrize("widths, route, grad, asked", [
    (MNIST, "", False, ["fwd"]),
    (MNIST, "", True, ["fwd", "bwd"]),
    ([31, 128, 128, 76, 1], "", True, ["fwd", "bwd"]),
    ([31, 50, 50, 50, 50, 1], "_p2", True, ["fwd_p2", "bwd_p2"]),
], ids=["mnist", "mnist_grad", "w128_128_76_grad", "calibration_p2_grad"])
def test_an_integrand_both_helpers_take_passes_with_its_widths(fake_card, widths, route, grad,
                                                               asked):
    lib = fake_card()
    assert _check(widths, route, grad) == tuple(widths)
    assert [c[0] for c in lib.calls] == asked
    assert all(c[1] == widths and c[2] == 51 for c in lib.calls)


def test_auto_on_the_cpu_computes_a_wide_integrand_without_asking(fake_card):
    lib = fake_card()
    block = UMNNMAF(4, torch.Generator().manual_seed(0), embedding_s=6,
                    hidden_embedding=(8,), hidden_derivative=(129,), backend="auto")
    with torch.no_grad():
        z = block(torch.randn(3, 4))
    assert z.shape == (3, 4) and bool(torch.isfinite(z).all())
    assert lib.calls == []
