"""What the kernel route does with an integrand that a staged kernel pair
cannot take.

On the card, under ``backend="kernel"`` and ``"auto"`` alike, the wrapper asks
each staged kernel's own C helper (``umnn_integrand_{fwd,bwd}[_p2|_p4]_smem_bytes``)
before any launch. Where one refuses the widths (-1: past its MAX_WIDTH or
MAX_LAYERS) or asks for more shared memory than the card gives a block, the
call, forward and backward alike, goes to the streamed pair
(``csrc/integrand_wide.cu``) and launches nothing else; a set that both
helpers take stays on its staged pair. The CUDA library cannot be built here,
so its helpers and launchers are stubbed with the limits of the kernels'
sources, and the wrapper is driven on CPU tensors as if they lay on the card;
on the card ``chip_smoke.py``'s phases ``kernel`` and ``wide`` hold the same
against the real ones.
"""

import contextlib
import ctypes
from types import SimpleNamespace

import pytest
import torch

from umnn_tpu_torch.models.umnn_maf import UMNNMAF
from umnn_tpu_torch.ops import _build
from umnn_tpu_torch.ops import integrand_kernel as ik

OPTIN = 232448  # an H100 block's opt-in shared memory, in bytes
MNIST = [31, 100, 50, 50, 50, 50, 1]
# widest input or hidden layer each staged pair takes (the unpacked pair
# bounds its hidden layers only), and MAX_LAYERS of csrc/common.cuh
WIDTH_LIMITS = {"": 128, "_p2": 64, "_p4": 32}
MAX_LAYERS = 8


class FakeLibrary:
    """The kernels' C helpers and launchers. A staged helper gives -1 past
    its pair's width limit or MAX_LAYERS, 1 MB (past the card's limit) for
    the kernels listed in ``too_big``, else 4 bytes per weight and per K x
    width. Records every helper call and every launch."""

    def __init__(self, too_big=()):
        self.calls, self.launched = [], []
        self.too_big = set(too_big)
        for suffix, limit in WIDTH_LIMITS.items():
            for kind in ("fwd", "bwd"):
                name = f"umnn_integrand_{kind}{suffix}"
                setattr(self, f"{name}_smem_bytes", self._helper(kind + suffix, suffix, limit))
                setattr(self, name, self._launcher(f"integrand_{kind}{suffix}"))
            setattr(self, f"umnn_integrand_bwd{suffix}_grid", lambda *args: 1)
        for kind in ("fwd", "bwd"):
            setattr(self, f"umnn_integrand_{kind}_wide", self._launcher(f"integrand_{kind}_wide"))

    def _helper(self, kernel, suffix, limit):
        def smem_bytes(K, ptr, n_layers):
            widths = list(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int))[: n_layers + 1])
            self.calls.append((kernel, widths, K))
            bounded = widths[1:-1] if suffix == "" else widths[:-1]
            if n_layers > MAX_LAYERS or max(bounded) > limit:
                return -1
            if kernel in self.too_big:
                return 1 << 20
            return 4 * sum(a * b for a, b in zip(widths[:-1], widths[1:])) + 4 * K * max(widths)
        return smem_bytes

    def _launcher(self, kernel):
        def launch(*args):
            self.launched.append(kernel)
            return 0
        return launch

    def umnn_integrand_wide_scratch_floats(self, rows, K, ptr, n_layers):
        return 4


@pytest.fixture
def fake_card(monkeypatch):
    """The stubbed library, and the wrapper taking CPU tensors for CUDA ones."""
    def install(**kw):
        lib = FakeLibrary(**kw)
        monkeypatch.setattr(_build, "load_library", lambda: lib)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda device: SimpleNamespace(shared_memory_per_block_optin=OPTIN))
        on_card = ik._on_card
        monkeypatch.setattr(ik, "_on_card", lambda *args: on_card(*args) or True)
        monkeypatch.setattr(ik, "_on", lambda device: contextlib.nullcontext(0))
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


def _check(widths, route=""):
    ws, bs, x, h, nodes, ccw = _inputs(widths)
    return ik._check(ws, bs, x, h, nodes, ccw, [x, h, nodes, ccw, *ws, *bs], route)


def _launches(lib, widths, grad, **route):
    """The kernels one call of the public wrapper launches, through the
    autograd Function's forward and, where ``grad``, its backward."""
    ws, bs, x, h, nodes, ccw = _inputs(widths)
    ws = [w.requires_grad_(grad) for w in ws]
    z = ik.fused_cc_integral(ws, bs, x, h, nodes, ccw, **route)
    if grad:
        torch.autograd.grad(z.sum(), ws)
    return lib.launched


@pytest.mark.parametrize("widths, too_big, grad, asked", [
    ([31, 129, 1], (), False, ["fwd"]),
    ([31, 100, 129, 1], (), True, ["fwd"]),
    ([31, 128, 128, 1], ("fwd",), False, ["fwd"]),
    ([31, 128, 128, 1], ("bwd",), False, ["fwd", "bwd"]),
], ids=["w129", "w100_129_grad", "fwd_past_the_card", "bwd_past_the_card"])
def test_a_refused_integrand_takes_the_streamed_pair_and_does_not_raise(
        fake_card, widths, too_big, grad, asked):
    """A set a staged helper refuses no longer raises: the call goes to the
    streamed pair, forward and backward alike (also a forward alone whose
    backward the card refuses), after asking only the helpers it needed,
    and launches nothing else."""
    lib = fake_card(too_big=too_big)
    assert _check(widths) == (tuple(widths), "_wide")
    assert [c[0] for c in lib.calls] == asked
    want = ["integrand_fwd_wide"] + ["integrand_bwd_wide"] * grad
    assert _launches(lib, widths, grad) == want


@pytest.mark.parametrize("widths, route, grad, asked", [
    (MNIST, "", False, ["fwd", "bwd"]),
    (MNIST, "", True, ["fwd", "bwd"]),
    ([31, 128, 128, 76, 1], "", True, ["fwd", "bwd"]),
    ([31, 50, 50, 50, 50, 1], "_p2", True, ["fwd_p2", "bwd_p2"]),
], ids=["mnist", "mnist_grad", "w128_128_76_grad", "calibration_p2_grad"])
def test_an_integrand_both_helpers_take_passes_with_its_widths(fake_card, widths, route, grad,
                                                               asked):
    """A set both helpers take stays on its staged pair; both are asked,
    a forward alone too."""
    lib = fake_card()
    assert _check(widths, route) == (tuple(widths), route)
    assert [c[0] for c in lib.calls] == asked
    assert all(c[1] == widths and c[2] == 51 for c in lib.calls)
    launched = _launches(lib, widths, grad)
    assert launched == [f"integrand_fwd{route}"] + [f"integrand_bwd{route}"] * grad


@pytest.mark.parametrize("widths, route", [
    ([31] + [64] * 8 + [1], "_p2"),
    ([11] + [24] * 8 + [1], "_p4"),
    ([31] + [100] * 8 + [1], ""),
], ids=["nine_64_wide_layers_pack2", "nine_24_wide_layers_pack4", "nine_100_wide_layers"])
def test_more_layers_than_max_layers_go_to_the_streamed_pair(fake_card, widths, route):
    """Nine layers: auto picks the pair JAX's auto would, whose helpers
    refuse them past MAX_LAYERS; the training step runs on the streamed
    pair alone."""
    lib = fake_card()
    assert ik._route(_inputs(widths)[0], None, None) == route
    assert _check(widths, route) == (tuple(widths), "_wide")
    assert _launches(lib, widths, True) == ["integrand_fwd_wide", "integrand_bwd_wide"]


def test_the_backward_entry_point_takes_the_streamed_pair_too(fake_card):
    lib = fake_card()
    ws, bs, x, h, nodes, ccw = _inputs([31, 129, 1])
    dws, dbs, dx, dh, S = ik.fused_cc_integral_bwd(ws, bs, x, h, nodes, ccw, torch.ones(3))
    assert lib.launched == ["integrand_bwd_wide"]
    assert [d.shape for d in dws] == [w.shape for w in ws] and dx.shape == x.shape
    assert dh.shape == h.shape and S.shape == x.shape


def test_the_streamed_backward_reads_each_w_in_place(fake_card, monkeypatch):
    """Its dz and dh products read each layer's W at the layer's own address
    (nn.Linear's [dout, din] layout, nothing copied), beside the packed W^T
    and b of the forward: what the launcher is handed, read during the call."""
    lib = fake_card()
    seen = []

    def launch(x, h, params, weights, *args):
        floats = lambda ptr, n: torch.tensor(list((ctypes.c_float * n).from_address(ptr)))
        seen.append((floats(params, n_params), list(weights)))
        return 0

    monkeypatch.setattr(lib, "umnn_integrand_bwd_wide", launch)
    ws, bs, x, h, nodes, ccw = _inputs([7, 129, 5, 1])
    n_params = sum(w.numel() + b.numel() for w, b in zip(ws, bs))
    ik.fused_cc_integral_bwd(ws, bs, x, h, nodes, ccw, torch.ones(3))
    assert len(seen) == 1
    params, weights = seen[0]
    assert weights == [w.data_ptr() for w in ws]
    assert torch.equal(params, torch.cat([t.reshape(-1) for w, b in zip(ws, bs)
                                          for t in (w.T.contiguous(), b)]))


def test_auto_on_the_cpu_computes_a_wide_integrand_without_asking(fake_card):
    lib = fake_card()
    block = UMNNMAF(4, torch.Generator().manual_seed(0), embedding_s=6,
                    hidden_embedding=(8,), hidden_derivative=(129,), backend="auto",
                    device="cpu")
    with torch.no_grad():
        z = block(torch.randn(3, 4))
    assert z.shape == (3, 4) and bool(torch.isfinite(z).all())
    assert lib.calls == []
