"""The port stands alone: no JAX, no umnn_tpu, no quiet fall-back to the CPU.

Each check runs in a fresh interpreter in which ``jax``, ``jaxlib`` and
``umnn_tpu`` cannot be imported and no CUDA device is visible.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "umnn_tpu_torch"
BLOCKED = ("jax", "jaxlib", "umnn_tpu")

BLOCKER = f"""
import sys

class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError(f"blocked in this test: {{name}}")
        return None

sys.meta_path.insert(0, _Blocker())
sys.path.insert(0, {str(ROOT)!r})
"""


def _run(body: str, cwd: Path = ROOT) -> subprocess.CompletedProcess:
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run(
        [sys.executable, "-c", BLOCKER + body],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def _ok(proc: subprocess.CompletedProcess) -> str:
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_blocker_blocks_jax():
    proc = _run("import jax")
    assert proc.returncode != 0 and "blocked in this test" in proc.stderr


def test_every_module_imports_without_jax():
    out = _ok(_run("""
import importlib, pkgutil
import umnn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(umnn_tpu_torch.__path__, "umnn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "umnn_tpu")]
print(len(names))
"""))
    assert int(out.strip()) >= 14


def test_chip_smoke_imports_without_running():
    out = _ok(_run("""
import importlib.util
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print(callable(mod.main))
"""))
    assert out.strip() == "True"


def test_entry_point_without_device_raises_when_cuda_is_absent():
    out = _ok(_run("""
import torch
from umnn_tpu_torch import UMNNMAFFlow
assert not torch.cuda.is_available()
try:
    UMNNMAFFlow(nb_flow=1, nb_in=3, hidden_derivative=(8,), hidden_embedding=(8,), embedding_s=2)
except RuntimeError as e:
    print("raised:", e)
flow = UMNNMAFFlow(nb_flow=1, nb_in=3, hidden_derivative=(8,), hidden_embedding=(8,),
                   embedding_s=2, device="cpu")
print(flow.blocks[0].scaling.device)
"""))
    assert "raised: no CUDA device" in out
    assert out.strip().endswith("cpu")


def test_kernel_wrapper_on_cpu_tensors_leaves_the_launch_count_at_zero():
    out = _ok(_run("""
import torch
from umnn_tpu_torch.ops import integrand_kernel as ik
from umnn_tpu_torch.ops.quadrature import cc_tensors
from umnn_tpu_torch import UMNNMAFFlow
g = torch.Generator().manual_seed(0)
ws = [torch.randn(8, 4, generator=g), torch.randn(1, 8, generator=g)]
bs = [torch.randn(8, generator=g), torch.randn(1, generator=g)]
nodes, ccw = cc_tensors(10, "cpu")
z = ik.fused_cc_integral(ws, bs, torch.rand(5), torch.randn(5, 3), nodes, ccw)
flow = UMNNMAFFlow(nb_flow=2, nb_in=3, hidden_derivative=(8,), hidden_embedding=(8,),
                   embedding_s=2, backend="kernel", device="cpu")
with torch.no_grad():
    flow.compute_bpp(torch.randn(4, 3))
print(sum(ik.LAUNCHES.values()), tuple(z.shape))
"""))
    assert out.strip() == "0 (5,)"


def test_training_driver_runs_without_jax_and_refuses_a_missing_card():
    proc = _run("""
import runpy
sys.argv = ["train_mnist", "-nb_flow", "1", "-nb_epoch", "1"]
runpy.run_module("umnn_tpu_torch.examples.train_mnist", run_name="__main__")
""")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "blocked in this test" not in proc.stderr


def test_calibration_driver_runs_without_jax_and_refuses_a_missing_card(tmp_path):
    proc = _run(f"""
import runpy
sys.argv = ["train_calibration", "-nb_flow", "1", "-nb_epoch", "1", "-folder", {str(tmp_path)!r}]
runpy.run_module("umnn_tpu_torch.examples.train_calibration", run_name="__main__")
""")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "blocked in this test" not in proc.stderr
    assert not any(tmp_path.iterdir())  # refused before writing anything


def test_toy_driver_runs_without_jax_and_refuses_a_missing_card():
    proc = _run("""
import runpy
sys.argv = ["train_toy", "-data", "conditionnal8gaussians", "-nb_epoch", "1"]
runpy.run_module("umnn_tpu_torch.examples.train_toy", run_name="__main__")
""")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "blocked in this test" not in proc.stderr


def test_uci_driver_runs_without_jax_and_refuses_a_missing_card(tmp_path):
    proc = _run(f"""
import runpy
sys.argv = ["train_uci", "-data", "bsds300", "-nb_epoch", "1", "-folder", {str(tmp_path)!r}]
runpy.run_module("umnn_tpu_torch.examples.train_uci", run_name="__main__")
""")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "blocked in this test" not in proc.stderr
    assert not any(tmp_path.iterdir())  # refused before writing anything


def test_uci_slice_trains_on_the_cpu_without_jax(tmp_path):
    """The new modules import, and the UCI driver trains, resumes and
    writes a snapshot, all with jax and umnn_tpu blocked."""
    out = _ok(_run(f"""
import json
from umnn_tpu_torch.data import uci
from umnn_tpu_torch.examples import train_uci
from umnn_tpu_torch.training import checkpoint, resume
from umnn_tpu_torch.utils import validity
argv = ("-device cpu -data miniboone -synthetic -synthetic_rows 600 -nb_flow 1 "
        "-hidden_embedding 8 -hidden_derivative 4 4 -embedding_s 2 -nb_steps 0 -b_size 50 "
        "-steps_per_epoch 2 -Lipshitz 1.5 -folder {tmp_path}").split()
assert train_uci.main(argv + ["-nb_epoch", "1"]) == 0
assert train_uci.main(argv + ["-nb_epoch", "2", "-load"]) == 0
flow = train_uci.UMNNMAFFlow(nb_flow=1, nb_in=43, hidden_derivative=(4, 4),
                             hidden_embedding=(8,), embedding_s=2, device="cpu")
checkpoint.save_params_npz({str(tmp_path / "s.npz")!r}, flow)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "umnn_tpu")]
print(json.dumps(sorted(p.name for p in (train_uci.Path({str(tmp_path)!r}) / "miniboone").iterdir())))
"""))
    assert json.loads(out.strip().splitlines()[-1]) == ["args.json", "ckpt", "metrics.jsonl", "train.log"]


def test_source_scan_covers_the_uci_slice():
    scanned = {p.relative_to(ROOT).as_posix() for p in PACKAGE.rglob("*.py")}
    assert {
        "umnn_tpu_torch/data/uci.py", "umnn_tpu_torch/training/checkpoint.py",
        "umnn_tpu_torch/training/resume.py", "umnn_tpu_torch/utils/validity.py",
        "umnn_tpu_torch/examples/train_uci.py", "umnn_tpu_torch/models/umnn_maf.py",
        "umnn_tpu_torch/training/loops.py",
    } <= scanned


def test_monotonic_driver_runs_without_jax_and_refuses_a_missing_card():
    proc = _run("""
import runpy
sys.argv = ["train_monotonic", "-nb_epoch", "1"]
runpy.run_module("umnn_tpu_torch.examples.train_monotonic", run_name="__main__")
""")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "blocked in this test" not in proc.stderr


def test_monotonic_slice_runs_on_the_cpu_without_jax():
    """The monotonic driver, the MNIST stand-in, the CC solver and the
    accumulation step, with jax and umnn_tpu blocked."""
    out = _ok(_run("""
import torch
from umnn_tpu_torch.data import download, images
from umnn_tpu_torch.examples import train_monotonic
from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.training import loops
from umnn_tpu_torch.utils import profiling, visualize
from umnn_tpu_torch.utils.logging import AverageMeter
rc = train_monotonic.main("-device cpu -nb_epoch 2 -nb_steps 4 -b_size 16".split())
data = images.load_mnist_flow(synthetic=True)
flow = UMNNMAFFlow(nb_flow=1, nb_in=3, hidden_derivative=(4,), hidden_embedding=(4,),
                   embedding_s=2, solver="CC", device="cpu")
step = loops.make_accum_train_step(lambda x: -flow.compute_ll(x)[0].mean(),
                                   loops.make_optimizer(flow.parameters()), 2)
loss = step(torch.randn(4, 3))
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "umnn_tpu")]
print(rc, len(data.trn_x), bool(torch.isfinite(loss)))
"""))
    assert out.strip().splitlines()[-1] == "0 1000 True"


# each call with "{dev}" where a device argument may go
PUBLIC_CONSTRUCTORS = {
    "torch_linear_init": "core.torch_linear_init(gen, 3, 2{dev})",
    "MLP": "core.MLP([3, 4, 1], gen{dev})",
    "MADE": "made.MADE(3, (6,), 6, gen{dev})",
    "ConditionalMADE": "made.ConditionalMADE(3, 2, (6,), 10, gen{dev})",
    "IntegrandNetwork": "umnn_maf.IntegrandNetwork(3, 3, (4,), gen{dev})",
    "EmbeddingNetwork": "umnn_maf.EmbeddingNetwork(3, (6,), (4,), 2, gen{dev})",
    "UMNNMAF": "umnn_maf.UMNNMAF(3, gen, 2, (6,), (4,){dev})",
    "UMNNMAFFlow": "flow.UMNNMAFFlow(nb_in=3, hidden_embedding=(6,), hidden_derivative=(4,){dev})",
    "IntegrandNN": "monotonic.IntegrandNN(3, (4,), gen{dev})",
    "MonotonicNN": "monotonic.MonotonicNN(3, (4,){dev})",
    "GatedConv2d": "vlayers.GatedConv2d(1, 2, 3, gen{dev})",
    "GatedConvTranspose2d": "vlayers.GatedConvTranspose2d(2, 1, 3, gen, 2, 1, 1{dev})",
    "MaskedLinear": "vlayers.MaskedLinear(2, 4, gen{dev})",
    "MaskedConv2d": "vlayers.MaskedConv2d(2, 4, gen{dev})",
    "IAF": "vflows.IAF(2, h_size=4{dev})",
    "MMAF": "vflows.MMAF(2, 1, 3, (4,), (6,), 2, 5{dev})",
    **{f"vae.{name}": f"vae.VAE_FAMILIES[{name!r}](z_size=2{{dev}})"
       for name in ("no_flow", "planar", "orthogonal", "householder", "triangular", "iaf",
                    "MMAF")},
}


@pytest.mark.parametrize("name", list(PUBLIC_CONSTRUCTORS))
def test_public_constructor_without_device_raises_when_cuda_is_absent(name, monkeypatch):
    """Each building block runs on the card unless the caller names the
    CPU; with no card and no ``device`` it raises, and with
    ``device="cpu"`` it builds there."""
    import torch

    from umnn_tpu_torch.models import flow, monotonic, umnn_maf
    from umnn_tpu_torch.models.vae import flows as vflows
    from umnn_tpu_torch.models.vae import layers as vlayers
    from umnn_tpu_torch.models.vae import vae
    from umnn_tpu_torch.nn import core, made

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scope = {"core": core, "made": made, "umnn_maf": umnn_maf, "flow": flow,
             "monotonic": monotonic, "vflows": vflows, "vlayers": vlayers, "vae": vae,
             "gen": torch.Generator().manual_seed(0)}
    call = PUBLIC_CONSTRUCTORS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval(call.format(dev=""), scope)
    built = eval(call.format(dev=", device='cpu'"), scope)
    assert {p.device.type for p in built.parameters()} == {"cpu"}


def test_source_scan_covers_the_monotonic_slice():
    scanned = {p.relative_to(ROOT).as_posix() for p in PACKAGE.rglob("*.py")}
    assert {
        "umnn_tpu_torch/models/monotonic.py", "umnn_tpu_torch/examples/train_monotonic.py",
        "umnn_tpu_torch/data/images.py", "umnn_tpu_torch/data/download.py",
        "umnn_tpu_torch/utils/profiling.py", "umnn_tpu_torch/utils/visualize.py",
        "umnn_tpu_torch/utils/logging.py", "umnn_tpu_torch/ops/quadrature.py",
        "umnn_tpu_torch/bridge.py",
    } <= scanned


def test_vae_driver_runs_without_jax_and_refuses_a_missing_card(tmp_path):
    proc = _run(f"""
import runpy
sys.argv = ["train_vae", "-flow", "MMAF", "-synthetic", "-nb_epoch", "1", "-folder", {str(tmp_path)!r}]
runpy.run_module("umnn_tpu_torch.examples.train_vae", run_name="__main__")
""")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "blocked in this test" not in proc.stderr
    assert not any(tmp_path.iterdir())  # refused before writing anything


def test_multihost_step_refuses_a_missing_card():
    proc = _run("""
from umnn_tpu_torch.parallel import multihost
multihost.run_multihost_step(1, 0)
""")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "blocked in this test" not in proc.stderr


def test_vae_slice_runs_on_the_cpu_without_jax(tmp_path):
    """The VAE stack and the data-parallel layer import and run, with jax and
    umnn_tpu blocked: the driver for one epoch, the one-process step."""
    out = _ok(_run(f"""
from umnn_tpu_torch.examples import train_vae
from umnn_tpu_torch.models.vae import distributions, flows, iwae, layers, losses, vae
from umnn_tpu_torch.parallel import mesh, multihost
argv = ("-device cpu -synthetic -flow iaf -z_size 4 -made_h_size 8 -num_flows 1 -nb_epoch 1 "
        "-iwae_samples 4 -iwae_minibatch 2 -iwae_test_points 2 -plot_every 0 "
        "-folder {tmp_path}").split()
rc = train_vae.main(argv)
res = multihost.run_multihost_step(1, 0, device="cpu")
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "umnn_tpu")]
print(rc, len(res["losses"]))
"""))
    assert out.strip().splitlines()[-1] == "0 3"


def test_source_scan_covers_the_vae_slice():
    scanned = {p.relative_to(ROOT).as_posix() for p in PACKAGE.rglob("*.py")}
    assert {
        f"umnn_tpu_torch/models/vae/{m}.py"
        for m in ("distributions", "layers", "flows", "vae", "losses", "iwae")
    } | {
        "umnn_tpu_torch/examples/train_vae.py", "umnn_tpu_torch/parallel/mesh.py",
        "umnn_tpu_torch/parallel/multihost.py",
    } <= scanned


def test_source_scan_covers_the_toy_slice():
    scanned = {p.relative_to(ROOT).as_posix() for p in PACKAGE.rglob("*.py")}
    assert {
        "umnn_tpu_torch/data/toy.py", "umnn_tpu_torch/nn/made.py",
        "umnn_tpu_torch/examples/train_toy.py",
    } <= scanned


def test_chip_smoke_exits_non_zero_without_cuda():
    proc = _run("import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": ""},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_import_of_jax_or_umnn_tpu_anywhere_in_the_source(path):
    """Also the imports inside functions, which an import run never reaches."""
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in BLOCKED]
    assert not bad, f"{path.name} imports {bad}"
