"""The toy driver's first epoch, the port's against the JAX package's, from
the same initial parameters.

The port's 6-epoch toy runs start at test NLL 6.7678 (8gaussians) and
5.8203 (conditionnal8gaussians), JAX's at 5.3267 and 5.2626. The data draws
match bit for bit (``tests/test_torch_toy.py``) and the port draws its own
initial weights. Here JAX's ``examples/train_toy.py`` runs one epoch at the
verify command's widths, and the port's driver runs the same epoch from
JAX's initial parameters (its flow built as usual, then overwritten through
the bridge): their train and test NLL agree. So the gap after one epoch is
the initial draw, not a fault of the port.
"""

import importlib.util
import io
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from umnn_tpu_torch.bridge import load_jax_flow_params
from umnn_tpu_torch.examples import train_toy

ROOT = Path(__file__).resolve().parent.parent
# the verify command's widths (chip_smoke.py TOY_ARGV), one epoch
ARGV = "-nb_epoch 1 -nb_steps 16 -b_size 256 -hidden_embedding 64 64 -hidden_derivative 32 32"
# the JAX driver prints 4 decimals; the two loops agree to about 1e-6
NLL_ATOL = 2e-4


def _jax_epoch(data: str, monkeypatch) -> tuple:
    spec = importlib.util.spec_from_file_location("jax_train_toy", ROOT / "examples" / "train_toy.py")
    driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(driver)
    monkeypatch.setattr(sys, "argv", ["train_toy.py", "-data", data, *ARGV.split()])
    out = io.StringIO()
    with redirect_stdout(out):
        driver.main()
    line = next(l for l in out.getvalue().splitlines() if l.startswith("epoch"))
    # f"epoch {epoch:3d}  train NLL {:8.4f}  test NLL {:8.4f}  ({:.2f}s)"
    fields = line.split()
    return float(fields[4]), float(fields[7])


def _jax_init(cond_in: int) -> list:
    import jax

    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow

    # examples/train_toy.py's model and its init key, PRNGKey(seed = 0)
    flow = JaxFlow(nb_flow=1, nb_in=2, hidden_derivative=(32, 32), hidden_embedding=(64, 64),
                   embedding_s=10, nb_steps=16, cond_in=cond_in)
    return [jax.tree_util.tree_map(np.asarray, p) for p in flow.init(jax.random.PRNGKey(0))]


@pytest.mark.parametrize("data", ["8gaussians", "conditionnal8gaussians"])
def test_first_epoch_matches_jax_from_jax_initial_parameters(data, monkeypatch):
    jax_train, jax_test = _jax_epoch(data, monkeypatch)
    params = _jax_init(train_toy.COND_IN if data == "conditionnal8gaussians" else 0)
    build = train_toy.UMNNMAFFlow
    monkeypatch.setattr(train_toy, "UMNNMAFFlow",
                        lambda **kw: load_jax_flow_params(build(**kw), params))
    history = train_toy.main(f"-data {data} {ARGV} -device cpu".split())
    np.testing.assert_allclose(history["train_nll"], [jax_train], rtol=0, atol=NLL_ATOL)
    np.testing.assert_allclose(history["test_nll"], [jax_test], rtol=0, atol=NLL_ATOL)
