"""The port's known-entropy calibration driver against the JAX package's
`examples/train_calibration.py`, at tiny sizes on the CPU.

The ground truth is a copy and must agree exactly: samples bit for bit from
the same RandomState, the entropy and its Monte Carlo error to 1e-12. One
epoch of the port's loop against one of JAX's ``make_train_step`` loop, on
the same initial weights and the same numpy batches, both on the Leibniz
route: train and valid NLL within rtol 1e-4 (eight Adam steps at lr 1e-3;
the two optimizers differ by float32 rounding of Adam's bias correction,
see `tests/test_torch_training.py`).
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from umnn_tpu_torch.bridge import load_jax_flow_params
from umnn_tpu_torch.examples import train_calibration as tc
from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.training import loops as tl

ROOT = Path(__file__).resolve().parent.parent
TINY = (
    "-device cpu -d 3 -nb_flow 2 -hidden_embedding 16 -hidden_derivative 8 8 "
    "-embedding_s 2 -nb_steps 10 -b_size 50 -n_train 200 -n_eval 120 -nb_epoch 2"
)


@pytest.fixture(scope="module")
def jax_driver():
    spec = importlib.util.spec_from_file_location(
        "jax_train_calibration", ROOT / "examples" / "train_calibration.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ground_truth_matches_jax(jax_driver):
    sample, h, se = tc.make_ground_truth(6, 1000)
    jsample, jh, jse = jax_driver.make_ground_truth(6, 1000)
    assert abs(h - jh) <= 1e-12 and abs(se - jse) <= 1e-12
    np.testing.assert_array_equal(
        sample(np.random.RandomState(1), 500), jsample(np.random.RandomState(1), 500)
    )


def _run(argv, capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rc = tc.main(argv)
    finally:
        torch.set_num_threads(threads)
    return rc, capsys.readouterr().out.splitlines()


def test_driver_runs_at_a_tiny_size(tmp_path, capsys):
    rc, lines = _run(TINY.split() + ["-folder", str(tmp_path)], capsys)
    result = json.loads(lines[-1])
    assert set(result) == {"d", "test_nll", "h_true", "entropy_gap_nats", "gate", "pass"}
    assert result["d"] == 3 and np.isfinite(result["test_nll"])
    assert result["entropy_gap_nats"] == pytest.approx(result["test_nll"] - result["h_true"])
    assert rc == (0 if result["pass"] else 1)
    assert {p.name for p in tmp_path.iterdir()} == {"train.log", "metrics.jsonl", "args.json"}
    tags = [json.loads(l)["tag"] for l in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert tags == ["train_nll", "valid_nll", "valid_gap"] * 2
    assert json.loads((tmp_path / "args.json").read_text())["nb_epoch"] == 2
    assert "FINAL: test NLL" in (tmp_path / "train.log").read_text()


def test_final_test_nll_uses_the_best_valid_parameters(tmp_path, capsys, monkeypatch):
    """Epoch 0 is made the best by the valid scores the loop sees; the final
    test NLL must come from epoch 0's parameters, not the last epoch's."""
    calls, real = [], tc.evaluate

    def recording(model, x, b_size, device):
        value = real(model, x, b_size, device)
        calls.append(({k: v.clone() for k, v in model.state_dict().items()}, value))
        return value - 100.0 if len(calls) == 1 else value

    monkeypatch.setattr(tc, "evaluate", recording)
    _, lines = _run(TINY.split() + ["-folder", str(tmp_path)], capsys)
    assert len(calls) == 3  # valid at epochs 0 and 1, then test
    (epoch0, _), (epoch1, _), (final, test_nll) = calls
    assert all(torch.equal(final[k], epoch0[k]) for k in final)
    assert any(not torch.equal(final[k], epoch1[k]) for k in final)
    assert json.loads(lines[-1])["test_nll"] == test_nll


CFG = dict(nb_flow=2, nb_in=3, hidden_derivative=(8, 8), hidden_embedding=(16,),
           embedding_s=2, nb_steps=10)
B_SIZE = 50


def test_one_epoch_matches_jax_train_step_loop(jax_driver):
    import jax
    import jax.numpy as jnp

    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow
    from umnn_tpu.training.loops import batch_iter, make_optimizer, make_train_step

    sample, _, _ = tc.make_ground_truth(3, 1000)
    rng = np.random.RandomState(1)
    trn, val = sample(rng, 400), sample(rng, 120)

    jflow = JaxFlow(**CFG, backend="xla")
    params = jflow.init(jax.random.PRNGKey(3))
    flow = load_jax_flow_params(
        UMNNMAFFlow(**CFG, backend="torch", device="cpu"),
        [jax.tree_util.tree_map(np.asarray, p) for p in params],
    )

    optimizer = make_optimizer("adam", lr=1e-3, weight_decay=1e-2, grad_clip=1.0)
    opt_state = optimizer.init(params)
    step_j = make_train_step(lambda p, b: -jnp.mean(jflow.compute_ll(p, b)[0]), optimizer)
    losses = []
    for b in batch_iter(trn, B_SIZE, np.random.RandomState(4)):
        params, opt_state, loss = step_j(params, opt_state, jnp.asarray(b))
        losses.append(loss)
    train_j = float(jnp.stack(losses).mean())
    valid_j = float(np.mean(-np.asarray(jflow.compute_ll(params, jnp.asarray(val))[0])))

    opt = tl.make_optimizer(flow.parameters(), "adam", 1e-3, 1e-2, grad_clip=1.0)
    step = tl.make_train_step(lambda b: -flow.compute_ll(b)[0].mean(), opt)
    train = tc.train_epoch(step, trn, B_SIZE, np.random.RandomState(4), "cpu")
    valid = tc.evaluate(flow, val, B_SIZE, "cpu")

    assert len(losses) == len(trn) // B_SIZE
    np.testing.assert_allclose(train, train_j, rtol=1e-4)
    np.testing.assert_allclose(valid, valid_j, rtol=1e-4)


def test_driver_without_device_raises_when_cuda_is_absent(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in TINY.split() if a not in ("-device", "cpu")] + ["-folder", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.main(argv)
