"""The port's UCI driver against the JAX package's `examples/train_uci.py`,
at a tiny size on the CPU.

The driver runs two epochs and writes the JAX driver's files and final
line; ``-load`` resumes at the saved epoch with the saved parameters and
learning rate; ``-test`` reports every best tag; ``-load_npz`` evaluates a
snapshot the JAX package wrote, against JAX's own evaluation of it
(rtol 1e-5); ``-Lipshitz`` keeps every integrand layer within its bound.
One randomized-steps epoch of the port's loop against JAX's
``make_train_step`` loop, on the same initial weights, batches and step
draws, both on the Leibniz route: train and valid NLL within rtol 1e-4
(Adam at lr 1e-3; see `tests/test_torch_training.py` for the optimizers'
one known float32 difference).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from umnn_tpu_torch.bridge import load_jax_flow_params
from umnn_tpu_torch.data.uci import load_uci
from umnn_tpu_torch.examples import train_uci as tu
from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.ops.quadrature import padded_cc_quadrature
from umnn_tpu_torch.training import loops as tl

TINY = (
    "-device cpu -data power -synthetic -synthetic_rows 2000 -nb_flow 2 -hidden_embedding 16 "
    "-hidden_derivative 8 8 -embedding_s 2 -nb_steps 0 -b_size 100 -steps_per_epoch 4"
).split()
CFG = dict(nb_flow=2, nb_in=6, hidden_derivative=(8, 8), hidden_embedding=(16,),
           embedding_s=2, nb_steps=100)
LIP_TOL = 0.25  # power iteration's under-estimate, see tests/test_torch_lipschitz.py


def _run(argv, capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rc = tu.main(argv)
    finally:
        torch.set_num_threads(threads)
    return rc, capsys.readouterr().out.splitlines()


def _train(folder, capsys, epochs=2, extra=()):
    rc, lines = _run(TINY + ["-folder", str(folder), "-nb_epoch", str(epochs), *extra], capsys)
    assert rc == 0
    return json.loads(lines[-1]), lines


def test_driver_runs_two_epochs_in_jax_format(tmp_path, capsys):
    result, lines = _train(tmp_path, capsys)
    run = tmp_path / "power"
    assert set(result) == {"dataset", "test_nll", "validity"}
    assert result["dataset"] == "synthetic-power" and np.isfinite(result["test_nll"])
    assert set(result["validity"]) == {"nll", "node_gap", "bf16_gap", "n_nonfinite", "rows", "ok"}
    assert result["validity"]["rows"] == 180 and result["validity"]["n_nonfinite"] == 0
    assert {p.name for p in run.iterdir()} == {"train.log", "metrics.jsonl", "args.json", "ckpt"}
    assert {p.name for p in (run / "ckpt").iterdir()} == {
        "steps", "history.json", "best_train", "best_valid", "best_train_valid"}
    assert sorted(int(p.name) for p in (run / "ckpt" / "steps").iterdir()) == [0, 2]
    tags = [json.loads(l)["tag"] for l in (run / "metrics.jsonl").read_text().splitlines()]
    assert tags == ["train_nll", "valid_nll"] * 2
    history = json.loads((run / "ckpt" / "history.json").read_text())
    assert len(history["valid"]) == 2 and history["test"] == [result["test_nll"]]
    assert json.loads((run / "args.json").read_text())["nb_epoch"] == 2
    log = (run / "train.log").read_text()
    assert "dataset synthetic-power: dims=6 train=1620 valid=180 test=200" in log
    assert "FINAL test NLL (best-valid params)" in log and "validity: valid-slice NLL" in log
    assert [l.split()[1] for l in lines if l.startswith("epoch")] == ["0", "1"]


def test_load_resumes_at_the_saved_epoch(tmp_path, capsys, monkeypatch):
    _train(tmp_path, capsys)
    saved = torch.load(tmp_path / "power" / "ckpt" / "steps" / "2" / "state.pt")
    seen = {}
    real = tu.resume_training_state

    def recording(ckpt, model, optimizer, **kw):
        out = real(ckpt, model, optimizer, **kw)
        seen["state"] = {k: v.clone() for k, v in model.state_dict().items()}
        seen["lr"], seen["start"] = optimizer.lr, out[1]
        return out

    monkeypatch.setattr(tu, "resume_training_state", recording)
    _train(tmp_path, capsys, epochs=3, extra=["-load", "-lr", "5e-4"])
    assert seen["start"] == 2
    assert seen["lr"] == saved["optimizer"]["param_groups"][0]["lr"] == 1e-3
    assert all(torch.equal(seen["state"][k], v) for k, v in saved["model"].items())
    run = tmp_path / "power"
    assert "resumed at epoch 2 (lr 0.001)" in (run / "train.log").read_text()
    steps = [json.loads(l)["step"] for l in (run / "metrics.jsonl").read_text().splitlines()]
    assert steps == [0, 0, 1, 1, 2, 2]
    history = json.loads((run / "ckpt" / "history.json").read_text())
    assert len(history["valid"]) == 3 and len(history["test"]) == 2


def test_test_mode_reports_every_tag(tmp_path, capsys):
    trained, _ = _train(tmp_path, capsys)
    rc, lines = _run(TINY + ["-folder", str(tmp_path), "-test"], capsys)
    result = json.loads(lines[-1])
    assert rc == 0 and result["mode"] == "test_only" and result["ckpt"] == "train"
    assert set(result["test_nll_by_ckpt"]) == {"train", "valid", "train_valid"}
    assert result["test_nll"] == result["test_nll_by_ckpt"]["train"]
    # the training run's final test NLL was taken on the same best-valid state
    assert result["test_nll_by_ckpt"]["valid"] == trained["test_nll"]
    assert (tmp_path / "power" / "args_eval.json").exists()
    rc, lines = _run(TINY + ["-folder", str(tmp_path / "empty"), "-test"], capsys)
    assert rc == 1 and "no best checkpoint found" in lines[-1]


def test_load_npz_evaluates_a_jax_snapshot(tmp_path, capsys):
    import jax
    import jax.numpy as jnp

    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow
    from umnn_tpu.ops.quadrature import padded_cc_quadrature as jax_padded
    from umnn_tpu.training.checkpoint import load_params_npz as jax_load
    from umnn_tpu.training.checkpoint import save_params_npz as jax_save

    jflow = JaxFlow(**CFG, backend="xla")
    init = jflow.init(jax.random.PRNGKey(9))
    path = jax_save(tmp_path / "snap.f16.npz", init)
    rc, lines = _run(TINY + ["-folder", str(tmp_path), "-test", "-load_npz", str(path)], capsys)
    result = json.loads(lines[-1])
    assert rc == 0 and set(result["test_nll_by_ckpt"]) == {"npz"} and result["ckpt"] == "npz"

    params = jax_load(path, init)  # the float16-rounded leaves
    tst = load_uci("power", synthetic=True, synthetic_rows=2000).tst
    nodes, weights = jax_padded(100, 100)
    nll = jax.jit(lambda p, x: -jnp.mean(jflow.compute_ll(p, x, nodes=nodes, weights=weights)[0]))
    want = float(nll(params, jnp.asarray(tst)))
    np.testing.assert_allclose(result["test_nll"], want, rtol=1e-5)


def test_lipschitz_run_keeps_every_integrand_layer_within_its_bound(tmp_path, capsys):
    def integrand_norms(folder, extra):
        _train(folder, capsys, epochs=1, extra=extra)
        state = torch.load(folder / "power" / "ckpt" / "steps" / "1" / "state.pt")["model"]
        return [float(torch.linalg.matrix_norm(v, 2)) for k, v in state.items()
                if ".integrand." in k and k.endswith("weight")]

    free = integrand_norms(tmp_path / "free", [])
    bound = integrand_norms(tmp_path / "bound", ["-Lipshitz", "0.6"])
    assert len(free) == len(bound) == 6
    assert sum(n > 0.6 * (1 + LIP_TOL) for n in free) >= 4  # unbounded, most layers are above
    assert max(bound) <= 0.6 * (1 + LIP_TOL)


def test_one_randomized_epoch_matches_jax_train_step_loop():
    import jax
    import jax.numpy as jnp

    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow
    from umnn_tpu.ops.quadrature import padded_cc_quadrature as jax_padded
    from umnn_tpu.training.loops import batch_iter, make_optimizer, make_train_step

    args = tu.parse_args(TINY)
    data = load_uci("power", synthetic=True, synthetic_rows=2000)
    jflow = JaxFlow(**CFG, backend="xla")
    params = jflow.init(jax.random.PRNGKey(3))
    flow = load_jax_flow_params(UMNNMAFFlow(**CFG, backend="torch", device="cpu"),
                                [jax.tree_util.tree_map(np.asarray, p) for p in params])

    def loss_j(p, b, nodes, weights):
        return -jnp.mean(jflow.compute_ll(p, b, nodes=nodes, weights=weights)[0])

    optimizer = make_optimizer("adam", lr=1e-3, weight_decay=1e-2, grad_clip=1.0)
    opt_state = optimizer.init(params)
    step_j = make_train_step(loss_j, optimizer)
    rng, losses, counts = np.random.RandomState(1), [], []
    for i, b in enumerate(batch_iter(data.trn, args.b_size, rng)):
        if i >= args.steps_per_epoch:
            break
        n_steps = 2 * rng.randint(5, 50)
        counts.append(n_steps)
        params, opt_state, loss = step_j(params, opt_state, jnp.asarray(b),
                                         *jax_padded(n_steps, tu.MAX_STEPS))
        losses.append(loss)
    train_j = float(jnp.stack(losses).mean())
    nodes, weights = jax_padded(100, tu.MAX_STEPS)
    valid_j = float(-jnp.mean(jflow.compute_ll(params, jnp.asarray(data.val), nodes=nodes,
                                               weights=weights)[0]))

    opt = tl.make_optimizer(flow.parameters(), "adam", 1e-3, 1e-2, grad_clip=1.0)

    def loss_fn(x, nodes, weights):
        return -flow.compute_ll(x, nodes=nodes, weights=weights)[0].mean()

    seen = []

    def recording(x, nodes, weights):
        seen.append(int((weights != 0).sum()) - 1)  # n steps: n + 1 weighted nodes
        return loss_fn(x, nodes, weights)

    step = tl.make_train_step(recording, opt)
    train = tl.finite_mean(tu.train_epoch(step, data.trn, args, np.random.RandomState(1),
                                          tu.MAX_STEPS, "cpu"))[0]
    eval_nodes = padded_cc_quadrature(100, tu.MAX_STEPS, "cpu")
    valid = tu.eval_split(flow, data.val, args.b_size, *eval_nodes, "cpu")

    assert len(losses) == args.steps_per_epoch and seen == counts and len(set(counts)) > 1
    np.testing.assert_allclose(train, train_j, rtol=1e-4)
    np.testing.assert_allclose(valid, valid_j, rtol=1e-4)


def test_driver_without_device_raises_when_cuda_is_absent(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in TINY if a not in ("-device", "cpu")] + ["-folder", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tu.main(argv)
    assert not any(Path(tmp_path).iterdir())
