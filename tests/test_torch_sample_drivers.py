"""The toy and MNIST drivers' sampling, generation and checkpoint flags, on
the CPU at a tiny size.

Toy: ``-sample`` inverts draws of a generator seeded ``seed + 1`` by
bisection and prints JAX's ``sampled ...`` line; ``-folder`` writes the
samples and checkpoints every ``-ckpt_every`` epochs and after the last;
``-load`` resumes at the epoch after the latest. MNIST: ``-gen`` with
``-temp_sweep`` inverts the temperature ladder's rows by Newton and saves
``logit_back`` of them; ``-load`` resumes with the checkpointed learning
rate unless ``-force_lr`` replaces it; ``-load_npz`` takes a float16
snapshot JAX's ``save_params_npz`` wrote; ``-Lipshitz`` projects the
integrand's layers.
"""

import json

import numpy as np
import pytest
import torch

from umnn_tpu_torch.data.images import logit_back
from umnn_tpu_torch.examples import train_mnist, train_toy
from umnn_tpu_torch.models.flow import UMNNMAFFlow
from umnn_tpu_torch.training.checkpoint import CheckpointManager

TOY = "-nb_steps 8 -b_size 64 -hidden_embedding 16 16 -hidden_derivative 8 8 -embedding_s 4 -device cpu"
TOY_FLOW = dict(nb_flow=1, nb_in=2, hidden_derivative=(8, 8), hidden_embedding=(16, 16),
                embedding_s=4, nb_steps=8)
MNIST = ("-device cpu -nb_flow 1 -hidden_embedding 16 -hidden_derivative 8 8 -embedding_s 2 "
         "-ar1_rows 200 -steps_per_epoch 2 -nb_steps 4")
MNIST_FLOW = dict(nb_flow=1, nb_in=784, hidden_derivative=(8, 8), hidden_embedding=(16,),
                  embedding_s=2, nb_steps=4)
LIP_TOL = 0.25  # power iteration's estimate of sigma lies below it (chip_smoke.py LIP_TOL)


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _toy(argv: str, capsys):
    history = train_toy.main(argv.split())
    return history, capsys.readouterr().out.splitlines()


# --- toy ---------------------------------------------------------------------------


@pytest.mark.parametrize("data", ["8gaussians", "conditionnal8gaussians"])
def test_toy_sample_inverts_its_generator_draws_and_saves_them(data, tmp_path, capsys):
    history, lines = _toy(f"-data {data} -nb_epoch 2 -sample 24 -folder {tmp_path} {TOY}", capsys)
    samples = history["samples"]
    assert samples.shape == (24, 2) and samples.dtype == np.float32 and np.isfinite(samples).all()
    line = lines[-1]
    # JAX's line: f"sampled {n} points in {t:.1f}s  mean={mean}  std={std}"
    assert line.startswith("sampled 24 points in ")
    assert line.endswith(f"s  mean={samples.mean(0)}  std={samples.std(0)}")
    np.testing.assert_array_equal(np.load(tmp_path / f"samples_{data}.npy"), samples)

    # the samples are the bisection inverse of the driver's own draws, under
    # the parameters of the last checkpoint
    conditional = data == "conditionnal8gaussians"
    flow = UMNNMAFFlow(**TOY_FLOW, device="cpu", cond_in=8 if conditional else 0)
    _, state, _ = CheckpointManager(tmp_path / data / "ckpt").restore()
    flow.load_state_dict(state)
    ctx = torch.eye(8)[torch.arange(24) % 8] if conditional else None
    z = torch.randn(24, 2, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(flow.invert(z, 10, ctx).numpy(), samples)
    with torch.no_grad():
        assert float((flow(torch.as_tensor(samples), ctx) - z).abs().max()) < 3e-3


def test_toy_checkpoints_every_ckpt_every_epochs_and_after_the_last(tmp_path, capsys):
    _toy(f"-nb_epoch 4 -ckpt_every 2 -folder {tmp_path} {TOY}", capsys)
    assert CheckpointManager(tmp_path / "8gaussians" / "ckpt").all_steps() == [0, 2, 3]


def test_toy_load_resumes_at_the_next_epoch_from_the_saved_state(tmp_path, capsys):
    from umnn_tpu_torch.data.toy import inf_train_gen
    from umnn_tpu_torch.training.loops import make_optimizer, make_train_step

    _toy(f"-nb_epoch 2 -ckpt_every 1 -folder {tmp_path} {TOY}", capsys)
    ckpt = CheckpointManager(tmp_path / "8gaussians" / "ckpt")
    _, saved_model, saved_opt = ckpt.restore()
    resumed, lines = _toy(f"-nb_epoch 3 -load -folder {tmp_path} {TOY}", capsys)
    assert lines[1] == "resumed from epoch 1"
    epochs = [l for l in lines if l.startswith("epoch")]
    assert len(epochs) == 1 and epochs[0].startswith("epoch   2  ")
    assert ckpt.all_steps() == [0, 1, 2]

    # the resumed epoch started from the saved flow and Adam state (20
    # steps taken), on the data draws of a fresh RandomState(seed), as JAX's
    assert saved_opt["state"] and all(int(v["step"]) == 20 for v in saved_opt["state"].values())
    flow = UMNNMAFFlow(**TOY_FLOW, device="cpu")
    flow.load_state_dict(saved_model)
    opt = make_optimizer(flow.parameters(), "adam", 1e-3, 1e-5, grad_clip=1.0)
    opt.load_state_dict(saved_opt)
    step = make_train_step(lambda b: -flow.compute_ll(b)[0].mean(), opt)
    rng = np.random.RandomState(0)
    for _ in range(train_toy.STEPS_PER_EPOCH):
        step(torch.as_tensor(inf_train_gen("8gaussians", rng, 64)[:, :2]))
    with torch.no_grad():
        test = torch.as_tensor(inf_train_gen("8gaussians", rng, train_toy.TEST_ROWS)[:, :2])
        want = float(-flow.compute_ll(test)[0].mean())
    assert resumed["test_nll"] == [want]

    # without -load the driver starts again at epoch 0
    _, lines = _toy(f"-nb_epoch 1 -folder {tmp_path} {TOY}", capsys)
    assert not any(l.startswith("resumed") for l in lines)
    assert lines[1].startswith("epoch   0  ")


# --- MNIST -------------------------------------------------------------------------


def _mnist(argv: list, capsys):
    result = train_mnist.main(MNIST.split() + argv)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    return result, lines


def test_temperature_ladder_is_jax_arange_to_the_bit():
    import jax.numpy as jnp

    np.testing.assert_array_equal(train_mnist.TEMPERATURES, np.asarray(jnp.arange(0.1, 1.1, 0.1)))


def test_mnist_gen_temp_sweep_writes_the_newton_inverse_of_the_ladder(tmp_path, capsys):
    result, lines = _mnist(["-nb_epoch", "1", "-gen", "10", "-temp_sweep", "-nb_iter", "2",
                            "-folder", str(tmp_path)], capsys)
    imgs = np.load(tmp_path / "generated.npy")
    assert imgs.shape == (10, 28, 28) and imgs.dtype == np.float32 and np.isfinite(imgs).all()
    event = lines[-1]
    assert event["event"] == "generated" and event["images"] == 10
    assert np.isfinite(result["gen_bpp"]) and np.isfinite(result["gen_ll"])

    # the best-valid parameters, rows z * (0.1, 0.2, ..., 1.0), 5 * nb_iter
    # Newton iterations, then logit_back
    flow = UMNNMAFFlow(**MNIST_FLOW, device="cpu")
    flow.load_state_dict(CheckpointManager(tmp_path / "ckpt").load_best("valid"))
    z = torch.randn(10, 784, generator=torch.Generator().manual_seed(3))
    z = z * torch.as_tensor(train_mnist.TEMPERATURES)[:, None]
    x = flow.invert(z, 10, method="newton")
    np.testing.assert_array_equal(imgs, logit_back(x).reshape(-1, 28, 28))
    with torch.no_grad():
        bpp, ll, _ = flow.compute_bpp(x)
    assert result["gen_bpp"] == pytest.approx(float(bpp.mean()), rel=1e-6)
    assert result["gen_ll"] == pytest.approx(float(ll.mean()), rel=1e-6)
    for name in ("train.log", "metrics.jsonl", "args.json"):
        assert (tmp_path / name).exists()


def test_mnist_load_resumes_with_the_checkpointed_rate_unless_force_lr(tmp_path, capsys):
    _mnist(["-nb_epoch", "1", "-lr", "0.005", "-folder", str(tmp_path)], capsys)
    _, lines = _mnist(["-nb_epoch", "2", "-load", "-folder", str(tmp_path)], capsys)
    resumed = next(l for l in lines if l.get("event") == "resumed")
    assert resumed["epoch"] == 0 and resumed["lr"] == 0.005
    epochs = [l for l in lines if "epoch" in l and "event" not in l]
    assert [l["epoch"] for l in epochs] == [1] and epochs[0]["lr"] == 0.005
    # the checkpoint is still epoch 0's (one every 5 epochs): nothing left to train
    _, lines = _mnist(["-nb_epoch", "1", "-load", "-force_lr", "0.0007", "-folder", str(tmp_path)],
                      capsys)
    resumed = next(l for l in lines if l.get("event") == "resumed")
    assert resumed["epoch"] == 0 and resumed["lr"] == 0.0007


def test_mnist_load_npz_takes_a_jax_snapshot_and_load_wins_over_it(tmp_path, capsys):
    import jax

    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow
    from umnn_tpu.training.checkpoint import load_params_npz as jax_load
    from umnn_tpu.training.checkpoint import save_params_npz as jax_save

    from umnn_tpu_torch.bridge import flow_params_to_numpy
    from umnn_tpu_torch.data.images import synthetic_mnist_ar1
    from umnn_tpu_torch.training.checkpoint import load_params_npz

    init = JaxFlow(**MNIST_FLOW, backend="xla").init(jax.random.PRNGKey(5))
    path = jax_save(tmp_path / "snap.f16.npz", init)
    result, lines = _mnist(["-nb_epoch", "0", "-load_npz", str(path), "-folder",
                            str(tmp_path / "npz")], capsys)
    assert lines[0] == {"event": "load_npz", "path": str(path)}
    # the flow the driver scored holds JAX's float16-rounded leaves
    flow = load_params_npz(path, UMNNMAFFlow(**MNIST_FLOW, device="cpu"))
    for got, want in zip(jax.tree_util.tree_leaves(flow_params_to_numpy(flow)),
                         jax.tree_util.tree_leaves(jax_load(path, init))):
        np.testing.assert_array_equal(got, np.asarray(want))
    tst = synthetic_mnist_ar1(rho=0.7, seed=0, n=(200, 2000, 5000))[0].tst_x
    with torch.no_grad():
        bpp = torch.cat([flow.compute_bpp(torch.as_tensor(b))[0] for b in np.split(tst, 10)])
    assert result["test_bpp"] == pytest.approx(float(bpp.mean()), rel=1e-6)

    # where the folder holds a checkpoint, -load's full resume wins: its
    # optimizer's rate, not the fresh optimizer's
    _mnist(["-nb_epoch", "1", "-lr", "0.005", "-folder", str(tmp_path / "npz")], capsys)
    _, lines = _mnist(["-nb_epoch", "1", "-load", "-load_npz", str(path), "-folder",
                       str(tmp_path / "npz")], capsys)
    assert [l.get("event") for l in lines[:2]] == ["load_npz", "resumed"]
    assert lines[1]["lr"] == 0.005


def test_mnist_lipschitz_keeps_every_integrand_layer_within_its_bound(tmp_path, capsys):
    _mnist(["-nb_epoch", "1", "-folder", str(tmp_path), "-Lipshitz", "0.5"], capsys)
    state = torch.load(tmp_path / "ckpt" / "steps" / "0" / "state.pt")["model"]
    bound = [float(torch.linalg.matrix_norm(v, 2)) for k, v in state.items()
             if ".integrand." in k and k.endswith("weight")]
    # the same seed's flow, unprojected: most layers are above the bound
    free = [float(torch.linalg.matrix_norm(l.weight, 2))
            for l in UMNNMAFFlow(**MNIST_FLOW, device="cpu").blocks[0].net.integrand.layers]
    assert len(free) == len(bound) == 3
    assert sum(n > 0.5 * (1 + LIP_TOL) for n in free) >= 2
    assert max(bound) <= 0.5 * (1 + LIP_TOL)
