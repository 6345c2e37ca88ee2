"""The port's VAE driver at a tiny size on the CPU: MMAF with randomized
steps and IAF for 2 epochs on the binary stand-in, Freyfaces (multinomial)
for one; the JSON has JAX's keys and finite values, the best-valid
checkpoint is written and ``-eval_only`` evaluates it; TF32 is off in
every backward pass of the driver and the caller's flags are back after it;
only a missing matplotlib is caught around the plots."""

import json

import numpy as np
import pytest
import torch

from umnn_tpu_torch.examples import train_vae

TINY = ("-device cpu -synthetic -z_size 4 -num_flows 2 -made_h_size 16 -hidden_embedding 16 16 "
        "-hidden_derivative 8 8 -embedding_size 4 -b_size 100 -iwae_samples 20 "
        "-iwae_minibatch 10 -iwae_test_points 3").split()
KEYS = {"dataset", "flow", "best_valid_elbo", "test_elbo", "test_iwae_ll", "iwae_samples"}


def _run(argv, capsys) -> tuple[int, dict, str]:
    rc = train_vae.main(argv)
    out = capsys.readouterr().out
    return rc, json.loads(out.strip().splitlines()[-1]), out


@pytest.mark.parametrize("flow,extra", [("MMAF", ["-steps", "0"]), ("iaf", [])])
def test_driver_trains_and_evaluates_its_checkpoint(flow, extra, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    real_backward = torch.Tensor.backward

    def backward(self, *a, **k):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return real_backward(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "backward", backward)
    argv = TINY + ["-flow", flow, "-nb_epoch", "2", "-folder", str(tmp_path)] + extra
    rc, res, out = _run(argv, capsys)
    # every backward pass ran with TF32 off; the caller's flags are back
    assert seen and not any(a or b for a, b in seen)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    assert rc == 0 and set(res) == KEYS, res
    assert res["flow"] == flow and res["iwae_samples"] == 20
    assert all(np.isfinite(res[k]) for k in ("best_valid_elbo", "test_elbo", "test_iwae_ll"))
    folder = tmp_path / f"mnist_{flow}"
    assert (folder / "ckpt" / "best_valid").is_dir()
    assert {"args.json", "train.log", "metrics.jsonl"} <= {p.name for p in folder.iterdir()}
    assert out.count("epoch ") == 2
    rc, again, _ = _run(argv + ["-eval_only"], capsys)
    assert rc == 0 and set(again) == KEYS and (folder / "args_eval.json").exists()
    assert again["best_valid_elbo"] is None and np.isfinite(again["test_elbo"])


def test_eval_only_without_a_checkpoint_returns_1(tmp_path, capsys):
    rc = train_vae.main(TINY + ["-eval_only", "-folder", str(tmp_path)])
    assert rc == 1 and "no best_valid checkpoint" in capsys.readouterr().out


def test_freyfaces_reports_bits_per_dim(tmp_path, capsys):
    argv = TINY + ["-dataset", "freyfaces", "-flow", "no_flow", "-nb_epoch", "1", "-folder",
                   str(tmp_path), "-plot_every", "0"]
    rc, res, out = _run(argv, capsys)
    assert rc == 0 and set(res) == KEYS | {"test_bpd_elbo", "test_bpd_ll"}
    assert "valid bpd" in out and "Test set bpd (elbo)" in out
    assert "Test set bpd (log-likelihood)" in out
    np.testing.assert_allclose(res["test_bpd_ll"], -res["test_iwae_ll"] / (560 * np.log(2)))


def test_only_a_missing_matplotlib_is_caught(tmp_path, capsys, monkeypatch):
    from umnn_tpu_torch.utils import visualize

    def no_matplotlib(*a, **k):
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(visualize, "image_grid", no_matplotlib)
    argv = TINY + ["-flow", "no_flow", "-nb_epoch", "1", "-folder", str(tmp_path)]
    rc, _, out = _run(argv, capsys)
    assert rc == 0 and "plots skipped" in out

    def broken_decode(self, z):
        raise RuntimeError("decode failed")

    monkeypatch.setattr(train_vae.VAE_FAMILIES["no_flow"], "decode", broken_decode)
    with pytest.raises(RuntimeError, match="decode failed"):
        train_vae.main(argv)
