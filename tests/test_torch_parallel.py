"""The port's data-parallel layer on the CPU: gloo process groups on
localhost.

Two worker processes of ``umnn_tpu_torch.parallel.multihost`` give the
losses and parameter checksum of one process on the whole batch (rtol
1e-5); the one-process step equals JAX's ``make_train_step`` for 3 steps on
bridged weights (rtol 1e-5); ``calculate_likelihood`` under 2 and 3 gloo
ranks equals one rank (3 ranks: JAX's tail-chunk case, a chunk padded to
the world size). Every worker has its own 120 s timeout and both are
killed on failure.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from umnn_tpu_torch.parallel import mesh, multihost

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(cmds: list) -> list:
    """Start every worker, wait for each within TIMEOUT_S, kill all on any
    failure; each worker's stdout."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _result(out: str, tag: str) -> dict:
    line = next(l for l in out.splitlines() if l.startswith(tag))
    return json.loads(line[len(tag):])


def test_two_gloo_processes_match_one_process_on_the_whole_batch():
    port = _free_port()
    cmds = [[sys.executable, "-m", "umnn_tpu_torch.parallel.multihost", "--process_id", str(i),
             "--num_processes", "2", "--coordinator", f"127.0.0.1:{port}", "--device", "cpu"]
            for i in range(2)]
    results = [_result(o, "MULTIHOST_RESULT ") for o in _run_workers(cmds)]
    single = multihost.run_multihost_step(1, 0, device="cpu")
    assert single["n_devices"] == 1 and all(r["n_devices"] == 2 for r in results)
    for r in results:
        assert set(r) == {"losses", "param_sum", "n_devices", "n_local"}
        np.testing.assert_allclose(r["losses"], single["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["param_sum"], single["param_sum"], rtol=1e-5)
    assert results[0] == results[1]


def test_one_process_step_matches_jax_train_step():
    import jax
    import jax.numpy as jnp
    from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow
    from umnn_tpu.training.loops import make_optimizer as jopt
    from umnn_tpu.training.loops import make_train_step as jstep

    from umnn_tpu_torch.bridge import load_jax_flow_params
    from umnn_tpu_torch.models.flow import UMNNMAFFlow
    from umnn_tpu_torch.training.loops import make_optimizer, make_train_step

    kw = dict(multihost.FLOW_KW, backend="xla")
    jflow = JaxFlow(**kw)
    params = jflow.init(jax.random.PRNGKey(0))
    x = multihost.global_batch()
    opt = jopt("adam", lr=1e-3, weight_decay=0.0)
    step = jstep(lambda p, xb: -jnp.mean(jflow.compute_ll(p, xb)[0]), opt)
    state, want = opt.init(params), []
    for _ in range(multihost.N_STEPS):
        params_copy = jax.tree_util.tree_map(jnp.copy, params)
        params, state, loss = step(params_copy, state, jnp.asarray(x))
        want.append(float(loss))

    flow = UMNNMAFFlow(**multihost.FLOW_KW, device="cpu")
    load_jax_flow_params(flow, jax.tree_util.tree_map(np.asarray, jflow.init(jax.random.PRNGKey(0))))
    optt = make_optimizer(flow.parameters(), "adam", lr=1e-3, weight_decay=0.0)
    stept = make_train_step(lambda xb: -flow.compute_ll(xb)[0].mean(), optt)
    got = [float(stept(torch.as_tensor(x))) for _ in range(multihost.N_STEPS)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


LIKELIHOOD = """
import json, sys
import numpy as np
import torch
from umnn_tpu_torch.models.vae.iwae import calculate_likelihood
from umnn_tpu_torch.models.vae.vae import VAE
from umnn_tpu_torch.parallel.mesh import initialize_distributed

rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
model = VAE(z_size=4, seed=0, device="cpu")
x = (np.random.RandomState(1).rand(3, 1, 28, 28) > 0.5).astype(np.float32)
ll, per = calculate_likelihood(model, x, torch.Generator().manual_seed(3), n_samples=4,
                               minibatch=2, data_chunk=2)
print("LIKELIHOOD " + json.dumps({"ll": ll, "per": per.tolist()}), flush=True)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


@pytest.mark.parametrize("world", [2, 3])
def test_calculate_likelihood_under_gloo_ranks_equals_one_rank(world):
    """On the same seeded generator: both worlds split a datapoint's
    particles over two ranks (the tail chunk), which must not draw the
    same noise."""
    from umnn_tpu_torch.models.vae.iwae import calculate_likelihood
    from umnn_tpu_torch.models.vae.vae import VAE

    port = _free_port()
    cmds = [[sys.executable, "-c", LIKELIHOOD, str(r), str(world), str(port)]
            for r in range(world)]
    results = [_result(o, "LIKELIHOOD ") for o in _run_workers(cmds)]
    x = (np.random.RandomState(1).rand(3, 1, 28, 28) > 0.5).astype(np.float32)
    ll, per = calculate_likelihood(VAE(z_size=4, seed=0, device="cpu"), x,
                                   torch.Generator().manual_seed(3), n_samples=4,
                                   minibatch=2, data_chunk=2)
    assert np.isfinite(per).all() and per.shape == (3,)
    for r in results:
        np.testing.assert_allclose(r["per"], per, rtol=1e-5)
        np.testing.assert_allclose(r["ll"], ll, rtol=1e-5)


def test_host_local_rows_and_a_single_process_group():
    batch = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(mesh.host_local_rows(batch, 1, 3), batch[2:4])
    with pytest.raises(ValueError):
        mesh.host_local_rows(batch, 0, 4)
    mesh.initialize_distributed(None, 1, 0, device="cpu")  # nothing for one process
    assert not torch.distributed.is_initialized()


def test_grouped_step_leaves_a_missing_gradient_missing():
    """A parameter the loss does not reach keeps no gradient under a group,
    so L2 decay and Adam's moments leave it alone as on one process."""
    from umnn_tpu_torch.training.loops import make_optimizer, make_train_step

    def run(group):
        gen = torch.Generator().manual_seed(0)
        used, unused = (torch.nn.Parameter(torch.randn(3, generator=gen)) for _ in range(2))
        opt = make_optimizer([used, unused], "adam", lr=1e-2, weight_decay=0.1)
        step = make_train_step(lambda xb: ((used * xb) ** 2).mean(), opt, process_group=group)
        losses = [float(step(torch.arange(3.0))) for _ in range(2)]
        return losses, used.detach().clone(), unused

    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                                         world_size=1, rank=0)
    try:
        grouped = run(torch.distributed.group.WORLD)
    finally:
        torch.distributed.destroy_process_group()
    alone = run(None)
    assert grouped[0] == alone[0] and torch.equal(grouped[1], alone[1])
    assert grouped[2].grad is None and torch.equal(grouped[2], alone[2])
