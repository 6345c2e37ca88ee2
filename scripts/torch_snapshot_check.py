"""Score a committed float16 UCI snapshot with both packages, on the CPU.

Loads a snapshot written by ``save_params_npz`` (default: the BSDS300 run's
``runs/parity_real/uci/bsds300/params_step65.f16.npz``; the flow's widths
come from the ``args.json`` beside it) into the JAX package's flow and into
the port's, and evaluates ``compute_ll`` on the first ``--rows`` rows of the
test split the run used (the synthetic stand-in at the size its
``-synthetic_rows`` named), at the UCI driver's evaluation steps (100 in
randomized mode, else ``nb_steps``). Prints one JSON line: the largest
|ll difference| between the packages and each package's mean ll and mean
NLL. Both run in float32 on the CPU, the port on its plain route; the JAX
package's logged test NLL on the TPU (its repro log) used the TPU's default
matmul precision over the whole split, so it is no target for these rows.

Usage, from the root of the repo (about a minute, a few GB of memory):

    python scripts/torch_snapshot_check.py [--snapshot PATH] [--rows 2000] [--batch 250]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from umnn_tpu.data.uci import load_uci as jax_load_uci  # noqa: E402
from umnn_tpu.models.flow import UMNNMAFFlow as JaxFlow  # noqa: E402
from umnn_tpu.ops.quadrature import padded_cc_quadrature as jax_padded  # noqa: E402
from umnn_tpu.training.checkpoint import load_params_npz as jax_load_npz  # noqa: E402
from umnn_tpu_torch.data.uci import SYNTH_REAL_ROWS, UCI_DIMS, load_uci  # noqa: E402
from umnn_tpu_torch.models.flow import UMNNMAFFlow  # noqa: E402
from umnn_tpu_torch.ops.quadrature import padded_cc_quadrature  # noqa: E402
from umnn_tpu_torch.training.checkpoint import load_params_npz  # noqa: E402

DEFAULT = Path("runs/parity_real/uci/bsds300/params_step65.f16.npz")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--snapshot", type=Path, default=DEFAULT)
    p.add_argument("--rows", type=int, default=2000)
    p.add_argument("--batch", type=int, default=250)
    a = p.parse_args(argv)
    args = json.loads((a.snapshot.parent / "args.json").read_text())
    name = args["data"]
    rows = {-1: SYNTH_REAL_ROWS[name], 0: None}.get(args["synthetic_rows"], args["synthetic_rows"])
    eval_steps = 100 if args["nb_steps"] <= 0 else args["nb_steps"]
    cfg = dict(nb_flow=args["nb_flow"], nb_in=UCI_DIMS[name],
               hidden_derivative=tuple(args["hidden_derivative"]),
               hidden_embedding=tuple(args["hidden_embedding"]), embedding_s=args["embedding_s"],
               nb_steps=eval_steps)

    t0 = time.perf_counter()
    tst = load_uci(name, synthetic=True, synthetic_rows=rows).tst[: a.rows]
    tst_jax = jax_load_uci(name, synthetic=True, synthetic_rows=rows).tst[: a.rows]
    if not np.array_equal(tst, tst_jax):
        raise AssertionError("the packages' synthetic test rows differ")
    data_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    jflow = JaxFlow(**cfg, backend="xla")
    params = jax_load_npz(a.snapshot, jflow.init(jax.random.PRNGKey(0)))
    nodes, weights = jax_padded(eval_steps, eval_steps)
    ll_fn = jax.jit(lambda prm, x: jflow.compute_ll(prm, x, nodes=nodes, weights=weights)[0])
    ll_jax = np.concatenate([np.asarray(ll_fn(params, jnp.asarray(b)))
                             for b in np.array_split(tst, -(-len(tst) // a.batch))])
    jax_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    flow = load_params_npz(a.snapshot, UMNNMAFFlow(**cfg, device="cpu"))
    tn, tw = padded_cc_quadrature(eval_steps, eval_steps, "cpu")
    with torch.no_grad():
        ll_port = np.concatenate([
            flow.compute_ll(torch.as_tensor(b), nodes=tn, weights=tw)[0].numpy()
            for b in np.array_split(tst, -(-len(tst) // a.batch))])
    port_s = time.perf_counter() - t0

    diff = np.abs(ll_port.astype(np.float64) - ll_jax)
    out = {
        "snapshot": str(a.snapshot), "dataset": f"synthetic-{name}", "rows": len(tst),
        "eval_steps": eval_steps,
        "params": int(sum(leaf.size for leaf in jax.tree_util.tree_leaves(params))),
        "max_abs_ll_diff": float(diff.max()), "argmax_row": int(diff.argmax()),
        "mean_ll_jax": float(ll_jax.mean()), "mean_ll_port": float(ll_port.mean()),
        "mean_nll_jax": float(-ll_jax.mean()), "mean_nll_port": float(-ll_port.mean()),
        "nonfinite_jax": int((~np.isfinite(ll_jax)).sum()),
        "nonfinite_port": int((~np.isfinite(ll_port)).sum()),
        "seconds": {"data": data_s, "jax": jax_s, "port": port_s},
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
