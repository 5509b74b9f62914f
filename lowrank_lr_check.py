"""Rank-16 KernelNN training at lr 0.003 in the JAX package and in the
PyTorch port, step by step, on the CPU:

    JAX_PLATFORMS=cpu python lowrank_lr_check.py [--steps 12] [--lr 0.003]

Both start from the same weights (JAX's init, carried into the port with
``from_jax_params``) and train the fused layout in float32 with Adam on one
merged batch of the small synthetic duct's subdomains (n_high (16, 8, 8),
n_low (8, 4, 4), 4 subdomains), at the width of
configs/exp_config/neuralop_synthetic_full.yaml (48, ker_width 48, 4 in / 4
out) with ``kernel_rank`` 16 at depth 2, as chip_smoke.py's rank-16 path
trains it, and lr 0.003 of configs/train_config/synthetic_full.yaml.  JAX
runs its Pallas kernels in interpret mode, the port its kernels' plain
versions.  Prints both losses per step and their relative difference, then
one JSON line with the curves.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fast_eng_super_resolution_tpu.core.graph import merge_batch, pad_and_bucket  # noqa: E402
from fast_eng_super_resolution_tpu.data.partition import extract_subdomains  # noqa: E402
from fast_eng_super_resolution_tpu.data.synthetic import make_sample_pair  # noqa: E402
from fast_eng_super_resolution_tpu.models.kernelnn import KernelNN as JKernelNN  # noqa: E402
from fast_eng_super_resolution_tpu.parallel import train as jtrain  # noqa: E402
from fast_eng_super_resolution_tpu_torch.core.graph import Graph  # noqa: E402
from fast_eng_super_resolution_tpu_torch.models.kernelnn import KernelNN  # noqa: E402
from fast_eng_super_resolution_tpu_torch.parallel import train as ttrain  # noqa: E402

CFG = dict(width=48, ker_width=48, depth=2, ker_in=1, in_width=4,
           out_width=4, kernel_rank=16)


def merged_small_duct(seed: int = 0):
    """The small duct's 4 subdomains merged into one padded graph."""
    s = make_sample_pair(n_high=(16, 8, 8), n_low=(8, 4, 4), seed=seed)
    subs = extract_subdomains(s["pos"], s["mesh"].cells, s["x"], s["y"], 4,
                              "all_intersecting")
    raw = [dict(x=g.x, y=g.y, pos=g.pos, senders=g.senders,
                receivers=g.receivers, edge_attr=g.edge_attr,
                global_ids=g.global_node_ids) for g in subs]
    (_, _, batch), = pad_and_bucket(raw)
    return merge_batch(batch)[0], len(subs)


def curves(steps: int, lr: float, seed: int = 0) -> dict:
    merged, n_sub = merged_small_duct(seed)
    jmodel = JKernelNN(mode="edge3d", **CFG)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(seed)))
    jbatch, rows_blk, blk = jtrain.make_fused_batch(merged, jmodel)
    host = Graph(**{f.name: np.asarray(getattr(merged, f.name))
                    for f in dataclasses.fields(Graph)})
    model = KernelNN(**CFG).from_jax_params(params)
    tbatch, _, blk2 = ttrain.make_fused_batch(host, model, rows_blk=rows_blk,
                                              device="cpu")
    if blk2 != blk:
        raise AssertionError(f"block geometry differs: {blk2} vs {blk}")
    jt = jtrain.Trainer(jmodel, lr=lr, layout="fused", donate=False,
                        fused_rows_blk=rows_blk, fused_blk=blk,
                        fused_dtype="float32", fused_interpret=True)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    o = jt.optimizer.init(p)
    tt = ttrain.Trainer(model, lr=lr, layout="fused", fused_rows_blk=rows_blk,
                        fused_blk=blk, fused_dtype="float32")
    opt = tt.init()
    jax_losses, port_losses = [], []
    for step in range(steps):
        t0 = time.time()
        p, o, ref = jt.step(p, o, jbatch)
        got = float(tt.step(opt, tbatch))
        jax_losses.append(float(ref))
        port_losses.append(got)
        rel = abs(got - float(ref)) / abs(float(ref))
        print(f"step={step} jax={float(ref):.8g} port={got:.8g} "
              f"rel={rel:.3e} s={time.time() - t0:.1f}", flush=True)
    return dict(subdomains=n_sub, nodes=int(host.x.shape[0]), lr=lr,
                config=CFG, jax=jax_losses, port=port_losses,
                max_rel=max(abs(a - b) / abs(b)
                            for a, b in zip(port_losses, jax_losses)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--lr", type=float, default=0.003)
    args = ap.parse_args()
    print(json.dumps(curves(args.steps, args.lr)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
