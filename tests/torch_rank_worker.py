"""One rank of a data-parallel group of the port, for the multi-device tests
(tests/test_torch_multidevice.py), on the CPU over gloo.

Run as ``python tests/torch_rank_worker.py CASE RANK WORLD WORKDIR``: it
joins the group through ``WORKDIR/pg`` (a file rendezvous; the 'cli' case
through the ``FESR_*`` variables instead), reads ``WORKDIR/spec.json`` and
the arrays in ``WORKDIR/in.npz``, runs CASE and writes its results to
``WORKDIR/out_RANK.npz``.  It imports torch and the port only, never jax,
so each rank pays torch's import alone; the tests compute the JAX side in
their own process.  On every rank but 0 any file opened for writing under
``spec["watch"]`` raises: only rank 0 writes.
"""

from __future__ import annotations

import builtins
import io
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fast_eng_super_resolution_tpu_torch.core.checkpoint import (  # noqa: E402
    flatten_params, unflatten_params)
from fast_eng_super_resolution_tpu_torch.core.graph import Graph  # noqa: E402
from fast_eng_super_resolution_tpu_torch.data.dataset import SyntheticDataset  # noqa: E402
from fast_eng_super_resolution_tpu_torch.data.pipeline import _leaves, prefetch_to_device  # noqa: E402
from fast_eng_super_resolution_tpu_torch.models.fno import FNO2d  # noqa: E402
from fast_eng_super_resolution_tpu_torch.models.kernelnn import KernelNN  # noqa: E402
from fast_eng_super_resolution_tpu_torch.models.registry import init_model  # noqa: E402
from fast_eng_super_resolution_tpu_torch.parallel.grid_train import (  # noqa: E402
    GridTrainer, shard_grid_epoch)
from fast_eng_super_resolution_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh, pad_batch_to_multiple, replicate, shard_batch)
from fast_eng_super_resolution_tpu_torch.parallel.train import (  # noqa: E402
    Trainer, make_fused_shard_batches)
from fast_eng_super_resolution_tpu_torch.sched.classifiers import init_classifier  # noqa: E402
from fast_eng_super_resolution_tpu_torch.sched.encoders import init_encoder  # noqa: E402
from fast_eng_super_resolution_tpu_torch.sched.scheduler import PartitionScheduler  # noqa: E402
from fast_eng_super_resolution_tpu_torch.utils.env import init_distributed  # noqa: E402


def _graph(arrays: dict, prefix: str) -> Graph:
    return Graph(**{k[len(prefix):]: v for k, v in arrays.items()
                    if k.startswith(prefix)})


def _params(model) -> dict:
    return {f"params/{k}": v for k, v in
            flatten_params(model.to_jax_params()).items()}


def case_steps(spec, arrays, mesh) -> dict:
    """Three explicit-collective steps and three fused shard steps (float32,
    the plain B1/B2 on the CPU) on this rank's shard of the batch, from the
    JAX package's initial parameters."""
    batch, _ = pad_batch_to_multiple(_graph(arrays, "batch/"), mesh.size)
    params = unflatten_params({k[7:]: v for k, v in arrays.items()
                               if k.startswith("params/")})
    out = {}
    for impl in spec["impls"]:
        model = KernelNN(**spec["cfg"]).from_jax_params(params)
        tr = Trainer(model, lr=spec["lr"], layout="batched",
                     fused_dtype="float32")
        opt = tr.init()
        replicate(model, mesh)
        if impl == "shard_map":
            data, step = shard_batch(batch, mesh), tr.make_shard_map_step(mesh)
        else:
            kw = dict(rows_blk=spec["rows_blk"], expand_s=impl == "dense")
            data, rb, blk = make_fused_shard_batches(batch, model, mesh.size,
                                                     mesh=mesh, **kw)
            # this rank's group is row `rank` of the whole stack
            full, rb2, blk2 = make_fused_shard_batches(
                batch, model, mesh.size, device="cpu", **kw)
            assert (rb2, blk2) == (rb, blk)
            rows = [a[mesh.rank:mesh.rank + 1] for a in _leaves(full)]
            assert all(torch.equal(a, b) for a, b in zip(_leaves(data), rows))
            step = tr.make_fused_shard_map_step(mesh, rb, blk)
        out[f"{impl}/losses"] = np.array([float(step(opt, data))
                                          for _ in range(spec["steps"])])
        out.update({f"{impl}/{k}": v for k, v in _params(model).items()})
    return out


def _routing(n_part: int) -> dict:
    """The encoder and classifier of a routed scheduler (their state is
    loaded from the collection)."""
    if n_part == 1:
        return {}
    return dict(encoder=init_encoder("pca", n_components=2),
                classifier=init_classifier("kmeans", n_clusters=2))


def case_serve(spec, arrays, mesh) -> dict:
    """``predict_full`` (lanes fast_mc / routed_mc) and ``predict`` on every
    mesh of the dataset, through schedulers loading the JAX package's
    collections."""
    ds = SyntheticDataset(root=spec["root"], **spec["ds"])
    out = {}
    for exp, n_part in spec["exps"]:
        sched = PartitionScheduler(
            exp, n_part, ds, init_model("neuralop", 4, 4, **spec["model"]),
            train=False, log_dir=spec["log_dir"], device="cpu",
            gemm_dtype="float32", **_routing(n_part))
        for idx in spec["idxs"]:
            x = ds.get_one_full_sample(idx)
            n = len(ds.full_mesh(idx)["points"])
            pred, ref = sched.predict_full(x, n)
            out[f"{exp}/{idx}/lane"] = np.array(sched.last_lane[0])
            out[f"{exp}/{idx}/pred"], out[f"{exp}/{idx}/ref"] = pred, ref
            # warm: the cached operands give the same bits
            assert np.array_equal(sched.predict_full(x, n)[0], pred)
            p_list, _, labels, w_list = sched.predict(x)
            out[f"{exp}/{idx}/labels"] = np.asarray(labels)
            for j, (p, w) in enumerate(zip(p_list, w_list)):
                out[f"{exp}/{idx}/p{j}"], out[f"{exp}/{idx}/w{j}"] = p, w
    return out


def case_grid(spec, arrays, mesh) -> dict:
    """One data-parallel FNO2d epoch over the [S, B, ...] arrays, and a
    prefetch of them over the mesh."""
    xb, yb = arrays["xb"], arrays["yb"]
    model = FNO2d(*spec["fno"], in_feats=1)
    model.spectral_impl = "fft"
    tr = GridTrainer(model, lr=spec["lr"], out_channels=1)
    opt = tr.init(0, xb[0])
    tr.net.from_jax_params(unflatten_params(
        {k[7:]: v for k, v in arrays.items() if k.startswith("params/")}))
    replicate(tr.net, mesh)
    xs, ys = shard_grid_epoch(xb, yb, mesh)
    got = list(prefetch_to_device(iter(list(xb)), sharding=mesh))
    per = xb.shape[1] // mesh.size
    for g, full in zip(got, xb):
        assert np.array_equal(g.numpy(), full[mesh.rank * per:
                                              (mesh.rank + 1) * per])
    losses = tr.epoch_stacked(opt, xs, ys, mesh).numpy()
    return {"losses": losses, **_params(tr.net)}


def case_sched(spec, arrays, mesh) -> dict:
    """``PartitionScheduler.train`` under each ``FESR_STEP_IMPL``, then the
    reloaded checkpoint."""
    ds = SyntheticDataset(root=spec["root"], **spec["ds"])
    out = {}
    for impl in spec["impls"]:
        if impl is None:
            os.environ.pop("FESR_STEP_IMPL", None)
        else:
            os.environ["FESR_STEP_IMPL"] = impl
        sched = PartitionScheduler(
            f"mc_{impl}", 1, ds, init_model("neuralop", 4, 4, **spec["model"]),
            train=True, log_dir=spec["log_dir"], device="cpu",
            gemm_dtype="float32")
        sched.train(spec["train"])
        out.update({f"{impl}/{k}": v for k, v in
                    flatten_params(sched.experts[0].to_jax_params()).items()})
    return out


def case_cli(spec, arrays, mesh) -> dict:
    """``python -m fast_eng_super_resolution_tpu_torch --mode=train`` then
    ``--mode=pred`` through ``runner.main``, each joining its group from the
    ``FESR_*`` variables (``FESR_MULTIHOST=1``)."""
    from fast_eng_super_resolution_tpu_torch.runner import main
    from fast_eng_super_resolution_tpu_torch.utils.config import parse_args

    out = {}
    for mode, port in zip(("train", "pred"), spec["ports"]):
        os.environ["FESR_COORDINATOR"] = f"127.0.0.1:{port}"
        main(parse_args(spec["argv"] + [f"--mode={mode}"]))
        out[f"{mode}/joined"] = np.array(True)
    return out


CASES = {"steps": case_steps, "serve": case_serve, "grid": case_grid,
         "sched": case_sched, "cli": case_cli}


def _guard_writes(root: str) -> None:
    """Makes any open for writing under ``root`` raise (``builtins.open``
    and ``io.open``, which ``zipfile`` and so ``np.savez`` call)."""
    real_open = builtins.open
    root = os.path.abspath(root)

    def guarded(file, mode="r", *args, **kwargs):
        if (isinstance(file, (str, os.PathLike))
                and os.path.abspath(file).startswith(root)
                and any(c in mode for c in "wax+")):
            raise AssertionError(f"rank {os.environ['FESR_PROCESS_ID']} "
                                 f"wrote {file}")
        return real_open(file, mode, *args, **kwargs)

    builtins.open = io.open = guarded


def main(case: str, rank: int, world: int, work: str) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    path = os.path.join(work, "in.npz")
    arrays = dict(np.load(path)) if os.path.exists(path) else {}
    os.environ["FESR_PROCESS_ID"] = str(rank)
    if case != "cli":
        init_distributed(rank, world, f"file://{os.path.join(work, 'pg')}",
                         device="cpu")
    if rank != 0 and spec.get("watch"):
        _guard_writes(spec["watch"])
    mesh = make_mesh("cpu") if case != "cli" else None
    out = CASES[case](spec, arrays, mesh)
    if mesh is not None:
        out["mesh"] = np.array([mesh.size, mesh.rank])
        torch.distributed.destroy_process_group()
    np.savez(os.path.join(work, f"out_{rank}.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
