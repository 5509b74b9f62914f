"""The port's data-parallel group against the JAX package's device mesh, on
the CPU: each case spawns 2 or 4 ranks of ``tests/torch_rank_worker.py``
(gloo, a file rendezvous in ``tmp_path``; the CLI case a TCP one on a free
local port), which import no jax, and holds their results against the JAX
functions on the 8 virtual CPU devices of tests/conftest.py and against one
process of the port on the concatenated batch.

Tolerances, float32 everywhere (the fused layers in their plain versions on
the port's side, Pallas in interpret mode on the JAX side), each the one the
JAX package's tests set for the same comparison:
- train steps (3 Adam steps): losses rtol 1e-5, parameters rtol 1e-3 and
  atol 1e-5 (tests/test_train.py:281-284); the ranks' parameters equal bit
  for bit;
- serving lanes: 1e-4 of the max (sums in other orders through depth 2 and
  an overlap average; tests/test_torch_routed_serving.py);
- the grid epoch: losses rtol 1e-5, parameters rtol 1e-4 and atol 1e-6
  (tests/test_train.py:321-325).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp

from fast_eng_super_resolution_tpu.core import checkpoint as jckpt
from fast_eng_super_resolution_tpu.core.graph import merge_batch as jmerge
from fast_eng_super_resolution_tpu.core.graph import pad_and_bucket as jpad
from fast_eng_super_resolution_tpu.data.dataset import SyntheticDataset as JSynthetic
from fast_eng_super_resolution_tpu.data.partition import extract_subdomains
from fast_eng_super_resolution_tpu.data.synthetic import make_sample_pair
from fast_eng_super_resolution_tpu.models.fno import FNO2d as JFNO2d
from fast_eng_super_resolution_tpu.models.kernelnn import KernelNN as JKernelNN
from fast_eng_super_resolution_tpu.models.registry import init_model as jinit
from fast_eng_super_resolution_tpu.ops import fused_conv as jfc
from fast_eng_super_resolution_tpu.parallel import mesh as jmesh
from fast_eng_super_resolution_tpu.parallel import train as jtrain
from fast_eng_super_resolution_tpu.parallel.grid_train import (
    GridTrainer as JGridTrainer, shard_grid_epoch as jshard_grid_epoch)
from fast_eng_super_resolution_tpu.sched import classifiers as jcls
from fast_eng_super_resolution_tpu.sched import encoders as jenc
from fast_eng_super_resolution_tpu.sched.scheduler import PartitionScheduler as JSched
from fast_eng_super_resolution_tpu_torch.core.checkpoint import flatten_params
from fast_eng_super_resolution_tpu_torch.core.graph import Graph
from fast_eng_super_resolution_tpu_torch.data.dataset import SyntheticDataset
from fast_eng_super_resolution_tpu_torch.data.vtu import read_vtu
from fast_eng_super_resolution_tpu_torch.models.kernelnn import KernelNN
from fast_eng_super_resolution_tpu_torch.models.registry import init_model
from fast_eng_super_resolution_tpu_torch.parallel import train as ttrain
from fast_eng_super_resolution_tpu_torch.sched import (PartitionScheduler,
                                                       init_classifier,
                                                       init_encoder)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORKER = os.path.join(TESTS, "torch_rank_worker.py")
CFG = dict(width=8, ker_width=8, depth=2, ker_in=1, in_width=4, out_width=4)
ROWS_BLK = 16
LR = 1e-3
STEPS = 3
STEP_TOL = dict(loss=1e-5, rtol=1e-3, atol=1e-5)
SERVE_TOL = 1e-4
DS_KW = dict(sub_size=4, n_high=(16, 8, 8), n_low=(8, 4, 4), num_cases=2)
MODEL_KW = dict(width=8, num_layers=2)


def _spawn(case: str, world: int, work, spec: dict, arrays=None, env=None,
           timeout: float = 300):
    """Runs ``world`` ranks of the worker on ``case``; returns each rank's
    results (rank order).  A rank that fails fails the test with its log."""
    work = str(work)
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump(spec, f)
    if arrays:
        np.savez(os.path.join(work, "in.npz"), **arrays)
    child_env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                     MKL_NUM_THREADS="1", **(env or {}))
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(work, f"log_{r}.txt"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, case, str(r), str(world), work],
            cwd=work, env=child_env, stdout=log, stderr=subprocess.STDOUT))
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, code in enumerate(codes):
        if code:
            text = open(os.path.join(work, f"log_{r}.txt")).read()
            pytest.fail(f"rank {r} exited {code}:\n{text[-4000:]}")
    return [dict(np.load(os.path.join(work, f"out_{r}.npz")))
            for r in range(world)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree) -> dict:
    return jckpt.flatten_params(_np(tree))


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _ranks_agree(outs: list, prefix: str) -> dict:
    """The ranks' arrays under ``prefix`` (equal bit for bit on every rank),
    keyed without it; ``mesh`` (each rank's (size, rank)) aside."""
    keys = [k for k in outs[0] if k.startswith(prefix) and k != "mesh"]
    assert keys, prefix
    for o in outs[1:]:
        for k in keys:
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
    return {k[len(prefix):]: outs[0][k] for k in keys}


def _assert_params(got: dict, want: dict, rtol: float, atol: float) -> None:
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


# -- the train steps ----------------------------------------------------------

@pytest.fixture(scope="module")
def batch():
    """Six subdomains of a small synthetic duct (a [6, ...] host batch):
    6 is a multiple of 2 and pads to 8 over 4 ranks."""
    s = make_sample_pair(n_high=(12, 6, 6), n_low=(6, 3, 3))
    subs = extract_subdomains(s["pos"], s["mesh"].cells, s["x"], s["y"], 6,
                              "all_intersecting")
    raw = [dict(x=g.x, y=g.y, pos=g.pos, senders=g.senders,
                receivers=g.receivers, edge_attr=g.edge_attr,
                global_ids=g.global_node_ids) for g in subs]
    (_, _, b), = jpad(raw, to_device=False)
    return jax.tree_util.tree_map(np.asarray, b)


def _jax_single_steps(batch, jmodel):
    """JAX's single-device steps on the whole batch: the merged plain step
    and the fused step (Pallas in interpret mode, float32), 3 Adam steps
    each from PRNGKey(0); and the initial parameters.  Traced anew, so
    under the ``FESR_LOSS_VJP`` of the caller."""
    merged, _ = jmerge(batch)
    out = {}
    tr = jtrain.Trainer(jmodel, lr=LR, donate=False, layout="merged")
    params0, opt = tr.init(jax.random.PRNGKey(0))
    p, losses = params0, []
    for _ in range(STEPS):
        p, opt, loss = tr.step(p, opt, merged)
        losses.append(float(loss))
    out["merged"] = (np.array(losses), _flat(p))
    fb, rb, blk = jtrain.make_fused_batch(merged, jmodel, rows_blk=ROWS_BLK)
    tr = jtrain.Trainer(jmodel, lr=LR, donate=False, layout="fused",
                        fused_rows_blk=rb, fused_blk=blk,
                        fused_dtype="float32", fused_interpret=True)
    p, opt = params0, tr.optimizer.init(params0)
    losses = []
    for _ in range(STEPS):
        p, opt, loss = tr.step(p, opt, fb)
        losses.append(float(loss))
    out["fused"] = (np.array(losses), _flat(p))
    return out, _flat(params0)


@pytest.fixture(scope="module")
def jax_refs(batch):
    """``_jax_single_steps`` under the default loss backward, the JAX
    model and the initial parameters."""
    jmodel = JKernelNN(mode="edge3d", **CFG)
    out, params0 = _jax_single_steps(batch, jmodel)
    return out, jmodel, params0


def _jax_shard_map(batch, jmodel, world: int, fused: bool):
    """JAX's explicit-collective (or fused, interpret) shard_map step on a
    ``world``-device mesh, 3 steps from PRNGKey(0)."""
    mesh = jmesh.make_mesh(jax.devices()[:world])
    padded, _ = jmesh.pad_batch_to_multiple(batch, world)
    tr = jtrain.Trainer(jmodel, lr=LR, donate=False, fused_dtype="float32")
    p, opt = tr.init(jax.random.PRNGKey(0))
    if fused:
        data, rb, blk = jtrain.make_fused_shard_batches(padded, jmodel, world,
                                                        rows_blk=ROWS_BLK)
        step = tr.make_fused_shard_map_step(mesh, rb, blk, interpret=True)
    else:
        data, step = padded, tr.make_shard_map_step(mesh)
    p = jmesh.replicate(p, mesh)
    data = jmesh.shard_batch(data, mesh)
    losses = []
    for _ in range(STEPS):
        p, opt, loss = step(p, opt, data)
        losses.append(float(loss))
    return np.array(losses), _flat(p)


def _port_merged_steps(batch, params0: dict, layout: str):
    """One process of the port on the concatenated batch (merged or fused,
    float32), 3 steps from the same parameters."""
    from fast_eng_super_resolution_tpu_torch.core.graph import merge_batch

    host = Graph(**{k: np.asarray(getattr(batch, k))
                    for k in Graph.__dataclass_fields__})
    merged, _ = merge_batch(host)
    model = KernelNN(**CFG).from_jax_params(jckpt.unflatten_params(params0))
    kw = {}
    data = merged.to_torch("cpu")
    if layout == "fused":
        data, rb, blk = ttrain.make_fused_batch(merged, model,
                                                rows_blk=ROWS_BLK,
                                                device="cpu")
        kw = dict(fused_rows_blk=rb, fused_blk=blk, fused_dtype="float32")
    tr = ttrain.Trainer(model, lr=LR, layout=layout, **kw)
    opt = tr.init()
    losses = [float(tr.step(opt, data)) for _ in range(STEPS)]
    return np.array(losses), flatten_params(model.to_jax_params())


@pytest.mark.parametrize("world", [2, 4])
def test_shard_steps_match_jax(world, batch, jax_refs, tmp_path):
    """3 steps of ``make_shard_map_step`` and of ``make_fused_shard_map_step``
    (dense S and compact S) over ``world`` gloo ranks: every rank holds the
    same parameters, equal to JAX's shard_map step on a ``world``-device
    mesh (its fused step in interpret mode at 2 devices), to JAX's and the
    port's single-device steps on the concatenated batch; each rank's fused
    group equals row ``rank`` of the stacked groups (checked in the
    worker)."""
    refs, jmodel, params0 = jax_refs
    impls = ["shard_map", "dense", "compact"] if world == 2 else [
        "shard_map", "compact"]
    arrays = {f"batch/{k}": np.asarray(getattr(batch, k))
              for k in Graph.__dataclass_fields__}
    arrays.update({f"params/{k}": v for k, v in params0.items()})
    outs = _spawn("steps", world, tmp_path, dict(
        cfg=CFG, lr=LR, rows_blk=ROWS_BLK, steps=STEPS, impls=impls), arrays)
    assert [tuple(o["mesh"]) for o in outs] == [(world, r)
                                                for r in range(world)]
    wants = {"shard_map": [refs["merged"], _jax_shard_map(batch, jmodel, world,
                                                          False),
                           _port_merged_steps(batch, params0, "merged")]}
    fused = [refs["fused"], _port_merged_steps(batch, params0, "fused")]
    if world == 2:
        fused.append(_jax_shard_map(batch, jmodel, world, True))
    wants["dense"] = wants["compact"] = fused
    for impl in impls:
        got = _ranks_agree(outs, f"{impl}/")
        losses = got.pop("losses")
        got = {k[len("params/"):]: v for k, v in got.items()}
        for want_losses, want_params in wants[impl]:
            np.testing.assert_allclose(losses, want_losses,
                                       rtol=STEP_TOL["loss"])
            _assert_params(got, want_params, STEP_TOL["rtol"],
                           STEP_TOL["atol"])


def test_custom_loss_vjp_steps_match_jax(batch, jax_refs, monkeypatch):
    """``FESR_LOSS_VJP=custom`` drives the merged and the fused train steps
    (one process, float32; the fused layers' plain versions): 3 steps of
    the port against JAX's same steps under the same setting (its custom
    VJP) and against the default steps, losses rtol 1e-5 and parameters
    rtol 1e-3 / atol 1e-5 (no ties on this batch, so both backwards
    agree)."""
    from fast_eng_super_resolution_tpu_torch.ops import loss as tloss

    refs, jmodel, params0 = jax_refs
    monkeypatch.setenv("FESR_LOSS_VJP", "custom")
    custom, p0 = _jax_single_steps(batch, jmodel)
    assert p0.keys() == params0.keys()
    calls = []
    apply = tloss.GradientWeightScalar.apply
    monkeypatch.setattr(tloss.GradientWeightScalar, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    for layout in ("merged", "fused"):
        calls.clear()
        losses, params = _port_merged_steps(batch, params0, layout)
        assert len(calls) == STEPS, (layout, calls)
        for want_losses, want_params in (custom[layout], refs[layout]):
            np.testing.assert_allclose(losses, want_losses,
                                       rtol=STEP_TOL["loss"])
            _assert_params(params, want_params, STEP_TOL["rtol"],
                           STEP_TOL["atol"])


def test_custom_loss_vjp_shard_steps_match_one_process(batch, jax_refs,
                                                       tmp_path, monkeypatch):
    """The explicit-collective and the fused shard steps over 2 gloo ranks
    under ``FESR_LOSS_VJP=custom`` (the custom backward composed with the
    shard steps' linearisation of the global loss) against one process of
    the port on the concatenated batch under the same setting: losses rtol
    1e-5, parameters rtol 1e-3 / atol 1e-5, both ranks equal.  Under
    ``FESR_TIMING=1`` the ranks' ``make_fused_shard_batches`` on the mesh
    prints its ``[fesr-timing]`` line on rank 0 only (each rank also calls
    it once without a mesh, which prints)."""
    _, _, params0 = jax_refs
    arrays = {f"batch/{k}": np.asarray(getattr(batch, k))
              for k in Graph.__dataclass_fields__}
    arrays.update({f"params/{k}": v for k, v in params0.items()})
    outs = _spawn("steps", 2, tmp_path, dict(
        cfg=CFG, lr=LR, rows_blk=ROWS_BLK, steps=STEPS,
        impls=["shard_map", "dense"]), arrays,
        env={"FESR_LOSS_VJP": "custom", "FESR_TIMING": "1"})
    monkeypatch.setenv("FESR_LOSS_VJP", "custom")
    for impl, layout in (("shard_map", "merged"), ("dense", "fused")):
        got = _ranks_agree(outs, f"{impl}/")
        losses = got.pop("losses")
        got = {k[len("params/"):]: v for k, v in got.items()}
        want_losses, want_params = _port_merged_steps(batch, params0, layout)
        np.testing.assert_allclose(losses, want_losses, rtol=STEP_TOL["loss"])
        _assert_params(got, want_params, STEP_TOL["rtol"], STEP_TOL["atol"])
    lines = [open(tmp_path / f"log_{r}.txt").read().count(
        "[fesr-timing] make_fused_shard_batches:") for r in range(2)]
    assert lines == [2, 1], lines


def test_fesr_timing_line(batch, capsys, monkeypatch):
    """``FESR_TIMING=1``: ``make_fused_shard_batches`` prints the JAX
    package's one line of host stage times; unset, nothing."""
    import re

    host = Graph(**{k: np.asarray(getattr(batch, k))
                    for k in Graph.__dataclass_fields__})
    model = KernelNN(**CFG)
    monkeypatch.delenv("FESR_TIMING", raising=False)
    ttrain.make_fused_shard_batches(host, model, 2, rows_blk=ROWS_BLK,
                                    device="cpu")
    assert "[fesr-timing]" not in capsys.readouterr().out
    monkeypatch.setenv("FESR_TIMING", "1")
    ttrain.make_fused_shard_batches(host, model, 2, rows_blk=ROWS_BLK,
                                    device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[fesr-timing]")]
    stage = r"=\d+\.\d\ds"
    assert len(lines) == 1 and re.fullmatch(
        r"\[fesr-timing\] make_fused_shard_batches: "
        + ", ".join(n + stage for n in ("device_get", "merge",
                                        "scatter_build", "stack_upload")),
        lines[0]), lines


# -- the serving lanes ----------------------------------------------------------

@pytest.fixture(scope="module")
def collections(tmp_path_factory):
    """A routed collection ("routed": the JAX package's PCA encoder and
    k-means state, two experts) and a single-expert one ("single"), written
    by the JAX package; the port's copy of the dataset."""
    d = str(tmp_path_factory.mktemp("logs"))
    jds = JSynthetic(root=str(tmp_path_factory.mktemp("jds")), **DS_KW)
    JSched("routed", 2, jds, jinit("neuralop", 4, 4, **MODEL_KW),
           train=True, encoder=jenc.PCAEncoder(n_components=2),
           classifier=jcls.KMeansClassifier(2), log_dir=d, use_mesh=False)
    model = jinit("neuralop", 4, 4, **MODEL_KW)
    for exp, i in (("routed", 0), ("routed", 1), ("single", 0)):
        params = _np(model.init(jax.random.PRNGKey(3 + i)))
        jckpt.save_params(os.path.join(d, "models", f"collection_{exp}",
                                       f"partition_{i}.npz"),
                          params, meta={"model": "KernelNN"})
    root = str(tmp_path_factory.mktemp("tds"))
    return d, jds, SyntheticDataset(root=root, **DS_KW), root


def test_mc_lanes_match_jax(collections, tmp_path, monkeypatch):
    """``predict_full`` over 2 gloo ranks takes lane ``fast_mc`` (one
    expert) and ``routed_mc`` (two), as JAX's does on its 8-device mesh,
    and equals JAX's lane; the ranks' ``predict`` (each rank's block of
    every chunk, gathered) equals one process's."""
    log_dir, jds, tds, root = collections
    monkeypatch.setenv("FESR_FUSED_PREDICT", "force")
    orig = jfc.fused_edge_conv  # JAX's fused serving layer in float32

    def f32(*args, **kwargs):
        kwargs["gemm_dtype"] = "float32"
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfc, "fused_edge_conv", f32)
    exps = [("single", 1), ("routed", 2)]
    idxs = [0, 1]
    outs = _spawn("serve", 2, tmp_path, dict(
        root=root, ds=DS_KW, model=MODEL_KW, log_dir=log_dir, exps=exps,
        idxs=idxs))
    lanes = {"single": "fast_mc", "routed": "routed_mc"}
    for exp, n_part in exps:
        kw = {} if n_part == 1 else dict(
            encoder=jenc.PCAEncoder(n_components=2),
            classifier=jcls.KMeansClassifier(2))
        js = JSched(exp, n_part, jds, jinit("neuralop", 4, 4, **MODEL_KW),
                    train=False, log_dir=log_dir, use_mesh=True, **kw)
        ts = PartitionScheduler(
            exp, n_part, tds, init_model("neuralop", 4, 4, **MODEL_KW),
            train=False, log_dir=log_dir, device="cpu", gemm_dtype="float32",
            **({} if n_part == 1 else dict(
                encoder=init_encoder("pca", n_components=2),
                classifier=init_classifier("kmeans", n_clusters=2))))
        for idx in idxs:
            got = _ranks_agree(outs, f"{exp}/{idx}/")
            x = jds.get_one_full_sample(idx)
            n = len(jds.full_mesh(idx)["points"])
            jpred, jref = js.predict_full(x, n)
            assert js.last_lane[0] == str(got["lane"]) == lanes[exp]
            assert _rel(got["pred"], jpred) < SERVE_TOL
            assert _rel(got["ref"], jref) < 1e-6
            tp, _, tlab, tw = ts.predict(tds.get_one_full_sample(idx))
            np.testing.assert_array_equal(got["labels"], tlab)
            for j, (p, w) in enumerate(zip(tp, tw)):
                assert _rel(got[f"p{j}"], p) < SERVE_TOL
                assert _rel(got[f"w{j}"], w) < SERVE_TOL


# -- the grid family ----------------------------------------------------------

def test_grid_dp_epoch_matches_jax(tmp_path):
    """One FNO2d epoch (2 steps of batch 8) over 2 gloo ranks (4 + 4 per
    step, gradients averaged) against JAX's single-device epoch and its
    data-parallel epoch on the 8-device mesh (tests/test_train.py:287-325);
    ``prefetch_to_device(sharding=mesh)`` yields each rank's block (checked
    in the worker)."""
    rng = np.random.default_rng(0)
    xb = rng.normal(size=(2, 8, 8, 8, 1)).astype(np.float32)
    yb = rng.normal(size=(2, 8, 8, 8, 1)).astype(np.float32)
    jm = JFNO2d(modes1=3, modes2=3, width=6, in_feats=1, spectral_impl="fft")
    jtr = JGridTrainer(jm, lr=LR, out_channels=1)
    params, opt = jtr.init(jax.random.PRNGKey(0), xb[0])
    p_ref, _, l_ref = jtr.epoch_stacked(params, opt, jnp.asarray(xb),
                                        jnp.asarray(yb))
    mesh = jmesh.make_mesh()
    xs, ys = jshard_grid_epoch(jnp.asarray(xb), jnp.asarray(yb), mesh)
    p_dp, _, l_dp = jtr.epoch_stacked(jmesh.replicate(params, mesh),
                                      jmesh.replicate(opt, mesh), xs, ys)
    arrays = {"xb": xb, "yb": yb,
              **{f"params/{k}": v for k, v in _flat(params).items()}}
    outs = _spawn("grid", 2, tmp_path, dict(fno=[3, 3, 6], lr=LR), arrays)
    got = _ranks_agree(outs, "")
    losses = got.pop("losses")
    got = {k[len("params/"):]: v for k, v in got.items()
           if k.startswith("params/")}
    for want_losses, want_params in ((l_ref, p_ref), (l_dp, p_dp)):
        np.testing.assert_allclose(losses, np.asarray(want_losses),
                                   rtol=1e-5)
        _assert_params(got, _flat(want_params), 1e-4, 1e-6)


# -- the scheduler and the CLI ---------------------------------------------------

SCHED_TRAIN = dict(epochs=2, batch_size=4, lr=2e-3, step_size=30, gamma=0.1,
                   log_interval=1, val_interval=1)


def test_scheduler_train_under_each_step_impl(tmp_path):
    """``PartitionScheduler.train`` over 2 gloo ranks with ``FESR_STEP_IMPL``
    unset, ``shard_map`` and ``shard_map_fused`` (float32): the checkpoint
    equals one process's training on the same batches, merged for the
    explicit-collective step and fused for the fused shard step; rank 1
    writes no file (checked in the worker)."""
    root = str(tmp_path / "ds")
    kw = dict(sub_size=4, n_high=(10, 5, 5), n_low=(6, 3, 3), num_cases=1)
    ds = SyntheticDataset(root=root, **kw)
    log_dir = str(tmp_path / "logs")
    impls = [None, "shard_map", "shard_map_fused"]
    outs = _spawn("sched", 2, tmp_path, dict(
        root=root, ds=kw, model=MODEL_KW, log_dir=log_dir, impls=impls,
        train=SCHED_TRAIN, watch=log_dir))
    singles = {}
    for layout in ("merged", "fused"):
        sched = PartitionScheduler(
            f"one_{layout}", 1, ds, init_model("neuralop", 4, 4, **MODEL_KW),
            train=True, log_dir=str(tmp_path / "one"), device="cpu",
            gemm_dtype="float32")
        sched.train(SCHED_TRAIN, layout=layout)
        singles[layout] = flatten_params(sched.experts[0].to_jax_params())
    for impl in impls:
        got = _ranks_agree(outs, f"{impl}/")
        want = singles["fused" if impl == "shard_map_fused" else "merged"]
        _assert_params(got, want, STEP_TOL["rtol"], STEP_TOL["atol"])
        assert os.path.exists(os.path.join(
            log_dir, "models", f"collection_mc_{impl}", "partition_0.npz"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_under_fesr_multihost(tmp_path):
    """``FESR_MULTIHOST=1`` with ``FESR_COORDINATOR``/``FESR_NUM_PROCESSES``/
    ``FESR_PROCESS_ID``: two processes run ``--mode=train`` then
    ``--mode=pred`` through ``runner.main`` (gloo: ``device: cpu``); rank 0
    alone writes the checkpoint, the metrics and a finite ``.vtu``."""
    cfg = dict(n_clusters=1, in_channels=4, out_channels=4, width=8,
               num_layers=2, root=str(tmp_path / "data"), idxs=[0],
               device="cpu", sub_size=4, n_high=[10, 5, 5], n_low=[6, 3, 3],
               num_cases=1)
    (tmp_path / "exp.yaml").write_text(yaml.safe_dump(cfg))
    (tmp_path / "train.yaml").write_text(yaml.safe_dump(SCHED_TRAIN))
    SyntheticDataset(**{k: cfg[k] for k in ("root", "sub_size", "n_high",
                                            "n_low", "num_cases")})
    argv = ["--model=neuralop", "--dataset=synthetic", "--exp_name=mc_cli",
            f"--exp_config={tmp_path / 'exp.yaml'}",
            f"--train_config={tmp_path / 'train.yaml'}"]
    logs = str(tmp_path / "logs")
    outs = _spawn("cli", 2, tmp_path, dict(
        argv=argv, ports=[_free_port(), _free_port()], watch=logs),
        env=dict(FESR_MULTIHOST="1", FESR_NUM_PROCESSES="2"))
    assert all(o["train/joined"] and o["pred/joined"] for o in outs)
    coll = os.path.join(logs, "models", "collection_mc_cli")
    assert os.path.exists(os.path.join(coll, "partition_0.npz"))
    assert os.path.exists(os.path.join(logs, "metrics",
                                       "mc_cli_partition_0.jsonl"))
    fields = read_vtu(os.path.join(logs, "vtk", "mc_cli", "pred_0.vtu"))
    assert all(np.all(np.isfinite(v)) for v in fields["point_data"].values())
