"""Port of the training slice: parallel/train.py (fused loss and gradients,
Trainer with Adam, LR schedules, split), PartitionScheduler.train and the
``--mode=train`` CLI, against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode and the port its
kernels' plain versions, both in float32 (``gemm_dtype``/``fused_dtype``),
so the comparison is of the algorithm, not of bf16 rounding.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_eng_super_resolution_tpu.core import checkpoint as jckpt
from fast_eng_super_resolution_tpu.core.graph import merge_batch, pad_and_bucket
from fast_eng_super_resolution_tpu.data.partition import extract_subdomains
from fast_eng_super_resolution_tpu.data.synthetic import make_sample_pair
from fast_eng_super_resolution_tpu.models.kernelnn import KernelNN as JKernelNN
from fast_eng_super_resolution_tpu.parallel import train as jtrain
from fast_eng_super_resolution_tpu.sched.scheduler import PartitionScheduler as JSched
from fast_eng_super_resolution_tpu_torch.core import checkpoint as tckpt
from fast_eng_super_resolution_tpu_torch.core import graph as tgraph
from fast_eng_super_resolution_tpu_torch.core.graph import Graph
from fast_eng_super_resolution_tpu_torch.data.dataset import SyntheticDataset
from fast_eng_super_resolution_tpu_torch.models.kernelnn import KernelNN
from fast_eng_super_resolution_tpu_torch.models.registry import init_model
from fast_eng_super_resolution_tpu_torch.parallel import train as ttrain
from fast_eng_super_resolution_tpu_torch.parallel.mesh import make_mesh
from fast_eng_super_resolution_tpu_torch.sched.scheduler import PartitionScheduler

CFG = dict(width=12, ker_width=8, depth=2, ker_in=1, in_width=4, out_width=4)
ROWS_BLK = 16


@pytest.fixture(scope="module")
def graph():
    """tests/test_fused.py:150-186's merged graph: two subdomains of a
    small synthetic duct."""
    s = make_sample_pair(n_high=(10, 5, 5), n_low=(6, 3, 3), seed=0)
    subs = extract_subdomains(s["pos"], s["mesh"].cells, s["x"], s["y"], 2,
                              "all_intersecting")
    raw = [dict(x=g.x, y=g.y, pos=g.pos, senders=g.senders,
                receivers=g.receivers, edge_attr=g.edge_attr,
                global_ids=g.global_node_ids) for g in subs]
    (_, _, batch), = pad_and_bucket(raw)
    merged, _ = merge_batch(batch)
    return merged


def _both(merged, seed=0, kernel_rank=None):
    """The JAX model, its params and fused batch, and the port's model
    (same params) and fused batch on the CPU."""
    jmodel = JKernelNN(mode="edge3d", kernel_rank=kernel_rank, **CFG)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(seed)))
    jbatch, rows_blk, blk = jtrain.make_fused_batch(merged, jmodel,
                                                    rows_blk=ROWS_BLK,
                                                    quantum=64)
    host = Graph(**{f.name: np.asarray(getattr(merged, f.name))
                    for f in dataclasses.fields(Graph)})
    model = KernelNN(kernel_rank=kernel_rank, **CFG).from_jax_params(params)
    tbatch, rb2, blk2 = ttrain.make_fused_batch(host, model, rows_blk=ROWS_BLK,
                                                quantum=64, device="cpu")
    assert (rb2, blk2) == (rows_blk, blk)
    return jmodel, params, jbatch, model, tbatch, blk


def _flat_grads(model):
    """The port's gradients keyed and laid out like the JAX tree's."""
    out = {}
    for name, p in model.named_parameters():
        key, transposed = model.jax_key(name)
        g = p.grad.numpy()
        out[key] = g.T if transposed else g
    return out


@pytest.mark.parametrize("kernel_rank", [None, 3])
def test_merged_fused_loss_and_grads_match_jax(graph, kernel_rank):
    jmodel, params, jbatch, model, tbatch, blk = _both(graph,
                                                       kernel_rank=kernel_rank)
    ref, ref_grads = jax.value_and_grad(
        lambda p: jtrain.merged_fused_loss(jmodel, p, jbatch, ROWS_BLK, blk,
                                           gemm_dtype="float32",
                                           interpret=True))(params)
    loss = ttrain.merged_fused_loss(model, tbatch, ROWS_BLK, blk,
                                    gemm_dtype="float32")
    loss.backward()
    # loss: float32 sums in other orders -> 1e-4 relative; grads: the JAX
    # package's own fused-vs-merged tolerances
    assert abs(float(loss.detach()) - float(ref)) <= 1e-4 * abs(float(ref))
    got = _flat_grads(model)
    want = tckpt.flatten_params(jax.tree_util.tree_map(np.asarray, ref_grads))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=5e-4, atol=5e-5,
                                   err_msg=key)


@pytest.mark.parametrize("kernel_rank", [None, 3, 16])
def test_fused_trainer_steps_match_jax(graph, kernel_rank):
    """Five Adam steps of the port's fused Trainer against the JAX
    package's, from the same params: per-step losses within 1e-4
    relative (Adam with optax's defaults on both sides)."""
    jmodel, params, jbatch, model, tbatch, blk = _both(graph, seed=1,
                                                       kernel_rank=kernel_rank)
    jt = jtrain.Trainer(jmodel, lr=2e-3, layout="fused", donate=False,
                        fused_rows_blk=ROWS_BLK, fused_blk=blk,
                        fused_dtype="float32", fused_interpret=True)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    o = jt.optimizer.init(p)
    tt = ttrain.Trainer(model, lr=2e-3, layout="fused",
                        fused_rows_blk=ROWS_BLK, fused_blk=blk,
                        fused_dtype="float32")
    opt = tt.init()
    for step in range(5):
        p, o, ref = jt.step(p, o, jbatch)
        got = tt.step(opt, tbatch)
        assert abs(float(got) - float(ref)) <= 1e-4 * abs(float(ref)), step
    # and evaluate/predict agree after the steps
    assert abs(tt.evaluate(tbatch) - jt.evaluate(p, jbatch)) <= \
        1e-4 * abs(jt.evaluate(p, jbatch))
    pred = tt.predict(tbatch).numpy()
    ref_pred = np.asarray(jt.predict(p, jbatch))
    assert np.abs(pred - ref_pred).max() <= 1e-4 * np.abs(ref_pred).max()


def test_merged_trainer_matches_jax(graph):
    """layout='merged' (plain whole-graph conv): loss and three steps."""
    jmodel, params, _, model, _, _ = _both(graph, seed=2)
    jt = jtrain.Trainer(jmodel, lr=1e-3, layout="merged", donate=False)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    o = jt.optimizer.init(p)
    tt = ttrain.Trainer(model, lr=1e-3, layout="merged")
    opt = tt.init()
    tgraph = Graph(**{f.name: torch.as_tensor(np.asarray(getattr(graph, f.name)))
                      for f in dataclasses.fields(Graph)})
    for step in range(3):
        p, o, ref = jt.step(p, o, graph)
        got = tt.step(opt, tgraph)
        assert abs(float(got) - float(ref)) <= 1e-4 * abs(float(ref)), step


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedules_and_split_match_jax(seed):
    rng = np.random.default_rng(seed)
    lr = float(rng.uniform(1e-4, 1e-2))
    step_size, total = int(rng.integers(1, 50)), int(rng.integers(1, 300))
    pairs = [(jtrain.StepLR(lr, step_size, 0.5), ttrain.StepLR(lr, step_size, 0.5)),
             (jtrain.CosineLR(lr, total, lr / 10), ttrain.CosineLR(lr, total, lr / 10))]
    for epoch in range(300):
        for a, b in pairs:
            assert a(epoch) == b(epoch)
    ja, ta = jtrain.ReduceLROnPlateau(lr), ttrain.ReduceLROnPlateau(lr)
    metrics = np.cumsum(rng.normal(size=300)) + 400.0
    for m in metrics:
        assert ja.update(float(m)) == ta.update(float(m))
    for n in (1, 5, 16, 300):
        for a, b in zip(jtrain.train_val_split(n, 0.2, seed),
                        ttrain.train_val_split(n, 0.2, seed)):
            np.testing.assert_array_equal(a, b)


def test_multi_device_layouts_raise():
    """The multi-device layouts, which raised until they were ported, run:
    on a one-device mesh the 'batched' layout and the explicit-collective
    step equal the merged step, the fused shard step equals the fused step,
    and an epoch over ``stack_batches``' stack equals one over the list
    (float32); an unknown layout raises.  Across ranks and against the JAX
    package: tests/test_torch_mesh.py and tests/test_torch_multidevice.py."""
    s = make_sample_pair(n_high=(10, 5, 5), n_low=(6, 3, 3), seed=0)
    subs = extract_subdomains(s["pos"], s["mesh"].cells, s["x"], s["y"], 2,
                              "all_intersecting")
    (_, _, batch), = tgraph.pad_and_bucket([dict(
        x=g.x, y=g.y, pos=g.pos, senders=g.senders, receivers=g.receivers,
        edge_attr=g.edge_attr, global_ids=g.global_node_ids) for g in subs])
    merged, _ = tgraph.merge_batch(batch)
    mesh = make_mesh("cpu")
    with pytest.raises(ValueError, match="unknown layout"):
        ttrain.Trainer(KernelNN(**CFG), lr=1e-3, layout="sharded")

    def run(layout, step_of, data, **kw):
        tr = ttrain.Trainer(KernelNN(**CFG), lr=1e-3, layout=layout,
                            fused_dtype="float32", **kw)
        opt = tr.init(0)
        losses = [float(step_of(tr)(opt, data)) for _ in range(2)]
        return losses, torch.cat([p.detach().reshape(-1)
                                  for p in tr.model.parameters()])

    ref = run("merged", lambda tr: tr.step, merged.to_torch("cpu"))
    for got in (run("batched", lambda tr: tr.step, batch.to_torch("cpu")),
                run("batched", lambda tr: tr.make_shard_map_step(mesh),
                    batch.to_torch("cpu"))):
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)
        torch.testing.assert_close(got[1], ref[1], rtol=1e-6, atol=1e-7)

    fb, rb, blk = ttrain.make_fused_batch(merged, KernelNN(**CFG),
                                          rows_blk=ROWS_BLK, device="cpu")
    sb, rb2, blk2 = ttrain.make_fused_shard_batches(
        batch, KernelNN(**CFG), 1, rows_blk=ROWS_BLK, device="cpu")
    assert (rb2, blk2) == (rb, blk)
    ref = run("fused", lambda tr: tr.step, fb, fused_rows_blk=rb,
              fused_blk=blk)
    got = run("batched",
              lambda tr: tr.make_fused_shard_map_step(mesh, rb, blk), sb)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-6, atol=1e-7)

    g = merged.to_torch("cpu")
    stacked = ttrain.stack_batches([merged, merged], device="cpu")
    assert stacked.x.shape == (2,) + tuple(g.x.shape)
    epochs = []
    for batches in ([g, g], stacked):
        tr = ttrain.Trainer(KernelNN(**CFG), lr=1e-3)
        opt = tr.init(0)
        epochs.append(tr.epoch(opt, batches, [1, 0]).numpy())
    np.testing.assert_array_equal(epochs[0], epochs[1])


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return SyntheticDataset(root=str(tmp_path_factory.mktemp("synth")),
                            sub_size=4, n_high=(10, 5, 5), n_low=(6, 3, 3),
                            num_cases=1)


TRAIN_CFG = dict(epochs=3, batch_size=8, lr=2e-3, step_size=30, gamma=0.1,
                 log_interval=1, val_interval=1)


@pytest.mark.parametrize("kernel_rank", [None, 3])
@pytest.mark.parametrize("layout", ["fused", "merged"])
def test_scheduler_train_writes_checkpoint_jax_serves(synth, tmp_path, layout,
                                                      kernel_rank):
    """train -> partition_0.npz that the JAX package loads and serves equal
    to the port's ``apply`` (and, through its scheduler, to the port's
    ``predict``); resume=True restores epoch and best_loss."""
    log_dir = str(tmp_path)
    model = init_model("neuralop", 4, 4, width=8, num_layers=2,
                       kernel_rank=kernel_rank)
    sched = PartitionScheduler("tr", 1, synth, model, train=True,
                               log_dir=log_dir, device="cpu",
                               gemm_dtype="float32")
    experts = sched.train(TRAIN_CFG, layout=layout)
    coll = os.path.join(log_dir, "models", "collection_tr")
    for f in ("partition_0.npz", "partition_0.pth", "partition_0_state.npz"):
        assert os.path.exists(os.path.join(coll, f)), f
    assert os.path.exists(os.path.join(log_dir, "metrics", "tr_partition_0.jsonl"))
    npz = os.path.join(coll, "partition_0.npz")
    assert jckpt.load_meta(npz)["model"] == "KernelNN"
    params = jckpt.load_params(npz)
    jmodel = JKernelNN(width=8, ker_width=8, depth=2, in_width=4,
                       out_width=4, mode="edge3d", kernel_rank=kernel_rank)
    g = synth.get(0)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(g["x"]),
                                  jnp.asarray(g["senders"]),
                                  jnp.asarray(g["receivers"]),
                                  jnp.asarray(g["edge_attr"])))
    with torch.no_grad():
        got = experts[0].apply(*(torch.as_tensor(np.asarray(g[k])) for k in
                                 ("x", "senders", "receivers", "edge_attr")))
    assert np.isfinite(ref).all()
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    # the JAX scheduler serves the port's checkpoint (its non-fused lane on
    # the CPU) as the port's scheduler does, float32 on both sides
    x = synth.get_one_full_sample(0)
    jpreds = JSched("tr", 1, synth, jmodel, train=False, log_dir=log_dir,
                    use_mesh=False).predict(x)[0]
    tpreds = PartitionScheduler("tr", 1, synth, model, train=False,
                                log_dir=log_dir, device="cpu",
                                gemm_dtype="float32").predict(x)[0]
    for a, b in zip(tpreds, jpreds):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()

    _, extra = tckpt.load_tree_like(os.path.join(coll, "partition_0_state.npz"),
                                    {"step": 0})
    saved_epoch, saved_best = int(extra["epoch"]), float(extra["best_loss"])
    resumed = PartitionScheduler("tr", 1, synth, model, train=True,
                                 log_dir=log_dir, device="cpu",
                                 gemm_dtype="float32")
    lines = []
    import builtins

    real_print = builtins.print
    builtins.print = lambda *a, **k: lines.append(" ".join(map(str, a)))
    try:
        resumed.train({**TRAIN_CFG, "epochs": 4}, layout=layout, resume=True)
    finally:
        builtins.print = real_print
    assert (f"Resuming partition 0 from epoch {saved_epoch + 1} "
            f"(best val {saved_best:g})") in lines


@pytest.mark.parametrize("env,want", [(None, None), ("1", None), ("0", "merged")])
def test_train_graph_aldd_layout_from_env(monkeypatch, tmp_path, env, want):
    """FESR_FUSED_TRAIN=0 selects 'merged'; otherwise the scheduler takes
    its device's default layout."""
    from fast_eng_super_resolution_tpu_torch import runner

    seen = []
    monkeypatch.setattr(PartitionScheduler, "train",
                        lambda self, cfg, **kw: seen.append(kw["layout"]))
    if env is None:
        monkeypatch.delenv("FESR_FUSED_TRAIN", raising=False)
    else:
        monkeypatch.setenv("FESR_FUSED_TRAIN", env)
    runner.train_graph_ALDD("env", KernelNN(**CFG), [], 1, TRAIN_CFG,
                            log_dir=str(tmp_path), device="cpu")
    assert seen == [want]


def _toy_graph(n, senders, receivers, seed):
    rng = np.random.default_rng(seed)
    e = len(senders)
    return Graph(x=rng.normal(size=(n, 4)).astype(np.float32),
                 y=rng.normal(size=(n, 4)).astype(np.float32),
                 pos=rng.normal(size=(n, 3)).astype(np.float32),
                 senders=np.asarray(senders, np.int32),
                 receivers=np.asarray(receivers, np.int32),
                 edge_attr=rng.uniform(size=(e, 1)).astype(np.float32),
                 node_mask=np.ones(n, bool), edge_mask=np.ones(e, bool),
                 global_ids=np.arange(n, dtype=np.int32))


def test_make_fused_batches_share_one_block_geometry():
    """A chain (blk 256) and a hub with 300 in-edges (blk 512) both get
    blk 512, each equal to make_fused_batch's at that quantum."""
    chain = _toy_graph(40, np.arange(1, 40), np.arange(39), 0)
    hub = _toy_graph(40, np.arange(300) % 39 + 1, np.zeros(300), 1)
    model = KernelNN(**CFG)
    blks = [ttrain.make_fused_batch(g, model, ROWS_BLK, device="cpu")[2]
            for g in (chain, hub)]
    assert blks == [256, 512]
    fbs, rows_blk, blk = ttrain.make_fused_batches([chain, hub], model,
                                                   ROWS_BLK, "cpu")
    assert (rows_blk, blk) == (ROWS_BLK, 512)
    for g, fb in zip((chain, hub), fbs):
        want, _, _ = ttrain.make_fused_batch(g, model, ROWS_BLK, blk, "cpu")
        assert len(fb["fused"]["s"].slot_rows) % blk == 0
        for k in ("senders_perm", "senders_dump"):
            torch.testing.assert_close(fb["fused"]["aux"][k],
                                       want["fused"]["aux"][k])
        torch.testing.assert_close(fb["fused"]["s"].row_weight,
                                   want["fused"]["s"].row_weight)


def test_optimizer_state_round_trips(tmp_path):
    """Adam's moments, step and LR survive save_tree/load_tree_like in the
    JAX parameter-tree layout."""
    model = KernelNN(**CFG)
    trainer = ttrain.Trainer(model, lr=1e-3)
    opt = trainer.init(seed=3)
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    trainer.set_lr(opt, 5e-4)
    tree = trainer.state_tree(opt)
    assert tree["exp_avg"]["fc1"]["w"].shape == (CFG["in_width"], CFG["width"])
    path = str(tmp_path / "state.npz")
    tckpt.save_tree(path, tree, extra={"epoch": 7, "best_loss": 0.25})
    back, extra = tckpt.load_tree_like(path, tree)
    assert int(extra["epoch"]) == 7 and float(extra["best_loss"]) == 0.25
    opt2 = trainer.init()
    trainer.load_state_tree(opt2, back)
    assert trainer.get_lr(opt2) == pytest.approx(5e-4)
    for p in model.parameters():
        for slot in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(opt2.state[p][slot], opt.state[p][slot])


@pytest.mark.parametrize("kernel_rank", [None, 3])
def test_cli_train_on_cpu(tmp_path, monkeypatch, kernel_rank):
    """``python -m fast_eng_super_resolution_tpu_torch --mode=train`` flow
    (runner.main) with ``device: cpu`` in the exp config, restricted to
    ``train_meshes``; the trained checkpoint then serves with --mode=pred.
    ``kernel_rank`` in the exp config reaches the model."""
    import yaml

    from fast_eng_super_resolution_tpu_torch.data.vtu import read_vtu
    from fast_eng_super_resolution_tpu_torch.runner import main
    from fast_eng_super_resolution_tpu_torch.utils.config import parse_args

    monkeypatch.chdir(tmp_path)
    cfg = dict(n_clusters=1, in_channels=4, out_channels=4, width=8,
               num_layers=2, root=str(tmp_path / "data"), idxs=[1],
               device="cpu", sub_size=4, n_high=[10, 5, 5], n_low=[6, 3, 3],
               num_cases=2, train_meshes=[0])
    if kernel_rank is not None:
        cfg["kernel_rank"] = kernel_rank
    (tmp_path / "exp.yaml").write_text(yaml.safe_dump(cfg))
    (tmp_path / "train.yaml").write_text(yaml.safe_dump(
        {**TRAIN_CFG, "epochs": 2}))
    argv = ["--model=neuralop", "--dataset=synthetic", "--exp_name=cli",
            "--exp_config=exp.yaml", "--train_config=train.yaml"]
    sched = main(parse_args(argv + ["--mode=train"]))
    assert sched.model.kernel_rank == kernel_rank
    assert len(sched.dataset) == len(sched.dataset.dataset.mesh_subdomain_indices(0))
    assert os.path.exists(os.path.join("logs", "models", "collection_cli",
                                       "partition_0.npz"))
    paths = main(parse_args(argv + ["--mode=pred"]))
    fields = read_vtu(paths[0])["point_data"]
    assert all(np.all(np.isfinite(v)) for v in fields.values())
