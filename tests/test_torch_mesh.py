"""The port's mesh helpers and multi-device host prep against the JAX
package's, in one process on the CPU: ``pad_batch_to_multiple``,
``stack_batches``, ``make_fused_shard_batches`` (dense and compact S, with
and without the graph), the rank blocks of ``local_block`` against
``P('data')``'s shards on the virtual CPU devices, the 'batched' layout's
loss and gradients against ``batched_loss``, and the process-group
bring-up's refusals (no gloo in NCCL's place, no CUDA default without a
card).  The ranks themselves: tests/test_torch_multidevice.py.

Tolerances: host prep is compared bit for bit; the batched loss (float32,
the same sums in other orders) to 1e-5 relative and its gradients to 1e-4
of each leaf's max, as tests/test_torch_train.py holds the merged layout.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from fast_eng_super_resolution_tpu.core import checkpoint as jckpt
from fast_eng_super_resolution_tpu.core.graph import pad_and_bucket as jpad
from fast_eng_super_resolution_tpu.data.partition import extract_subdomains
from fast_eng_super_resolution_tpu.data.synthetic import make_sample_pair
from fast_eng_super_resolution_tpu.models.kernelnn import KernelNN as JKernelNN
from fast_eng_super_resolution_tpu.parallel import mesh as jmesh
from fast_eng_super_resolution_tpu.parallel import train as jtrain
from fast_eng_super_resolution_tpu_torch.core.graph import Graph
from fast_eng_super_resolution_tpu_torch.models.kernelnn import KernelNN
from fast_eng_super_resolution_tpu_torch.parallel import mesh as tmesh
from fast_eng_super_resolution_tpu_torch.parallel import train as ttrain
from fast_eng_super_resolution_tpu_torch.utils import env

CFG = dict(width=8, ker_width=8, depth=2, ker_in=1, in_width=4, out_width=4)
FIELDS = [f.name for f in dataclasses.fields(Graph)]


@pytest.fixture(scope="module")
def jbatch():
    """Five subdomains of a small synthetic duct as a JAX host batch."""
    s = make_sample_pair(n_high=(12, 6, 6), n_low=(6, 3, 3))
    subs = extract_subdomains(s["pos"], s["mesh"].cells, s["x"], s["y"], 5,
                              "all_intersecting")
    raw = [dict(x=g.x, y=g.y, pos=g.pos, senders=g.senders,
                receivers=g.receivers, edge_attr=g.edge_attr,
                global_ids=g.global_node_ids) for g in subs]
    (_, _, b), = jpad(raw, to_device=False)
    return jax.tree_util.tree_map(np.asarray, b)


def _port(jb) -> Graph:
    return Graph(**{k: np.asarray(getattr(jb, k)) for k in FIELDS})


def _same(got, want) -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("multiple", [1, 2, 4, 5])
def test_pad_batch_to_multiple_matches_jax(jbatch, multiple):
    jp, jreal = jmesh.pad_batch_to_multiple(jbatch, multiple)
    tp, treal = tmesh.pad_batch_to_multiple(_port(jbatch), multiple)
    assert treal == jreal == 5
    for k in FIELDS:
        _same(getattr(tp, k), getattr(jp, k))
    if multiple > 1 and 5 % multiple:
        assert not tp.node_mask[5:].any() and not tp.edge_mask[5:].any()


def test_local_block_is_the_data_axis_shard(jbatch):
    """Rank r's block of a [B, ...] batch is device r's shard of
    ``P('data')`` on a mesh of as many devices."""
    jp, _ = jmesh.pad_batch_to_multiple(jbatch, 4)
    mesh = jmesh.make_mesh(jax.devices()[:4])
    placed = jax.device_put(jnp.asarray(jp.x), NamedSharding(mesh, P("data")))
    shards = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    tp, _ = tmesh.pad_batch_to_multiple(_port(jbatch), 4)
    for r, dev in enumerate(jax.devices()[:4]):
        fake = tmesh.Mesh(4, r, torch.device("cpu"))
        _same(tmesh.local_block(tp, fake).x, shards[dev])
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.local_block(_port(jbatch), tmesh.Mesh(2, 0, torch.device("cpu")))


def test_one_device_mesh():
    """Without a process group the mesh is this device alone: its
    collectives are identities and ``shard_batch`` uploads the whole
    batch; several devices for one process are refused."""
    mesh = tmesh.make_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.device) == (1, 0, torch.device("cpu"))
    assert tmesh.make_mesh(["cpu"]) == mesh
    t = torch.arange(6.0)
    assert mesh.all_reduce(t, "max") is t and mesh.all_gather(t) is t
    assert torch.equal(mesh.broadcast_(t.clone()), t)
    got = tmesh.shard_batch({"a": np.ones((3, 2)), "b": [np.arange(3)]}, mesh)
    assert torch.equal(got["b"][0], torch.arange(3))
    model = KernelNN(**CFG)
    before = [p.detach().clone() for p in model.parameters()]
    assert tmesh.replicate(model, mesh) is model
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))
    with pytest.raises(ValueError, match="one process per device"):
        tmesh.make_mesh(["cpu", "cpu"])
    assert env.is_primary()


def test_stack_batches_matches_jax(jbatch):
    tb = _port(jbatch)
    two = jax.tree_util.tree_map(lambda a: a[:2], jbatch)
    jst = jtrain.stack_batches([jbatch, jbatch])
    tst = ttrain.stack_batches([tb, tb], device="cpu")
    for k in FIELDS:
        _same(getattr(tst, k), getattr(jst, k))
    assert ttrain.stack_batches([tb, tb.map(lambda a: a[:2])]) is None
    assert jtrain.stack_batches([jbatch, two]) is None
    assert ttrain.stack_batches([]) is None is jtrain.stack_batches([])
    d = {"x": np.ones((2, 3)), "i": np.arange(2)}
    st = ttrain.stack_batches([d, d], device="cpu")
    assert st["x"].shape == (2, 2, 3) and st["i"].dtype == torch.int64
    assert ttrain.stack_batches([d, {"x": d["x"]}], device="cpu") is None


@pytest.mark.parametrize("with_graph", [True, False])
@pytest.mark.parametrize("expand_s", [True, False])
def test_fused_shard_batches_match_jax(jbatch, expand_s, with_graph):
    """``make_fused_shard_batches`` over 2 groups (the batch padded to 6)
    gives JAX's operands bit for bit: the stacked merged graphs, blocked
    edge attributes, aux (only ``senders_perm`` without the graph), and S
    dense or as its compact generators."""
    jp, _ = jmesh.pad_batch_to_multiple(jbatch, 2)
    jm = JKernelNN(mode="edge3d", **CFG)
    jd, jrb, jblk = jtrain.make_fused_shard_batches(
        jp, jm, 2, rows_blk=16, with_graph=with_graph, expand_s=expand_s)
    td, trb, tblk = ttrain.make_fused_shard_batches(
        _port(jp), KernelNN(**CFG), 2, rows_blk=16, with_graph=with_graph,
        expand_s=expand_s, device="cpu")
    assert (trb, tblk) == (jrb, jblk)
    if with_graph:
        for k in FIELDS:
            _same(getattr(td["graph"], k), getattr(jd["graph"], k))
    else:
        assert td["graph"] is None and jd["graph"] is None
    jf, tf = jd["fused"], td["fused"]
    _same(tf["edge_attr"], jf["edge_attr"])
    assert tf["aux"].keys() == jf["aux"].keys()
    for k in jf["aux"]:
        _same(tf["aux"][k], jf["aux"][k])
    if expand_s:
        assert "s_compact" not in tf and "s_compact" not in jf
        _same(tf["s"], jf["s"])
    else:
        assert "s" not in tf and "s" not in jf
        for k in ("slot_rows", "row_weight"):
            _same(tf["s_compact"][k], jf["s_compact"][k])
    with pytest.raises(ValueError, match="groups"):
        ttrain.make_fused_shard_batches(_port(jbatch), KernelNN(**CFG), 2,
                                        device="cpu")


def test_batched_layout_matches_jax(jbatch):
    """``Trainer(layout='batched')``: the loss of a [B, ...] batch and its
    gradients equal JAX's ``batched_loss`` (the vmapped per-graph parts),
    and ``predict`` gives [B, N, C]."""
    jm = JKernelNN(mode="edge3d", **CFG)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    jb = jax.tree_util.tree_map(jnp.asarray, jbatch)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtrain.batched_loss(jm, p, jb))(params)
    model = KernelNN(**CFG).from_jax_params(params)
    tr = ttrain.Trainer(model, lr=1e-3, layout="batched")
    tb = _port(jbatch).to_torch("cpu")
    loss = tr.loss(tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert abs(ttrain.batched_loss(model, tb).item() - float(jloss)) \
        <= 1e-5 * abs(float(jloss))
    flat = jckpt.flatten_params(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        key, transposed = model.jax_key(name)
        want = flat[key]
        g = p.grad.numpy()
        g = g.T if transposed else g
        assert np.abs(g - want).max() <= 1e-4 * max(np.abs(want).max(), 1e-12)
    assert tr.predict(tb).shape == tuple(jbatch.y.shape)
    assert tr.evaluate(tb) == pytest.approx(float(jloss), rel=1e-5)


def test_no_gloo_in_place_of_nccl(monkeypatch, tmp_path):
    """NCCL is never replaced by gloo: asking for it off a card raises, and
    the default device needs CUDA; nothing joins a group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    init = f"file://{tmp_path / 'pg'}"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        env.init_distributed(0, 1, init, backend="nccl")
    with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
        env.init_distributed(0, 1, init, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="expected nccl | gloo"):
        env.init_distributed(0, 1, init, backend="mpi", device="cpu")
    for var in ("FESR_MULTIHOST", "WORLD_SIZE", "FESR_COORDINATOR",
                "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert env.maybe_init_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="FESR_MULTIHOST=1"):
        env.maybe_init_distributed()
    monkeypatch.setenv("FESR_MULTIHOST", "1")
    with pytest.raises(ValueError, match="FESR_COORDINATOR"):
        env.maybe_init_distributed()
    monkeypatch.setenv("FESR_COORDINATOR", init)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        env.maybe_init_distributed()
    assert not torch.distributed.is_initialized()
