"""Port of models/graphsage.py: JAX parameters carried into the port give
the JAX GraphSAGE's outputs (masked edges included) and gradients; a legacy
``lin_r`` bias is honoured; the registry builds 5 layers as the JAX
package's; the merged Trainer steps as JAX's; a GraphSAGE trained by the
port's scheduler (merged layout) serves through the general lane and on the
JAX package's scheduler to the same field."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_random_graph
from fast_eng_super_resolution_tpu.core import checkpoint as jckpt
from fast_eng_super_resolution_tpu.core.graph import merge_batch, pad_and_bucket
from fast_eng_super_resolution_tpu.data.partition import extract_subdomains
from fast_eng_super_resolution_tpu.data.synthetic import make_sample_pair
from fast_eng_super_resolution_tpu.models.graphsage import GraphSAGE as JSAGE
from fast_eng_super_resolution_tpu.models.registry import init_model as jinit
from fast_eng_super_resolution_tpu.parallel import train as jtrain
from fast_eng_super_resolution_tpu.sched.scheduler import PartitionScheduler as JSched
from fast_eng_super_resolution_tpu_torch.core.graph import Graph
from fast_eng_super_resolution_tpu_torch.data.dataset import SyntheticDataset
from fast_eng_super_resolution_tpu_torch.data.reconstruct import overlap_average
from fast_eng_super_resolution_tpu_torch.models.graphsage import GraphSAGE
from fast_eng_super_resolution_tpu_torch.models.registry import init_model
from fast_eng_super_resolution_tpu_torch.parallel import train as ttrain
from fast_eng_super_resolution_tpu_torch.sched.scheduler import (
    PartitionScheduler, _train_layout)

# float32 on both sides, sums in other orders: forward 1e-5 of the max,
# gradients 1e-4 (relative norm), served fields 1e-4 of the max
TOL = 1e-5
GRAD_TOL = 1e-4
SERVE_TOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b) -> float:
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def _graph(seed=0):
    g = make_random_graph(np.random.default_rng(seed), n=40, e=200)
    mask = np.random.default_rng(seed + 1).random(200) > 0.25
    return g, mask


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("num_layers", [1, 5])
def test_apply_matches_jax(num_layers):
    jm = JSAGE(4, 4, num_layers)
    params = _np(jm.init(jax.random.PRNGKey(2)))
    g, mask = _graph()
    args = (g["x"], g["senders"], g["receivers"], g["edge_attr"])
    ref = np.asarray(jm.apply(params, *args, edge_mask=mask))
    model = GraphSAGE(4, 4, num_layers).from_jax_params(params)
    with torch.no_grad():
        got = model.apply(*_t(*args), edge_mask=torch.as_tensor(mask))
    assert _rel(got.numpy(), ref) < TOL
    # and the parameter tree round-trips
    back = model.to_jax_params()
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        assert np.array_equal(a, b)


def test_grads_match_jax():
    """d(sum(out * cot))/d(params, x) against ``jax.grad``."""
    jm = JSAGE(4, 4, 5)
    params = _np(jm.init(jax.random.PRNGKey(5)))
    g, mask = _graph(3)
    cot = np.random.default_rng(4).normal(size=(40, 4)).astype(np.float32)

    def loss(p, x):
        out = jm.apply(p, x, g["senders"], g["receivers"], edge_mask=mask)
        return jnp.sum(out * cot)

    want_p, want_x = jax.grad(loss, argnums=(0, 1))(params, g["x"])
    want_p = jckpt.flatten_params(_np(want_p))
    model = GraphSAGE(4, 4, 5).from_jax_params(params)
    x = torch.tensor(g["x"], requires_grad=True)
    out = model.apply(x, *_t(g["senders"], g["receivers"]),
                      edge_mask=torch.as_tensor(mask))
    (out * torch.as_tensor(cot)).sum().backward()
    for name, p in model.named_parameters():
        key, transposed = model.jax_key(name)
        got = p.grad.numpy().T if transposed else p.grad.numpy()
        err = np.linalg.norm(got - want_p[key]) / np.linalg.norm(want_p[key])
        assert err < GRAD_TOL, (key, err)
    err = (np.linalg.norm(x.grad.numpy() - np.asarray(want_x))
           / np.linalg.norm(want_x))
    assert err < GRAD_TOL


def test_legacy_lin_r_bias_is_honoured():
    """A tree whose ``lin_r`` carries a bias (the JAX package's older
    checkpoints) predicts as JAX predicts it, and saves the bias back."""
    jm = JSAGE(4, 4, 2)
    params = _np(jm.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(0)
    params["layers"][1]["lin_r"]["b"] = rng.normal(size=4).astype(np.float32)
    g, mask = _graph(2)
    args = (g["x"], g["senders"], g["receivers"])
    ref = np.asarray(jm.apply(params, *args, edge_mask=mask))
    model = GraphSAGE(4, 4, 2).from_jax_params(params)
    assert model.layers[0].lin_r.bias is None
    with torch.no_grad():
        got = model.apply(*_t(*args), edge_mask=torch.as_tensor(mask))
    assert _rel(got.numpy(), ref) < TOL
    assert np.array_equal(model.to_jax_params()["layers"][1]["lin_r"]["b"],
                          params["layers"][1]["lin_r"]["b"])
    with pytest.raises(ValueError, match="layers"):
        GraphSAGE(4, 4, 3).from_jax_params(params)


def test_registry_builds_five_layers_and_layout_gate():
    model = init_model("graphsage", 4, 3)
    ref = jinit("graphsage", 4, 3)
    assert model.num_layers == ref.num_layers == 5
    assert [tuple(p.shape) for p in model.parameters()] == [
        (3, 4), (3,), (3, 4)] + [(3, 3), (3,), (3, 3)] * 4
    assert not model.fused_ok and not hasattr(model, "apply_fused")
    assert _train_layout(model, torch.device("cuda")) == "merged"


@pytest.fixture(scope="module")
def merged():
    s = make_sample_pair(n_high=(10, 5, 5), n_low=(6, 3, 3), seed=0)
    subs = extract_subdomains(s["pos"], s["mesh"].cells, s["x"], s["y"], 2,
                              "all_intersecting")
    raw = [dict(x=g.x, y=g.y, pos=g.pos, senders=g.senders,
                receivers=g.receivers, edge_attr=g.edge_attr,
                global_ids=g.global_node_ids) for g in subs]
    (_, _, batch), = pad_and_bucket(raw)
    return merge_batch(batch)[0]


def test_merged_trainer_steps_match_jax(merged):
    """Three Adam steps of the port's merged Trainer against the JAX
    package's from the same params: losses within 1e-4 relative."""
    jm = JSAGE(4, 4, 5)
    params = _np(jm.init(jax.random.PRNGKey(7)))
    jt = jtrain.Trainer(jm, lr=1e-3, layout="merged", donate=False)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    o = jt.optimizer.init(p)
    host = Graph(**{f: np.asarray(getattr(merged, f))
                    for f in Graph.__dataclass_fields__})
    model = GraphSAGE(4, 4, 5).from_jax_params(params)
    tt = ttrain.Trainer(model, lr=1e-3, layout="merged")
    opt = tt.init()
    batch = host.to_torch("cpu")
    for step in range(3):
        p, o, ref = jt.step(p, o, merged)
        got = tt.step(opt, batch)
        assert abs(float(got) - float(ref)) <= 1e-4 * abs(float(ref)), step


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return SyntheticDataset(root=str(tmp_path_factory.mktemp("synth")),
                            sub_size=4, n_high=(10, 5, 5), n_low=(6, 3, 3),
                            num_cases=1)


def test_scheduler_trains_and_serves_general_lane_as_jax(synth, tmp_path):
    """As tests/test_scheduler.py:136 for the JAX package: the port's
    scheduler trains a GraphSAGE (merged layout, the default the gate
    picks), writes no ``.pth`` (the model has no reference layout), and its
    checkpoint serves through the general lane to the field the JAX
    package's scheduler serves from it."""
    log_dir = str(tmp_path)
    cfg = dict(epochs=2, batch_size=8, lr=1e-3, step_size=30, gamma=0.1,
               log_interval=10, val_interval=1)
    sched = PartitionScheduler("sage", 1, synth, init_model("graphsage", 4, 4),
                               train=True, log_dir=log_dir, device="cpu")
    sched.train(cfg)
    coll = os.path.join(log_dir, "models", "collection_sage")
    assert sorted(f for f in os.listdir(coll) if f.startswith("partition_0")
                  ) == ["partition_0.npz", "partition_0_state.npz"]
    x = synth.get_one_full_sample(0)
    n = len(synth.full_mesh(0)["points"])
    gids = [d["global_node_ids"] for d in x]
    serve = PartitionScheduler("sage", 1, synth, init_model("graphsage", 4, 4),
                               train=False, log_dir=log_dir, device="cpu")
    assert serve.predict_full(x, n) is None
    assert serve.last_lane == ("general", "model has no fused kernel")
    got = overlap_average(serve.predict(x)[0], gids, n)
    jsched = JSched("sage", 1, synth, jinit("graphsage", 4, 4), train=False,
                    log_dir=log_dir, use_mesh=False)
    ref = overlap_average([np.asarray(p) for p in jsched.predict(x)[0]],
                          gids, n)
    assert np.isfinite(got).all()
    assert _rel(got, ref) < SERVE_TOL
