"""Port of models/teecnet.py: JAX parameters carried into the port give the
JAX TEECNet's outputs in each conv mode, through the fused layer and its
gradients; the weight layouts round-trip with their width and fc1 checks; the
fused trainer steps as the JAX package's; a TEECNet trained by the port's
scheduler is served by the JAX package's, and ``--model=teecnet`` runs
through the CLI.

TEECNet has no nonlinearity between layers, so outputs are compared
relative to their max.  Float32 on both sides (``gemm_dtype``) compares the
algorithm; bf16 is held to 2e-2, since the JAX fused layer rounds each x·W
product to bf16 and the port's plain version does not.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from conftest import make_random_graph
from fast_eng_super_resolution_tpu.core import checkpoint as jckpt
from fast_eng_super_resolution_tpu.core.graph import merge_batch, pad_and_bucket, pad_graph
from fast_eng_super_resolution_tpu.data.partition import extract_subdomains
from fast_eng_super_resolution_tpu.data.synthetic import make_sample_pair
from fast_eng_super_resolution_tpu.models.teecnet import TEECNet as JTEECNet
from fast_eng_super_resolution_tpu.parallel import train as jtrain
from fast_eng_super_resolution_tpu.sched.scheduler import PartitionScheduler as JSched
from fast_eng_super_resolution_tpu_torch.core.checkpoint import flatten_params
from fast_eng_super_resolution_tpu_torch.core.graph import Graph
from fast_eng_super_resolution_tpu_torch.data.dataset import SyntheticDataset
from fast_eng_super_resolution_tpu_torch.models.registry import init_model
from fast_eng_super_resolution_tpu_torch.models.teecnet import TEECNet
from fast_eng_super_resolution_tpu_torch.ops.fused_conv import CompactS
from fast_eng_super_resolution_tpu_torch.parallel import train as ttrain
from fast_eng_super_resolution_tpu_torch.sched.scheduler import PartitionScheduler

CFG = dict(in_channels=4, width=8, out_channels=4, num_layers=2)
# float32 on both sides, sums in other orders, two linear layers: 1e-5 of
# the max per output
TOL = 1e-5
BF16_TOL = 2e-2


def _jax_model_and_params(seed=0, mode="edge3d"):
    model = JTEECNet(mode=mode, **CFG)
    params = jax.tree_util.tree_map(np.asarray,
                                    model.init(jax.random.PRNGKey(seed)))
    return model, params


def _port(params, mode="auto"):
    return TEECNet(mode=mode, **CFG).from_jax_params(params)


def _padded_graph(seed=0):
    g = make_random_graph(np.random.default_rng(seed), n=120, e=700)
    return pad_graph(g["x"], g["y"], g["pos"], g["senders"], g["receivers"],
                     g["edge_attr"], 128, 1024)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


def _t(*arrays):
    return tuple(torch.as_tensor(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("mode", ["edge3d", "factored", "pallas", "lut",
                                  "edge"])
def test_apply_matches_jax(mode):
    model, params = _jax_model_and_params(mode=mode)
    g = _padded_graph()
    args = (g.x, g.senders, g.receivers, g.edge_attr)
    with pltpu.force_tpu_interpret_mode():
        ref = model.apply(params, *(jnp.asarray(a) for a in args),
                          edge_mask=jnp.asarray(g.edge_mask))
    with torch.no_grad():
        got = _port(params, mode).apply(*_t(*args),
                                        edge_mask=torch.as_tensor(g.edge_mask))
    assert np.isfinite(np.asarray(ref)).all()
    assert _rel(got.numpy(), ref) < TOL


@pytest.mark.parametrize("gemm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compact", [True, False])
def test_apply_fused_matches_jax(compact, gemm_dtype):
    model, params = _jax_model_and_params(1)
    g = _padded_graph(1)
    ea_b, sp, s, rows_blk, blk = model.prepare_fused(
        g.senders, g.receivers, g.edge_attr, 128, g.edge_mask)
    ref = model.apply_fused(params, jnp.asarray(g.x), jnp.asarray(ea_b),
                            jnp.asarray(sp), jnp.asarray(s), rows_blk=rows_blk,
                            blk=blk, gemm_dtype=gemm_dtype, interpret=True)
    port = _port(params)
    ea_t, sp_t, s_t, rb, bk = port.prepare_fused(
        g.senders, g.receivers, g.edge_attr, 128, g.edge_mask,
        compact=compact)
    s_t = s_t.to("cpu") if isinstance(s_t, CompactS) else torch.as_tensor(s_t)
    with torch.no_grad():
        got = port.apply_fused(torch.as_tensor(g.x), torch.as_tensor(ea_t),
                               torch.as_tensor(sp_t), s_t, rows_blk=rb,
                               blk=bk, gemm_dtype=gemm_dtype)
        plain = port.apply(*_t(g.x, g.senders, g.receivers, g.edge_attr),
                           edge_mask=torch.as_tensor(g.edge_mask))
    tol = TOL if gemm_dtype == "float32" else BF16_TOL
    assert _rel(got.numpy(), ref) < tol
    assert _rel(got.numpy(), plain.numpy()) < tol


def test_apply_fused_ad_grads_match_jax():
    """float32 ``apply_fused_ad`` (B1's and B2's plain versions) against
    ``jax.grad`` of the JAX model's plain ``apply``, same weights: loss
    within 1e-5 relative, each gradient within 1e-4 of its norm."""
    model, params = _jax_model_and_params(3)
    g = _padded_graph(3)
    y = np.random.default_rng(3).normal(size=g.x.shape).astype(np.float32)

    def loss_jax(p):
        out = model.apply(p, jnp.asarray(g.x), jnp.asarray(g.senders),
                          jnp.asarray(g.receivers), jnp.asarray(g.edge_attr),
                          edge_mask=jnp.asarray(g.edge_mask))
        return jnp.sum((out - y) ** 2)

    ref, ref_grads = jax.value_and_grad(loss_jax)(params)
    port = _port(params)
    ea, aux, s, rows_blk, blk = port.prepare_fused_train(
        g.senders, g.receivers, g.edge_attr, g.x.shape[0], g.edge_mask,
        compact=True)
    out = port.apply_fused_ad(
        torch.as_tensor(g.x), torch.as_tensor(ea),
        {k: torch.as_tensor(v) for k, v in aux.items()}, s.to("cpu"),
        rows_blk=rows_blk, blk=blk, gemm_dtype="float32")
    loss = ((out - torch.as_tensor(y)) ** 2).sum()
    loss.backward()
    assert abs(float(loss.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    want = flatten_params(jax.tree_util.tree_map(np.asarray, ref_grads))
    names = [name for name, _ in port.named_parameters()]
    assert sorted(port.jax_key(n)[0] for n in names) == sorted(want)
    for name, p in port.named_parameters():
        key, transposed = port.jax_key(name)
        got = p.grad.numpy().T if transposed else p.grad.numpy()
        err = np.linalg.norm(got - want[key]) / np.linalg.norm(want[key])
        assert err < 1e-4, (key, err)


def test_edge_mode_grads_match_jax():
    """TEECNet in conv mode 'edge': ``jax.grad`` of the JAX model's
    ``apply`` in the same mode against the port's autograd, same weights,
    float32: loss within 1e-5 relative, each gradient within 1e-4 of its
    norm."""
    model, params = _jax_model_and_params(6, mode="edge")
    g = _padded_graph(6)
    y = np.random.default_rng(6).normal(size=g.x.shape).astype(np.float32)
    args = (g.x, g.senders, g.receivers, g.edge_attr)

    def loss_jax(p):
        out = model.apply(p, *(jnp.asarray(a) for a in args),
                          edge_mask=jnp.asarray(g.edge_mask))
        return jnp.sum((out - y) ** 2)

    ref, ref_grads = jax.value_and_grad(loss_jax)(params)
    port = _port(params, "edge")
    out = port.apply(*_t(*args), edge_mask=torch.as_tensor(g.edge_mask))
    loss = ((out - torch.as_tensor(y)) ** 2).sum()
    loss.backward()
    assert abs(float(loss.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    want = flatten_params(jax.tree_util.tree_map(np.asarray, ref_grads))
    for name, p in port.named_parameters():
        key, transposed = port.jax_key(name)
        got = p.grad.numpy().T if transposed else p.grad.numpy()
        err = np.linalg.norm(got - want[key]) / np.linalg.norm(want[key])
        assert err < 1e-4, (key, err)


@pytest.mark.parametrize("kernel_dtype", [None, "bfloat16"])
def test_edge_mode_conv_layer_matches_jax(kernel_dtype):
    """One TEECNet-shaped conv layer in mode 'edge' (LeakyReLU operator
    kernel, root on the pre-linear features) from a precomputed kernel,
    float32 and bf16 per-edge matrices (the JAX TEECNet has no
    ``kernel_dtype``; the layer takes one): output within 1e-5 of its max,
    the gradients of x and of every kernel layer within 1e-4 of their
    norms; and the port's contraction fed JAX's own precomputed matrices
    (the same bf16 values) within 1e-5 of the max."""
    from fast_eng_super_resolution_tpu.ops import message_passing as jmp
    from fast_eng_super_resolution_tpu_torch.models.teecnet import _leaky_relu
    from fast_eng_super_resolution_tpu_torch.ops import message_passing as tmp

    rng = np.random.default_rng(8)
    g = _padded_graph(8)
    c, sizes = 6, [1, 16, 6 * 6]
    x = rng.normal(size=(g.x.shape[0], c)).astype(np.float32)
    xr = rng.normal(size=(g.x.shape[0], c)).astype(np.float32)
    root = (rng.normal(size=(c, c)) * 0.3).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    layers = [((rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32),
               (rng.normal(size=(b,)) * 0.1).astype(np.float32))
              for a, b in zip(sizes[:-1], sizes[1:])]
    tgt = rng.normal(size=(g.x.shape[0], c)).astype(np.float32)
    graph = (g.senders, g.receivers, g.edge_attr)

    def jax_pre(mlp):
        return jmp.precompute_edge_kernel(
            mlp, jnp.asarray(g.edge_attr), jax.nn.leaky_relu, "edge",
            kernel_dtype=kernel_dtype)

    def jax_loss(xj, mlp):
        pre = jax_pre(mlp)
        out = jmp.edge_conditioned_conv(
            xj, *(jnp.asarray(a) for a in graph), mlp, jnp.asarray(root),
            jnp.asarray(bias), edge_mask=jnp.asarray(g.edge_mask),
            activation=jax.nn.leaky_relu, mode="edge",
            root_input=jnp.asarray(xr), precomputed=pre)
        return jnp.sum((out - tgt) ** 2), out

    jmlp = [{"w": jnp.asarray(w), "b": jnp.asarray(b)} for w, b in layers]
    (ref, ref_out), (gx, gmlp) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jmlp)
    tlayers = torch.nn.ModuleList()
    for w, b in layers:
        lin = torch.nn.Linear(*w.shape)
        with torch.no_grad():
            lin.weight.copy_(torch.as_tensor(w.T))
            lin.bias.copy_(torch.as_tensor(b))
        tlayers.append(lin)
    xt = torch.tensor(x, requires_grad=True)
    pre = tmp.precompute_edge_kernel(tlayers, torch.as_tensor(g.edge_attr),
                                     _leaky_relu, "edge",
                                     kernel_dtype=kernel_dtype)
    out = tmp.edge_conditioned_conv(
        xt, *_t(*graph), tlayers, torch.as_tensor(root),
        torch.as_tensor(bias), edge_mask=torch.as_tensor(g.edge_mask),
        activation=_leaky_relu, mode="edge", root_input=torch.as_tensor(xr),
        precomputed=pre)
    assert _rel(out.detach().numpy(), ref_out) < TOL
    loss = ((out - torch.as_tensor(tgt)) ** 2).sum()
    loss.backward()
    assert abs(float(loss.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    pairs = [(xt.grad.numpy(), gx)]
    for lin, gl in zip(tlayers, gmlp):
        pairs += [(lin.weight.grad.numpy().T, gl["w"]),
                  (lin.bias.grad.numpy(), gl["b"])]
    for got, want in pairs:
        want = np.asarray(want)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4
    mode, w_j = jax_pre(jmlp)
    assert pre[0] == mode == "edge" and pre[1].shape == w_j.shape
    shared = torch.as_tensor(np.asarray(w_j, np.float32)).to(pre[1].dtype)
    with torch.no_grad():
        out = tmp.edge_conditioned_conv(
            torch.as_tensor(x), *_t(*graph), tlayers, torch.as_tensor(root),
            torch.as_tensor(bias), edge_mask=torch.as_tensor(g.edge_mask),
            activation=_leaky_relu, mode="edge",
            root_input=torch.as_tensor(xr), precomputed=(mode, shared))
    assert _rel(out.numpy(), ref_out) < TOL


def test_weight_layouts_round_trip_and_check_shapes():
    model, params = _jax_model_and_params(2)
    port = _port(params)
    back = port.to_jax_params()
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)

    ref = model.export_pth(params)
    got = port.export_pth()
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    fresh = TEECNet(**CFG, seed=5).import_pth(
        {k: torch.as_tensor(v) for k, v in got.items()})
    for k, v in fresh.export_pth().items():
        np.testing.assert_array_equal(v, got[k])

    wider = TEECNet(**{**CFG, "width": CFG["width"] + 2})
    with pytest.raises(ValueError, match="width"):
        wider.import_pth(got)
    with pytest.raises(ValueError, match="width"):
        wider.from_jax_params(params)
    other_in = TEECNet(**{**CFG, "in_channels": 3})
    with pytest.raises(ValueError, match="fc1"):
        other_in.import_pth(got)
    with pytest.raises(ValueError, match="fc1"):
        other_in.from_jax_params(params)


@pytest.fixture(scope="module")
def merged():
    """tests/test_fused.py:150-186's merged graph: two subdomains of a
    small synthetic duct."""
    s = make_sample_pair(n_high=(10, 5, 5), n_low=(6, 3, 3), seed=0)
    subs = extract_subdomains(s["pos"], s["mesh"].cells, s["x"], s["y"], 2,
                              "all_intersecting")
    raw = [dict(x=g.x, y=g.y, pos=g.pos, senders=g.senders,
                receivers=g.receivers, edge_attr=g.edge_attr,
                global_ids=g.global_node_ids) for g in subs]
    (_, _, batch), = pad_and_bucket(raw)
    return merge_batch(batch)[0]


def test_fused_trainer_steps_match_jax(merged):
    """Five Adam steps of the port's fused Trainer against the JAX
    package's, from the same params: per-step losses within 1e-4 relative
    (float32, Adam with optax's defaults on both sides)."""
    jmodel, params = _jax_model_and_params(4)
    jbatch, rows_blk, blk = jtrain.make_fused_batch(merged, jmodel,
                                                    rows_blk=16, quantum=64)
    host = Graph(**{f: np.asarray(getattr(merged, f))
                    for f in Graph.__dataclass_fields__})
    model = _port(params)
    tbatch, rb2, blk2 = ttrain.make_fused_batch(host, model, rows_blk=16,
                                                quantum=64, device="cpu")
    assert (rb2, blk2) == (rows_blk, blk)
    jt = jtrain.Trainer(jmodel, lr=5e-4, layout="fused", donate=False,
                        fused_rows_blk=16, fused_blk=blk,
                        fused_dtype="float32", fused_interpret=True)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    o = jt.optimizer.init(p)
    tt = ttrain.Trainer(model, lr=5e-4, layout="fused", fused_rows_blk=16,
                        fused_blk=blk, fused_dtype="float32")
    opt = tt.init()
    for step in range(5):
        p, o, ref = jt.step(p, o, jbatch)
        got = tt.step(opt, tbatch)
        assert abs(float(got) - float(ref)) <= 1e-4 * abs(float(ref)), step
    pred = tt.predict(tbatch).numpy()
    ref_pred = np.asarray(jt.predict(p, jbatch))
    assert _rel(pred, ref_pred) <= 1e-4


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return SyntheticDataset(root=str(tmp_path_factory.mktemp("synth")),
                            sub_size=4, n_high=(10, 5, 5), n_low=(6, 3, 3),
                            num_cases=1)


TRAIN_CFG = dict(epochs=2, batch_size=8, lr=5e-4, step_size=30, gamma=0.1,
                 log_interval=1, val_interval=1)


@pytest.mark.parametrize("layout", ["fused", "merged"])
def test_scheduler_train_jax_serves(synth, tmp_path, layout):
    """train -> partition_0.npz stamped as the JAX package stamps a TEECNet,
    which the JAX package loads and serves equal to the port (its ``apply``
    and, through both schedulers, ``predict``)."""
    log_dir = str(tmp_path)
    model = init_model("teecnet", 4, 4, width=8, num_layers=2)
    sched = PartitionScheduler("tt", 1, synth, model, train=True,
                               log_dir=log_dir, device="cpu",
                               gemm_dtype="float32")
    experts = sched.train(TRAIN_CFG, layout=layout)
    npz = os.path.join(log_dir, "models", "collection_tt", "partition_0.npz")
    params = jckpt.load_params(npz)
    jmodel = JTEECNet(**CFG)
    # the JAX package's own stamp of the same model: the port stamps every
    # field it has, with the same value (the JAX-only remat, edges_sorted,
    # num_powers and ps_layers change no result of the dense kernel)
    jdir = str(tmp_path / "jax")
    JSched("tt", 1, synth, jmodel, train=True, log_dir=jdir,
           use_mesh=False)._save_model(0, params, export_pth=False)
    jmeta = jckpt.load_meta(os.path.join(jdir, "models", "collection_tt",
                                         "partition_0.npz"))
    meta = jckpt.load_meta(npz)
    assert meta.items() <= jmeta.items()
    for f in ("in_channels", "width", "out_channels", "num_layers", "in_edge",
              "mode", "kernel_type"):
        assert meta[f"cfg_{f}"] == jmeta[f"cfg_{f}"], f
    g = synth.get(0)
    args = [np.asarray(g[k]) for k in ("x", "senders", "receivers", "edge_attr")]
    ref = np.asarray(jmodel.apply(params, *(jnp.asarray(a) for a in args)))
    with torch.no_grad():
        got = experts[0].apply(*_t(*args))
    assert np.isfinite(ref).all()
    assert _rel(got.numpy(), ref) <= 1e-5
    x = synth.get_one_full_sample(0)
    jpreds = JSched("tt", 1, synth, jmodel, train=False, log_dir=log_dir,
                    use_mesh=False).predict(x)[0]
    tpreds = PartitionScheduler("tt", 1, synth, model, train=False,
                                log_dir=log_dir, device="cpu",
                                gemm_dtype="float32").predict(x)[0]
    for a, b in zip(tpreds, jpreds):
        assert _rel(a, b) <= 1e-4


def test_cli_teecnet_on_cpu(tmp_path, monkeypatch):
    """``python -m fast_eng_super_resolution_tpu_torch --model=teecnet``:
    --mode=train then --mode=pred (runner.main) with ``device: cpu``."""
    import yaml

    from fast_eng_super_resolution_tpu_torch.data.vtu import read_vtu
    from fast_eng_super_resolution_tpu_torch.runner import main
    from fast_eng_super_resolution_tpu_torch.utils.config import parse_args

    monkeypatch.chdir(tmp_path)
    cfg = dict(n_clusters=1, in_channels=4, out_channels=4, width=8,
               num_layers=2, root=str(tmp_path / "data"), idxs=[0],
               device="cpu", sub_size=4, n_high=[10, 5, 5], n_low=[6, 3, 3],
               num_cases=1)
    (tmp_path / "exp.yaml").write_text(yaml.safe_dump(cfg))
    (tmp_path / "train.yaml").write_text(yaml.safe_dump(TRAIN_CFG))
    argv = ["--model=teecnet", "--dataset=synthetic", "--exp_name=cli",
            "--exp_config=exp.yaml", "--train_config=train.yaml"]
    sched = main(parse_args(argv + ["--mode=train"]))
    assert isinstance(sched.model, TEECNet)
    assert sched.model.num_layers == 2
    npz = os.path.join("logs", "models", "collection_cli", "partition_0.npz")
    assert jckpt.load_meta(npz)["model"] == "TEECNet"
    paths = main(parse_args(argv + ["--mode=pred"]))
    fields = read_vtu(paths[0])["point_data"]
    assert all(np.all(np.isfinite(v)) for v in fields.values())


def test_model_without_fused_kernel_serves_general_lane(synth, tmp_path,
                                                       monkeypatch):
    """As the JAX package (sched/serving.py:233-235, sched/scheduler.py:
    582-586): a model whose ``fused_ok`` is False takes the general lane
    ("model has no fused kernel") and ``predict``'s non-fused ``apply``,
    never ``apply_fused``; its field equals the default model's (fused lane,
    plain versions on the CPU) on the same weights."""
    log_dir = str(tmp_path)
    model = init_model("teecnet", 4, 4, width=8, num_layers=2)
    PartitionScheduler("fo", 1, synth, model, train=True, log_dir=log_dir,
                       device="cpu")._save_model(0, model)
    x = synth.get_one_full_sample(0)
    n = len(synth.full_mesh(0)["points"])

    def sched():
        return PartitionScheduler("fo", 1, synth, model, train=False,
                                  log_dir=log_dir, device="cpu",
                                  gemm_dtype="float32")

    default = sched()
    assert default._select_lane(x, "1")[0] == "fast"
    ref = default.predict_full(x, n)[0]
    monkeypatch.setattr(TEECNet, "fused_ok", property(lambda self: False))

    def no_fused(*args, **kwargs):
        raise AssertionError("apply_fused called on a model without one")

    monkeypatch.setattr(TEECNet, "apply_fused", no_fused)
    gated = sched()
    assert gated._select_lane(x, "1") == ("general", "model has no fused kernel")
    assert gated.predict_full(x, n) is None
    assert gated.last_lane == ("general", "model has no fused kernel")
    preds = gated.predict(x)[0]
    from fast_eng_super_resolution_tpu_torch.data.reconstruct import overlap_average
    got = overlap_average(preds, [d["global_node_ids"] for d in x], n)
    assert np.isfinite(got).all()
    assert _rel(got, ref) <= 1e-4
    # the JAX package's lane table on the same checkpoint and flag
    monkeypatch.setattr(JTEECNet, "fused_ok", property(lambda self: False))
    jsched = JSched("fo", 1, synth, JTEECNet(**CFG), train=False,
                    log_dir=log_dir, use_mesh=False)
    assert jsched._select_lane(x, "force") == ("general",
                                               "model has no fused kernel")


PS_CFG = dict(CFG, kernel_type="powerseries", num_powers=3, ps_layers=2)


def _ps_jax(seed=0):
    model = JTEECNet(mode="edge3d", **PS_CFG)
    return model, jax.tree_util.tree_map(np.asarray,
                                         model.init(jax.random.PRNGKey(seed)))


def test_powerseries_params_round_trip():
    """``kernel.ps`` crosses both ways with the JAX tree (kernel/ps/conv0,
    convs/[i], conv_out as {w, b, root_param}, norm_scale, norm_bias)."""
    _, params = _ps_jax()
    port = TEECNet(**PS_CFG).from_jax_params(params)
    assert port.kernel_type == "powerseries" and not port.fused_ok
    back = port.to_jax_params()
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("powers", [2, 3, 4])
def test_powerseries_apply_and_grads_match_jax(powers):
    """TEECNet(kernel_type='powerseries') forward and the gradients of a
    squared loss through ``apply`` (the general lane's form) against the
    JAX package's, same weights: the series' integer powers by repeated
    products on both sides; float32, 1e-5 of the max (forward), 1e-4 of
    each gradient's norm."""
    model = JTEECNet(mode="edge3d", **dict(PS_CFG, num_powers=powers))
    params = jax.tree_util.tree_map(np.asarray,
                                    model.init(jax.random.PRNGKey(powers)))
    g = _padded_graph(2)
    args = (g.x, g.senders, g.receivers, g.edge_attr)

    def jloss(p):
        out = model.apply(p, *(jnp.asarray(a) for a in args),
                          edge_mask=jnp.asarray(g.edge_mask))
        return jnp.sum((out - jnp.asarray(g.y)) ** 2), out

    (ref, ref_out), ref_grads = jax.value_and_grad(jloss, has_aux=True)(params)
    port = TEECNet(**dict(PS_CFG, num_powers=powers)).from_jax_params(params)
    out = port.apply(*_t(*args), edge_mask=torch.as_tensor(g.edge_mask))
    assert _rel(out.detach().numpy(), ref_out) < TOL
    loss = ((out - torch.as_tensor(g.y)) ** 2).sum()
    loss.backward()
    assert abs(float(loss.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    want = flatten_params(jax.tree_util.tree_map(np.asarray, ref_grads))
    for name, p in port.named_parameters():
        key, transposed = port.jax_key(name)
        if p.grad is None:               # the unused dense edge MLP
            assert name.startswith("kernel.edge_mlp") and not np.any(want[key])
            continue
        got = p.grad.numpy().T if transposed else p.grad.numpy()
        err = np.linalg.norm(got - want[key]) / np.linalg.norm(want[key])
        assert err < 1e-4, (key, err)


def test_powerseries_serves_general_lane_as_jax(synth, tmp_path):
    """A power-series TEECNet has no fused kernel: the scheduler serves it
    through the general lane ("model has no fused kernel") and the plain
    ``apply``; its checkpoint, written by the port, serves on the JAX
    package's scheduler to the same field (float32, 1e-4 of the max)."""
    from fast_eng_super_resolution_tpu_torch.data.reconstruct import overlap_average

    log_dir = str(tmp_path)
    model = TEECNet(**PS_CFG, seed=3)
    PartitionScheduler("ps", 1, synth, model, train=True, log_dir=log_dir,
                       device="cpu")._save_model(0, model)
    x = synth.get_one_full_sample(0)
    n = len(synth.full_mesh(0)["points"])
    gids = [d["global_node_ids"] for d in x]
    sched = PartitionScheduler("ps", 1, synth, TEECNet(**PS_CFG), train=False,
                               log_dir=log_dir, device="cpu")
    assert sched.predict_full(x, n) is None
    assert sched.last_lane == ("general", "model has no fused kernel")
    got = overlap_average(sched.predict(x)[0], gids, n)
    jsched = JSched("ps", 1, synth, JTEECNet(**PS_CFG), train=False,
                    log_dir=log_dir, use_mesh=False)
    ref = overlap_average([np.asarray(p) for p in jsched.predict(x)[0]], gids, n)
    assert np.isfinite(got).all()
    assert _rel(got, ref) < 1e-4
