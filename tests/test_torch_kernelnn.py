"""Port of models/kernelnn.py: JAX parameters carried into the port give the
JAX model's outputs (plain whole-graph ``apply`` and the fused form), and the
reference ``.pth`` layout round-trips with its width and head checks."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_random_graph
from fast_eng_super_resolution_tpu.core.graph import pad_graph
from fast_eng_super_resolution_tpu.models.kernelnn import KernelNN as JKernelNN
from fast_eng_super_resolution_tpu_torch.models.kernelnn import KernelNN
from fast_eng_super_resolution_tpu_torch.models.registry import init_model
from fast_eng_super_resolution_tpu_torch.ops.fused_conv import CompactS

W, DEPTH = 8, 2
# both sides run float32 with sums in different orders; depth-2 ReLU
# composition keeps the difference at the 1e-6 level -> 1e-5 of the max
TOL = 1e-5


def _jax_model_and_params(seed=0):
    model = JKernelNN(width=W, ker_width=W, depth=DEPTH, in_width=4,
                      out_width=4, mode="edge3d")
    params = jax.tree_util.tree_map(np.asarray,
                                    model.init(jax.random.PRNGKey(seed)))
    return model, params


def _port(params):
    return KernelNN(width=W, ker_width=W, depth=DEPTH, in_width=4,
                    out_width=4).from_jax_params(params)


def _padded_graph(seed=0):
    g = make_random_graph(np.random.default_rng(seed), n=120, e=700)
    return pad_graph(g["x"], g["y"], g["pos"], g["senders"], g["receivers"],
                     g["edge_attr"], 128, 1024)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


def test_jax_params_round_trip():
    _, params = _jax_model_and_params()
    back = _port(params).to_jax_params()
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_apply_matches_jax():
    model, params = _jax_model_and_params()
    g = _padded_graph()
    ref = model.apply(params, jnp.asarray(g.x), jnp.asarray(g.senders),
                      jnp.asarray(g.receivers), jnp.asarray(g.edge_attr),
                      edge_mask=jnp.asarray(g.edge_mask))
    t = torch.as_tensor
    with torch.no_grad():
        got = _port(params).apply(t(g.x), t(g.senders), t(g.receivers),
                                  t(g.edge_attr), edge_mask=t(g.edge_mask))
    assert _rel(got.numpy(), ref) < TOL


@pytest.mark.parametrize("compact", [True, False])
def test_apply_fused_matches_jax(compact):
    model, params = _jax_model_and_params(1)
    g = _padded_graph(1)
    ea_b, sp, s, rows_blk, blk = model.prepare_fused(
        g.senders, g.receivers, g.edge_attr, 128, g.edge_mask)
    ref = model.apply_fused(params, jnp.asarray(g.x), jnp.asarray(ea_b),
                            jnp.asarray(sp), jnp.asarray(s), rows_blk=rows_blk,
                            blk=blk, gemm_dtype="float32", interpret=True)
    port = _port(params)
    ea_t, sp_t, s_t, rb, bk = port.prepare_fused(
        g.senders, g.receivers, g.edge_attr, 128, g.edge_mask,
        compact=compact)
    s_t = s_t.to("cpu") if isinstance(s_t, CompactS) else torch.as_tensor(s_t)
    with torch.no_grad():
        got = port.apply_fused(torch.as_tensor(g.x), torch.as_tensor(ea_t),
                               torch.as_tensor(sp_t), s_t, rows_blk=rb,
                               blk=bk, gemm_dtype="float32")
        plain = port.apply(torch.as_tensor(g.x), torch.as_tensor(g.senders),
                           torch.as_tensor(g.receivers),
                           torch.as_tensor(g.edge_attr),
                           edge_mask=torch.as_tensor(g.edge_mask))
    assert _rel(got.numpy(), ref) < TOL
    assert _rel(got.numpy(), plain.numpy()) < TOL


def test_export_pth_matches_jax_and_checks_shapes():
    model, params = _jax_model_and_params(2)
    port = _port(params)
    ref = model.export_pth(params)
    got = port.export_pth()
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    fresh = KernelNN(width=W, ker_width=W, depth=DEPTH, in_width=4,
                     out_width=4, seed=5).import_pth(
        {k: torch.as_tensor(v) for k, v in got.items()})
    for k, v in fresh.export_pth().items():
        np.testing.assert_array_equal(v, got[k])

    wider = KernelNN(width=W + 2, ker_width=W, depth=DEPTH, in_width=4,
                     out_width=4)
    with pytest.raises(ValueError, match="width"):
        wider.import_pth(got)
    with pytest.raises(ValueError, match="width"):
        wider.from_jax_params(params)
    with pytest.raises(ValueError, match="fc1"):
        KernelNN(width=W, ker_width=W, depth=DEPTH, in_width=3,
                 out_width=4).import_pth(got)
    bad_head = dict(got)
    bad_head["conv1.nn.layers.4.weight"] = got["conv1.nn.layers.4.weight"][:2 * 2 * W]
    with pytest.raises(ValueError, match="head width"):
        port.import_pth(bad_head)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        KernelNN(width=W, ker_width=W, depth=DEPTH, kernel_rank=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        init_model("neuralop", 4, 4, width=W, num_layers=2, kernel_rank=2)
    for name in ("teecnet", "fno", "deeponet", "graphsage"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            init_model(name, 4, 4, width=W, num_layers=2)
    with pytest.raises(ValueError):
        init_model("nope", 4, 4, width=W, num_layers=2)
