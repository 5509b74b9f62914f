"""Port of ops/pallas_mp.py (the per-edge message kernel B5) and of the conv
modes of ops/message_passing.py: the plain version against the JAX Pallas
kernel in interpret mode, the wrapper on the CPU, its refusal under
autograd, and each mode of ``edge_conditioned_conv`` and ``KernelNN`` against
the JAX package's same mode; mode 'lut''s table, its fully masked graphs and
its gradients; conv mode 'edge' (the contraction unrolled as c_in
slice-MACs).  The kernel itself is checked against its plain
version on the card in tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import jax
from jax.experimental.pallas import tpu as pltpu

from conftest import make_random_graph
from fast_eng_super_resolution_tpu.core.graph import pad_graph
from fast_eng_super_resolution_tpu.models.kernelnn import KernelNN as JKernelNN
from fast_eng_super_resolution_tpu.ops import message_passing as jmp
from fast_eng_super_resolution_tpu.ops.pallas_mp import fused_edge_messages as jfem
from fast_eng_super_resolution_tpu_torch.models.kernelnn import KernelNN
from fast_eng_super_resolution_tpu_torch.ops import message_passing as tmp
from fast_eng_super_resolution_tpu_torch.ops.pallas_mp import (
    fused_edge_messages, fused_edge_messages_plain)
from fast_eng_super_resolution_tpu_torch.parallel.train import Trainer
from fast_eng_super_resolution_tpu_torch.core.graph import Graph

PORTED = ("edge3d", "factored", "pallas", "lut", "edge")


def _operands(e, k, w, seed=0, c_out=None):
    rng = np.random.default_rng(seed)
    c_out = w if c_out is None else c_out
    return (rng.normal(size=(e, k)).astype(np.float32),
            rng.normal(size=(e, w)).astype(np.float32),
            (rng.normal(size=(k, w * c_out)) * 0.1).astype(np.float32),
            (rng.normal(size=(w * c_out,)) * 0.1).astype(np.float32))


# (E, K, c_in, c_out): width 16, and past 64 (the CUDA kernel's column
# chunks) at 128 and at a rectangular shape, and past 128 (c_in in stages
# of 32, K past 128 with one h tile) at the widest and at two rectangular
# shapes, with a few hundred edges
@pytest.mark.parametrize("e,k,c_in,c_out", [
    pytest.param(700, 24, 16, 16, id="24"),
    pytest.param(700, 128, 16, 16, id="128"),
    (300, 128, 128, 128), (300, 48, 72, 100), (300, 256, 256, 256),
    (300, 200, 136, 250), (300, 256, 48, 200)])
def test_plain_matches_jax_kernel(e, k, c_in, c_out):
    """E is not a multiple of the JAX kernel's block; float32 on both
    sides, sums in other orders: rtol/atol 1e-4 (tests/test_pallas.py's)."""
    ops = _operands(e, k, c_in, seed=k + c_in, c_out=c_out)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfem(*(jnp.asarray(a) for a in ops)))
    got = fused_edge_messages_plain(*(torch.as_tensor(a) for a in ops))
    assert got.shape == (e, c_out) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    wrapped = fused_edge_messages(*(torch.as_tensor(a) for a in ops),
                                  block_e=128)
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


def test_wrapper_refuses_autograd_and_bad_block():
    h, x, w3, b3 = (torch.as_tensor(a) for a in _operands(50, 8, 4))
    w3.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fused_edge_messages(h, x, w3, b3)
    with torch.no_grad():  # the same call serves without a gradient
        out = fused_edge_messages(h, x, w3, b3)
    assert out.shape == (50, 4)
    for bad in (0, -256, 2.5, True):
        with pytest.raises(ValueError, match="block_e"):
            fused_edge_messages(h, x, w3.detach(), b3, block_e=bad)


def test_resolve_mode():
    assert tmp.resolve_mode("auto", "cpu") == "factored"
    assert tmp.resolve_mode("auto", torch.device("cuda")) == "edge3d"
    for mode in PORTED:
        assert tmp.resolve_mode(mode, "cpu") == mode
        assert tmp.resolve_mode(mode, torch.device("cuda")) == mode
    with pytest.raises(ValueError, match="unknown conv mode"):
        tmp.resolve_mode("dense", "cpu")


def _mlp(rng, sizes):
    """The same edge MLP as JAX {'w', 'b'} dicts and torch nn.Linear."""
    jlayers, tlayers = [], []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
        bias = (rng.normal(size=(b,)) * 0.1).astype(np.float32)
        jlayers.append({"w": jnp.asarray(w), "b": jnp.asarray(bias)})
        lin = torch.nn.Linear(a, b)
        with torch.no_grad():
            lin.weight.copy_(torch.as_tensor(w.T))
            lin.bias.copy_(torch.as_tensor(bias))
        tlayers.append(lin)
    return jlayers, torch.nn.ModuleList(tlayers)


@pytest.mark.parametrize("root_input", [False, True])
@pytest.mark.parametrize("aggr", ["mean", "sum"])
@pytest.mark.parametrize("mode", PORTED)
def test_edge_conditioned_conv_matches_jax_mode(mode, aggr, root_input):
    """One layer with an edge mask, in each ported mode, against the JAX
    package's same mode (its Pallas kernel in interpret mode): float32, sums
    in other orders, 1e-5 of the max."""
    rng = np.random.default_rng(1)
    n, e, c, k = 60, 300, 6, 10
    g = make_random_graph(rng, n=n, e=e, c_in=c)
    mask = rng.random(e) > 0.2
    jlayers, tlayers = _mlp(rng, [1, k, c * c])
    root = (rng.normal(size=(c, c)) * 0.3).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    xr = rng.normal(size=(n, c)).astype(np.float32) if root_input else None
    args = (g["x"], g["senders"], g["receivers"], g["edge_attr"])
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jmp.edge_conditioned_conv(
            *(jnp.asarray(a) for a in args), jlayers, jnp.asarray(root),
            jnp.asarray(bias), edge_mask=jnp.asarray(mask), aggr=aggr,
            mode=mode, root_input=None if xr is None else jnp.asarray(xr)))
    t = torch.as_tensor
    with torch.no_grad():
        got = tmp.edge_conditioned_conv(
            *(t(a) for a in args), tlayers, t(root), t(bias),
            edge_mask=t(mask), aggr=aggr, mode=mode,
            root_input=None if xr is None else t(xr))
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def _padded_graph(seed):
    g = make_random_graph(np.random.default_rng(seed), n=60, e=256)
    return pad_graph(g["x"], g["y"], g["pos"], g["senders"], g["receivers"],
                     g["edge_attr"], 64, 512)


@pytest.mark.parametrize("mode", PORTED)
def test_kernelnn_mode_matches_jax(mode):
    """The counterpart of tests/test_pallas.py's KernelNN(mode='pallas')
    check: the port's KernelNN in each mode against the JAX KernelNN in the
    same mode, same weights, 1e-5 of the max (depth 2, float32)."""
    cfg = dict(width=16, ker_width=8, depth=2, in_width=4, out_width=4)
    jmodel = JKernelNN(mode=mode, **cfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(0)))
    g = _padded_graph(2)
    args = (g.x, g.senders, g.receivers, g.edge_attr)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jmodel.apply(params, *(jnp.asarray(a) for a in args),
                                      edge_mask=jnp.asarray(g.edge_mask)))
    port = KernelNN(mode=mode, **cfg).from_jax_params(params)
    with torch.no_grad():
        got = port.apply(*(torch.as_tensor(a) for a in args),
                         edge_mask=torch.as_tensor(g.edge_mask))
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("width", [128, 256])
def test_kernelnn_wide_pallas_matches_jax(width):
    """Width and K 128 and 256 (the width-128 and width-256 checkpoints'
    shapes, past the CUDA kernel's earlier limits of 64 and 128): the JAX
    KernelNN in mode 'pallas' (its Pallas kernel in interpret mode)
    exported through ``export_pth`` and imported by the port's KernelNN in
    mode 'pallas', on the same small graph: float32, sums in other orders,
    1e-5 of the max (depth 2)."""
    cfg = dict(width=width, ker_width=width, depth=2, in_width=4,
               out_width=4)
    jmodel = JKernelNN(mode="pallas", **cfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(1)))
    g = pad_graph(*(make_random_graph(np.random.default_rng(4), n=40, e=150)[f]
                    for f in ("x", "y", "pos", "senders", "receivers",
                              "edge_attr")), 48, 256)
    args = (g.x, g.senders, g.receivers, g.edge_attr)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jmodel.apply(params, *(jnp.asarray(a) for a in args),
                                      edge_mask=jnp.asarray(g.edge_mask)))
    port = KernelNN(mode="pallas", **cfg).import_pth(
        {k: torch.tensor(np.asarray(v))
         for k, v in jmodel.export_pth(params).items()})
    assert port.mode == "pallas"
    with torch.no_grad():
        got = port.apply(*(torch.as_tensor(a) for a in args),
                         edge_mask=torch.as_tensor(g.edge_mask))
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_pallas_mode_merged_training_raises():
    """A 'pallas' model's merged-layout step raises the wrapper's error
    (the JAX package's jax.grad fails inside pallas_call); evaluating it
    without a gradient works and equals the 'edge3d' model's loss."""
    g = _padded_graph(3)
    graph = Graph(**{f: torch.as_tensor(np.asarray(getattr(g, f)))
                     for f in Graph.__dataclass_fields__})
    losses = {}
    for mode in ("pallas", "edge3d"):
        trainer = Trainer(KernelNN(8, 8, 2, in_width=4, out_width=4,
                                   mode=mode, seed=1), lr=1e-3)
        opt = trainer.init()
        losses[mode] = trainer.evaluate(graph)
        if mode == "pallas":
            with pytest.raises(RuntimeError, match="no backward"):
                trainer.step(opt, graph)
    assert np.isfinite(losses["pallas"])
    assert abs(losses["pallas"] - losses["edge3d"]) <= 1e-5 * abs(losses["edge3d"])


@pytest.mark.parametrize("masked", ["none", "some", "all"])
@pytest.mark.parametrize("knots", [2, 64, 512])
def test_lut_table_matches_jax(masked, knots):
    """Mode 'lut''s precomputed table (w_knots, i0, frac) against the JAX
    package's: the knots span the real edges only (padding slots carry
    edge_attr 1.0 far outside the real range), and a graph whose edges are
    all masked keeps finite knots."""
    rng = np.random.default_rng(7)
    e, c, k = 200, 4, 8
    ea = (rng.random((e, 1)) * 1e-2 + 1e-3).astype(np.float32)
    mask = {"none": None, "some": rng.random(e) > 0.3,
            "all": np.zeros(e, bool)}[masked]
    if mask is not None:
        ea[~mask] = 1.0                  # pad_graph's padding attribute
    jlayers, tlayers = _mlp(rng, [1, k, c * c])
    _, (wk_j, i0_j, fr_j) = jmp.precompute_edge_kernel(
        jlayers, jnp.asarray(ea), mode="lut", lut_knots=knots,
        edge_mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        mode, (wk_t, i0_t, fr_t) = tmp.precompute_edge_kernel(
            tlayers, torch.as_tensor(ea), mode="lut", lut_knots=knots,
            edge_mask=None if mask is None else torch.as_tensor(mask))
    assert mode == "lut" and wk_t.shape == (knots, c * c)
    assert np.isfinite(wk_t.numpy()).all()
    assert np.abs(wk_t.numpy() - np.asarray(wk_j)).max() <= 1e-5 * np.abs(
        np.asarray(wk_j)).max()
    real = slice(None) if mask is None else mask
    np.testing.assert_array_equal(i0_t.numpy()[real], np.asarray(i0_j)[real])
    np.testing.assert_allclose(fr_t.numpy()[real], np.asarray(fr_j)[real],
                               atol=1e-5)


@pytest.mark.parametrize("all_masked", [False, True])
def test_lut_grads_match_jax(all_masked):
    """KernelNN in mode 'lut' differentiates as the JAX package's: the loss
    and every parameter's gradient (float32, 1e-4 of the gradient's norm);
    with every edge masked both stay finite."""
    cfg = dict(width=8, ker_width=8, depth=2, in_width=4, out_width=4)
    jmodel = JKernelNN(mode="lut", lut_knots=64, **cfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(4)))
    g = _padded_graph(5)
    mask = np.zeros_like(g.edge_mask) if all_masked else g.edge_mask
    args = (g.x, g.senders, g.receivers, g.edge_attr)

    def jloss(p):
        out = jmodel.apply(p, *(jnp.asarray(a) for a in args),
                           edge_mask=jnp.asarray(mask))
        return jnp.sum((out - jnp.asarray(g.y)) ** 2)

    ref, ref_grads = jax.value_and_grad(jloss)(params)
    port = KernelNN(mode="lut", lut_knots=64, **cfg).from_jax_params(params)
    out = port.apply(*(torch.as_tensor(a) for a in args),
                     edge_mask=torch.as_tensor(mask))
    loss = ((out - torch.as_tensor(g.y)) ** 2).sum()
    loss.backward()
    assert abs(float(loss.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    from fast_eng_super_resolution_tpu_torch.core.checkpoint import flatten_params

    want = flatten_params(jax.tree_util.tree_map(np.asarray, ref_grads))
    for name, p in port.named_parameters():
        key, transposed = port.jax_key(name)
        got = p.grad.numpy().T if transposed else p.grad.numpy()
        assert np.isfinite(got).all(), key
        denom = max(np.linalg.norm(want[key]), 1e-6)
        assert np.linalg.norm(got - want[key]) / denom < 1e-4, key
