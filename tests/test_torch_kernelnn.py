"""Port of models/kernelnn.py: JAX parameters carried into the port give the
JAX model's outputs (plain whole-graph ``apply``, the fused form and the
fused form's gradients), at full rank and with rank-r factorized edge kernels
(``kernel_rank``), and the reference ``.pth`` layout round-trips with its
width and head checks."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_random_graph
from fast_eng_super_resolution_tpu.core.graph import pad_graph
from fast_eng_super_resolution_tpu.models.kernelnn import KernelNN as JKernelNN
from fast_eng_super_resolution_tpu_torch.core.checkpoint import flatten_params
from fast_eng_super_resolution_tpu_torch.models.kernelnn import KernelNN
from fast_eng_super_resolution_tpu_torch.models.registry import init_model
from fast_eng_super_resolution_tpu_torch.models.teecnet import TEECNet
from fast_eng_super_resolution_tpu_torch.ops.fused_conv import CompactS

W, DEPTH = 8, 2
# rank-r models: width 12, ker_width 8; rank 3 is below the TPU kernel's
# sublane pad and not a multiple of 4
RANKS = [None, 3, 16]
# both sides run float32 with sums in different orders; depth-2 ReLU
# composition keeps the difference at the 1e-6 level -> 1e-5 of the max
TOL = 1e-5


def _cfg(rank):
    width = W if rank is None else 12
    return dict(width=width, ker_width=8, depth=DEPTH, in_width=4,
                out_width=4, kernel_rank=rank)


def _jax_model_and_params(seed=0, rank=None):
    model = JKernelNN(mode="edge3d", **_cfg(rank))
    params = jax.tree_util.tree_map(np.asarray,
                                    model.init(jax.random.PRNGKey(seed)))
    return model, params


def _port(params, rank=None):
    return KernelNN(**_cfg(rank)).from_jax_params(params)


def _padded_graph(seed=0):
    g = make_random_graph(np.random.default_rng(seed), n=120, e=700)
    return pad_graph(g["x"], g["y"], g["pos"], g["senders"], g["receivers"],
                     g["edge_attr"], 128, 1024)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


@pytest.mark.parametrize("rank", RANKS)
def test_jax_params_round_trip(rank):
    _, params = _jax_model_and_params(rank=rank)
    back = _port(params, rank).to_jax_params()
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rank", RANKS)
def test_apply_matches_jax(rank):
    model, params = _jax_model_and_params(rank=rank)
    g = _padded_graph()
    ref = model.apply(params, jnp.asarray(g.x), jnp.asarray(g.senders),
                      jnp.asarray(g.receivers), jnp.asarray(g.edge_attr),
                      edge_mask=jnp.asarray(g.edge_mask))
    t = torch.as_tensor
    with torch.no_grad():
        got = _port(params, rank).apply(t(g.x), t(g.senders),
                                        t(g.receivers), t(g.edge_attr),
                                        edge_mask=t(g.edge_mask))
    assert _rel(got.numpy(), ref) < TOL


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("compact", [True, False])
def test_apply_fused_matches_jax(compact, rank):
    model, params = _jax_model_and_params(1, rank)
    g = _padded_graph(1)
    ea_b, sp, s, rows_blk, blk = model.prepare_fused(
        g.senders, g.receivers, g.edge_attr, 128, g.edge_mask)
    ref = model.apply_fused(params, jnp.asarray(g.x), jnp.asarray(ea_b),
                            jnp.asarray(sp), jnp.asarray(s), rows_blk=rows_blk,
                            blk=blk, gemm_dtype="float32", interpret=True)
    port = _port(params, rank)
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


@pytest.mark.parametrize("rank", RANKS)
def test_export_pth_matches_jax_and_checks_shapes(rank):
    model, params = _jax_model_and_params(2, rank)
    port = _port(params, rank)
    w = port.width
    ref = model.export_pth(params)
    got = port.export_pth()
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    fresh = KernelNN(**_cfg(rank), seed=5).import_pth(
        {k: torch.as_tensor(v) for k, v in got.items()})
    for k, v in fresh.export_pth().items():
        np.testing.assert_array_equal(v, got[k])

    wider = KernelNN(**{**_cfg(rank), "width": w + 2})
    with pytest.raises(ValueError, match="width"):
        wider.import_pth(got)
    with pytest.raises(ValueError, match="width"):
        wider.from_jax_params(params)
    with pytest.raises(ValueError, match="fc1"):
        KernelNN(**{**_cfg(rank), "in_width": 3}).import_pth(got)
    bad_head = dict(got)
    bad_head["conv1.nn.layers.4.weight"] = got["conv1.nn.layers.4.weight"][:2 * 2 * w]
    with pytest.raises(ValueError, match="head width"):
        port.import_pth(bad_head)


@pytest.mark.parametrize("rank,other", [(3, None), (None, 3), (3, 16)])
def test_head_width_mismatch_raises(rank, other):
    """A checkpoint whose edge-MLP head was trained at another rank (full
    rank: width^2 columns, rank r: 2 r width) is refused by every loader,
    as the JAX package's ``import_pth`` refuses it."""
    cfg = {**_cfg(rank), "width": 12}
    src = KernelNN(**{**cfg, "kernel_rank": other}, seed=1)
    dst = KernelNN(**cfg)
    assert src.edge_mlp[-1].out_features != dst.edge_mlp[-1].out_features
    with pytest.raises(ValueError, match="head width"):
        dst.import_pth(src.export_pth())
    with pytest.raises(ValueError, match="head width"):
        dst.from_jax_params(src.to_jax_params())
    with pytest.raises(ValueError, match="head width"):
        JKernelNN(**{**cfg, "kernel_rank": rank}).import_pth(src.export_pth())


@pytest.mark.parametrize("rank", [3, 16])
def test_apply_fused_ad_grads_match_jax(rank):
    """float32 ``apply_fused_ad`` (the rank-r layer's forward and backward,
    plain versions on the CPU) against ``jax.grad`` of the JAX model's plain
    ``apply`` with the same weights: the JAX package's own bounds, loss
    within 1e-5 relative and each gradient within 1e-4 of its norm."""
    model, params = _jax_model_and_params(3, rank)
    g = _padded_graph(3)
    y = np.random.default_rng(3).normal(size=g.x.shape).astype(np.float32)

    def loss_jax(p):
        out = model.apply(p, jnp.asarray(g.x), jnp.asarray(g.senders),
                          jnp.asarray(g.receivers), jnp.asarray(g.edge_attr),
                          edge_mask=jnp.asarray(g.edge_mask))
        return jnp.sum((out - y) ** 2)

    ref, ref_grads = jax.value_and_grad(loss_jax)(params)
    port = _port(params, rank)
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
    for name, p in port.named_parameters():
        key, transposed = port.jax_key(name)
        got = p.grad.numpy().T if transposed else p.grad.numpy()
        err = np.linalg.norm(got - want[key]) / np.linalg.norm(want[key])
        assert err < 1e-4, (key, err)


def test_unported_options_raise():
    """GraphSAGE and conv mode 'edge' (a TPU layout experiment) still
    raise, naming their ROADMAP.md item; the one-step grid models build
    ('deeponet' needs ``trunk_size``, as in the JAX package; their outputs
    are held against JAX in tests/test_torch_grid.py); mode 'lut' and
    TEECNet's power-series kernel are ported and build (their outputs are
    held against JAX in tests/test_torch_pallas_mp.py and
    tests/test_torch_teecnet.py)."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        init_model("graphsage", 4, 4, width=W, num_layers=2)
    assert init_model("fno", 4, 4, width=W, num_layers=2).modes == (4, 4)
    with pytest.raises(KeyError, match="trunk_size"):
        init_model("deeponet", 4, 4, width=W, num_layers=2)
    with pytest.raises(ValueError):
        init_model("nope", 4, 4, width=W, num_layers=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        KernelNN(**_cfg(None), mode="edge")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TEECNet(4, W, 4, mode="edge")
    assert KernelNN(**_cfg(None), mode="lut").mode == "lut"
    assert TEECNet(4, W, 4, mode="lut").mode == "lut"
    ps = TEECNet(4, W, 4, kernel_type="powerseries")
    assert not ps.fused_ok and TEECNet(4, W, 4).fused_ok
    assert ps.kernel.ps.conv_out.linear.out_features == W * W
    with pytest.raises(ValueError, match="kernel_type"):
        TEECNet(4, W, 4, kernel_type="chebyshev")


@pytest.mark.parametrize("rank", [None, 3])
def test_kernel_dtype_and_lut_knots_as_jax(rank):
    """KernelNN takes the JAX package's ``kernel_dtype`` and ``lut_knots``
    and stamps them, with every other scalar field, into a checkpoint's spec
    as the JAX package stamps its model: at the defaults (None, 512) and at
    bf16 per-edge matrices with a 256-knot table; an unknown type or a
    table of fewer than 2 knots raises ValueError."""
    from types import SimpleNamespace

    from fast_eng_super_resolution_tpu.sched.scheduler import PartitionScheduler as JSched
    from fast_eng_super_resolution_tpu_torch.sched.scheduler import PartitionScheduler

    for kw, want in ((dict(kernel_dtype=None, lut_knots=512), ("None", "512")),
                     (dict(kernel_dtype="bfloat16", lut_knots=256),
                      ("bfloat16", "256"))):
        port = KernelNN(**_cfg(rank), **kw)
        jmodel = JKernelNN(**_cfg(rank), **kw)
        assert (port.kernel_dtype, port.lut_knots) == (jmodel.kernel_dtype,
                                                       jmodel.lut_knots)
        spec = PartitionScheduler._model_spec(SimpleNamespace(model=port))
        jspec = JSched._model_spec(SimpleNamespace(model=jmodel))
        assert (spec["cfg_kernel_dtype"], spec["cfg_lut_knots"]) == want
        assert (jspec["cfg_kernel_dtype"], jspec["cfg_lut_knots"]) == want
        assert spec.items() <= jspec.items()
    for kw in (dict(kernel_dtype="bfloat17"), dict(lut_knots=1)):
        with pytest.raises(ValueError):
            KernelNN(**_cfg(rank), **kw)


@pytest.mark.parametrize("rank", RANKS)
def test_kernel_dtype_bfloat16_matches_jax(rank):
    """``kernel_dtype='bfloat16'`` in mode 'edge3d' (and the rank-r
    branch): both sides round the per-edge matrices and x to bf16 and sum
    in float32 (the rank-r branch also rounds its first product, as XLA
    keeps it under jit): 1e-4 of the max (measured 2.4e-7); the float32
    model differs from JAX's bf16 one by more (8e-4 to 1.6e-3), so the
    rounding really happens."""
    model = JKernelNN(mode="edge3d", kernel_dtype="bfloat16", **_cfg(rank))
    params = jax.tree_util.tree_map(np.asarray,
                                    model.init(jax.random.PRNGKey(1)))
    g = _padded_graph(1)
    args = (g.x, g.senders, g.receivers, g.edge_attr)
    ref = np.asarray(model.apply(params, *(jnp.asarray(a) for a in args),
                                 edge_mask=jnp.asarray(g.edge_mask)))
    t = torch.as_tensor
    kw = dict(edge_mask=t(g.edge_mask))
    port = KernelNN(mode="edge3d", kernel_dtype="bfloat16",
                    **_cfg(rank)).from_jax_params(params)
    f32 = KernelNN(mode="edge3d", **_cfg(rank)).from_jax_params(params)
    with torch.no_grad():
        got = port.apply(*(t(a) for a in args), **kw).numpy()
        full = f32.apply(*(t(a) for a in args), **kw).numpy()
    assert _rel(got, ref) < 1e-4, _rel(got, ref)
    assert _rel(full, ref) > 1e-4
