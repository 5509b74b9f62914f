"""Port of the fused edge-conv layer's backward (B2) and its custom VJP:
the plain PyTorch backward against the JAX package's Pallas backward run in
interpret mode, the autograd Function against autograd of the plain forward,
and the dump row that keeps padding slots off node 0.  The CUDA kernel is
held against the plain version in tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_eng_super_resolution_tpu.ops import fused_conv as jfc
from fast_eng_super_resolution_tpu_torch.ops import fused_conv as tfc

# tests/test_fused.py:278-320's shape: c_in < 8 and c_in != c_out
C_IN, C_OUT, K = 4, 6, 4


def _operands(seed, n=90, e=600, rows_blk=16):
    rng = np.random.default_rng(seed)
    recv = np.sort(rng.integers(0, n, e)).astype(np.int32)
    send = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) > 0.2
    blocks = tfc.build_scatter_blocks(recv, send, n, mask, rows_blk=rows_blk,
                                      quantum=64)
    slots = len(blocks.senders_perm)
    ops = dict(
        g=rng.normal(size=(blocks.n_pad, C_OUT)).astype(np.float32),
        h=(np.maximum(rng.normal(size=(slots, K)), 0) * .5).astype(np.float32),
        x=rng.normal(size=(n, C_IN)).astype(np.float32),
        w3=(rng.normal(size=(K, C_IN * C_OUT)) * .2).astype(np.float32),
        b3=(rng.normal(size=(C_IN * C_OUT,)) * .1).astype(np.float32))
    ops["x_src"] = ops["x"][blocks.senders_perm]
    return blocks, ops


def _kw(blocks):
    return dict(c_in=C_IN, c_out=C_OUT, rows_blk=blocks.rows_blk,
                blk=blocks.blk)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


# float32: both sides compute the same float32 sums in different orders ->
# 1e-5 of each output's max.  bfloat16: both round h, x_src and w3 the same
# way, but the JAX kernel also rounds g, S, W = h@w3+b3 and the [sub, c2]
# products to bf16 while the port rounds only dmsg and keeps the rest in
# float32 -> a few bf16 epsilons (2^-8) of the max; 2e-2 bounds it.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("gemm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compact", [False, True])
def test_plain_bwd_matches_pallas(compact, gemm_dtype):
    blocks, o = _operands(seed=1)
    ref = jfc.fused_edge_conv_bwd(
        jnp.asarray(o["g"]), jnp.asarray(o["h"]), jnp.asarray(o["x_src"]),
        jnp.asarray(o["w3"]), jnp.asarray(o["b3"]),
        jnp.asarray(blocks.s_matrix), gemm_dtype=gemm_dtype, interpret=True,
        **_kw(blocks))
    s = (blocks.compact_s.to("cpu") if compact
         else torch.as_tensor(blocks.s_matrix))
    t = torch.as_tensor
    got = tfc.fused_edge_conv_bwd(t(o["g"]), t(o["h"]), t(o["x_src"]),
                                  t(o["w3"]), t(o["b3"]), s,
                                  gemm_dtype=gemm_dtype, **_kw(blocks))
    for name, a, b in zip(("dh", "dx_src", "dw3", "db3"), got, ref):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        err = _rel(a.numpy(), b)
        assert err < TOL[gemm_dtype], (name, err)


def test_cpu_tensors_take_plain_bwd_and_count_nothing():
    blocks, o = _operands(seed=2)
    t = torch.as_tensor
    before = tfc.fused_edge_conv_bwd.launches
    tfc.fused_edge_conv_bwd(t(o["g"]), t(o["h"]), t(o["x_src"]), t(o["w3"]),
                            t(o["b3"]), blocks.compact_s.to("cpu"),
                            **_kw(blocks))
    assert tfc.fused_edge_conv_bwd.launches == before


def test_bwd_cuda_wrapper_rejects_cpu_operands():
    blocks, o = _operands(seed=3, rows_blk=64)
    t = torch.as_tensor
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tfc.fused_edge_conv_bwd_cuda(t(o["g"]), t(o["h"]), t(o["x_src"]),
                                     t(o["w3"]), t(o["b3"]),
                                     blocks.compact_s.to("cpu"), **_kw(blocks))


def test_padding_slots_never_reach_node_0():
    """Padding slots carry senders_perm 0; their dx_src goes to the dump row
    (``senders_dump`` = n) and is dropped, so node 0's gradient is the sum
    over its real slots only, even when padding slots hold nonzero dx_src."""
    blocks, o = _operands(seed=4)
    aux = blocks.train_aux()
    pad = ~blocks.slot_mask
    assert pad.any() and np.all(blocks.senders_perm[pad] == 0)
    assert np.all(aux["senders_dump"][pad] == blocks.n_nodes)
    dx_src = torch.as_tensor(np.random.default_rng(5).normal(
        size=(len(pad), C_IN)).astype(np.float32))
    dx = tfc.scatter_dx(dx_src, torch.as_tensor(aux["senders_dump"]),
                        blocks.n_nodes)
    real = torch.as_tensor(blocks.slot_mask)
    want = torch.zeros(blocks.n_nodes, C_IN).index_add_(
        0, torch.as_tensor(blocks.senders_perm).long()[real], dx_src[real])
    torch.testing.assert_close(dx, want, rtol=0, atol=0)
    # a scatter over senders_perm itself would have moved node 0
    naive = torch.zeros(blocks.n_nodes, C_IN).index_add_(
        0, torch.as_tensor(blocks.senders_perm).long(), dx_src)
    assert not torch.allclose(naive[0], want[0])


def _layer_grads(fn, blocks, o, s, g):
    t = {k: torch.tensor(o[k], requires_grad=True)
         for k in ("h", "x", "w3", "b3")}
    out = fn(t["h"], t["x"], t["w3"], t["b3"], s)
    (out * torch.as_tensor(g)).sum().backward()
    return out.detach(), [t[k].grad for k in ("h", "x", "w3", "b3")]


@pytest.mark.parametrize("compact", [False, True])
def test_autograd_function_matches_autograd_of_plain(compact):
    """FusedEdgeConv's forward and gradients equal autograd through
    ``fused_edge_conv_plain`` (float32: 1e-5 of each gradient's max)."""
    blocks, o = _operands(seed=6)
    aux = {k: torch.as_tensor(v) for k, v in blocks.train_aux().items()}
    s = (blocks.compact_s.to("cpu") if compact
         else torch.as_tensor(blocks.s_matrix))
    kw = _kw(blocks)
    got_out, got = _layer_grads(
        lambda h, x, w3, b3, s: tfc.fused_edge_conv_ad(h, x, w3, b3, s, aux,
                                                       **kw),
        blocks, o, s, o["g"])
    ref_out, ref = _layer_grads(
        lambda h, x, w3, b3, s: tfc.fused_edge_conv_plain(
            h, x, aux["senders_perm"], w3, b3, s, **kw),
        blocks, o, s, o["g"])
    torch.testing.assert_close(got_out, ref_out, rtol=0, atol=0)
    for name, a, b in zip(("h", "x", "w3", "b3"), got, ref):
        assert _rel(a.numpy(), b.numpy()) < 1e-5, name
