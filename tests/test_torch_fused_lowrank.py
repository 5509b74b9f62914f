"""Port of the rank-r fused edge-conv layer (B3), its backward (B4) and its
custom VJP: the plain PyTorch versions against the JAX package's Pallas
kernels run in interpret mode, the autograd Function against autograd of the
plain forward, and the dump row that keeps padding slots off node 0.  The
CUDA kernels are held against the plain versions in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_eng_super_resolution_tpu.ops import fused_conv as jfc
from fast_eng_super_resolution_tpu_torch.ops import fused_conv as tfc
from test_torch_fused_conv import _graph

C, K = 12, 8  # width 12, ker_width 8
RANKS = [3, 16]  # 3: below the TPU kernel's sublane pad, not a multiple of 4


def _operands(kind, rank, seed):
    """Scatter blocks (64-row, quantum 64) and the layer's operands, with a
    seeded output gradient g and the gathered x_src."""
    rng = np.random.default_rng(seed)
    recv, send, mask, n = _graph(kind, rng)
    blocks = tfc.build_scatter_blocks(recv, send, n, mask, quantum=64)
    slots, ncol = len(blocks.senders_perm), 2 * rank * C
    o = dict(h=(np.maximum(rng.normal(size=(slots, K)), 0) * .5).astype(np.float32),
             x=rng.normal(size=(n, C)).astype(np.float32),
             w3=(rng.normal(size=(K, ncol)) * .3).astype(np.float32),
             b3=(rng.normal(size=(ncol,)) * .1).astype(np.float32),
             g=rng.normal(size=(blocks.n_pad, C)).astype(np.float32))
    o["x_src"] = o["x"][blocks.senders_perm]
    return blocks, o


def _kw(blocks, rank):
    return dict(c_in=C, c_out=C, rank=rank, rows_blk=blocks.rows_blk,
                blk=blocks.blk)


def _s(blocks, compact):
    return (blocks.compact_s.to("cpu") if compact
            else torch.as_tensor(blocks.s_matrix))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


# float32: both sides compute the same float32 sums in different orders ->
# 1e-5 of the max.  bfloat16: h, x and w3 are rounded identically on both
# sides, but the JAX kernel also rounds uv, each u*x and v*t product and t to
# bf16 while the port keeps them in float32 -> a few bf16 epsilons (2^-8) of
# the max; 2e-2 bounds it (as for the full-rank layer).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("gemm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("kind", ["sorted", "unsorted", "isolated", "masked"])
def test_plain_lowrank_matches_pallas(kind, rank, gemm_dtype):
    blocks, o = _operands(kind, rank, seed=rank)
    ref = np.asarray(jfc.fused_edge_conv_lowrank(
        jnp.asarray(o["h"]), jnp.asarray(o["x"]),
        jnp.asarray(blocks.senders_perm), jnp.asarray(o["w3"]),
        jnp.asarray(o["b3"]), jnp.asarray(blocks.s_matrix),
        gemm_dtype=gemm_dtype, interpret=True, **_kw(blocks, rank)))
    t = torch.as_tensor
    got = {compact: tfc.fused_edge_conv_lowrank(
        t(o["h"]), t(o["x"]), t(blocks.senders_perm), t(o["w3"]), t(o["b3"]),
        _s(blocks, compact), gemm_dtype=gemm_dtype, **_kw(blocks, rank))
        for compact in (False, True)}
    torch.testing.assert_close(got[True], got[False], rtol=0, atol=0)
    assert got[True].dtype == torch.float32 and got[True].shape == ref.shape
    assert _rel(got[True].numpy(), ref) < TOL[gemm_dtype]


@pytest.mark.parametrize("gemm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("rank", RANKS)
def test_plain_lowrank_bwd_matches_pallas(rank, compact, gemm_dtype):
    """Each of dh, dx_src, dw3, db3 relative to its own max; w3's and b3's
    gradients in the model's column layout (the JAX function unpermutes)."""
    blocks, o = _operands("masked", rank, seed=10 + rank)
    ref = jfc._fused_lowrank_bwd_jit(
        jnp.asarray(o["g"]), jnp.asarray(o["h"]), jnp.asarray(o["x_src"]),
        jnp.asarray(o["w3"]), jnp.asarray(o["b3"]),
        jnp.asarray(blocks.s_matrix), sub=None, gemm_dtype=gemm_dtype,
        interpret=True, **_kw(blocks, rank))
    t = torch.as_tensor
    got = tfc.fused_edge_conv_lowrank_bwd(
        t(o["g"]), t(o["h"]), t(o["x_src"]), t(o["w3"]), t(o["b3"]),
        _s(blocks, compact), gemm_dtype=gemm_dtype, **_kw(blocks, rank))
    for name, a, b in zip(("dh", "dx_src", "dw3", "db3"), got, ref):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        err = _rel(a.numpy(), b)
        assert err < TOL[gemm_dtype], (name, err)


def test_cpu_tensors_take_plain_versions_and_count_nothing():
    blocks, o = _operands("sorted", 3, seed=20)
    t = torch.as_tensor
    before = (tfc.fused_edge_conv_lowrank.launches,
              tfc.fused_edge_conv_lowrank_bwd.launches)
    kw = _kw(blocks, 3)
    tfc.fused_edge_conv_lowrank(t(o["h"]), t(o["x"]), t(blocks.senders_perm),
                                t(o["w3"]), t(o["b3"]), _s(blocks, True),
                                gemm_dtype="bfloat16", **kw)
    tfc.fused_edge_conv_lowrank_bwd(t(o["g"]), t(o["h"]), t(o["x_src"]),
                                    t(o["w3"]), t(o["b3"]), _s(blocks, True),
                                    **kw)
    assert (tfc.fused_edge_conv_lowrank.launches,
            tfc.fused_edge_conv_lowrank_bwd.launches) == before


def test_cuda_wrappers_reject_cpu_operands():
    blocks, o = _operands("sorted", 3, seed=21)
    t = torch.as_tensor
    kw = _kw(blocks, 3)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tfc.fused_edge_conv_lowrank_cuda(
            t(o["h"]), t(o["x"]), t(blocks.senders_perm), t(o["w3"]),
            t(o["b3"]), _s(blocks, True), **kw)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tfc.fused_edge_conv_lowrank_bwd_cuda(
            t(o["g"]), t(o["h"]), t(o["x_src"]), t(o["w3"]), t(o["b3"]),
            _s(blocks, True), **kw)
    with pytest.raises(ValueError, match="rank=257"):  # checked before devices
        tfc.fused_edge_conv_lowrank_cuda(
            t(o["h"]), t(o["x"]), t(blocks.senders_perm), t(o["w3"]),
            t(o["b3"]), _s(blocks, True), **{**kw, "rank": 257})


def _layer_grads(fn, o, s):
    leaves = {k: torch.tensor(o[k], requires_grad=True)
              for k in ("h", "x", "w3", "b3")}
    out = fn(leaves["h"], leaves["x"], leaves["w3"], leaves["b3"], s)
    (out * torch.as_tensor(o["g"])).sum().backward()
    return out.detach(), [leaves[k].grad for k in ("h", "x", "w3", "b3")]


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("rank", RANKS)
def test_autograd_function_matches_autograd_of_plain(rank, compact):
    """FusedEdgeConvLowrank's forward and gradients equal autograd through
    ``fused_edge_conv_lowrank_plain`` (float32: 1e-5 of each gradient's
    max)."""
    blocks, o = _operands("masked", rank, seed=30 + rank)
    aux = {k: torch.as_tensor(v) for k, v in blocks.train_aux().items()}
    s, kw = _s(blocks, compact), _kw(blocks, rank)
    got_out, got = _layer_grads(
        lambda h, x, w3, b3, s: tfc.fused_edge_conv_lowrank_ad(
            h, x, w3, b3, s, aux, **kw), o, s)
    ref_out, ref = _layer_grads(
        lambda h, x, w3, b3, s: tfc.fused_edge_conv_lowrank_plain(
            h, x, aux["senders_perm"], w3, b3, s, **kw), o, s)
    torch.testing.assert_close(got_out, ref_out, rtol=0, atol=0)
    for name, a, b in zip(("h", "x", "w3", "b3"), got, ref):
        assert _rel(a.numpy(), b.numpy()) < 1e-5, name


def test_padding_slots_never_reach_node_0(monkeypatch):
    """Padding slots carry senders_perm 0; the layer scatters their dx_src
    to the dump row, so node 0's gradient does not change even when the
    backward hands back nonzero dx_src on padding slots."""
    blocks, o = _operands("masked", 3, seed=40)
    pad = torch.as_tensor(~blocks.slot_mask)
    assert pad.any() and np.all(blocks.senders_perm[pad.numpy()] == 0)
    aux = {k: torch.as_tensor(v) for k, v in blocks.train_aux().items()}
    s, kw = _s(blocks, True), _kw(blocks, 3)

    def x_grad():
        x = torch.tensor(o["x"], requires_grad=True)
        out = tfc.fused_edge_conv_lowrank_ad(
            torch.as_tensor(o["h"]), x, torch.as_tensor(o["w3"]),
            torch.as_tensor(o["b3"]), s, aux, **kw)
        (out * torch.as_tensor(o["g"])).sum().backward()
        return x.grad

    want = x_grad()
    bwd = tfc.fused_edge_conv_lowrank_bwd

    def noisy_bwd(*args, **kwargs):
        dh, dx_src, dw3, db3 = bwd(*args, **kwargs)
        return dh, dx_src + 100.0 * pad[:, None], dw3, db3

    monkeypatch.setattr(tfc, "fused_edge_conv_lowrank_bwd", noisy_bwd)
    torch.testing.assert_close(x_grad(), want, rtol=0, atol=0)


# Widths, K and ranks past those of the rank-r layer above, as the card's
# B3 and B4 take them (K, c_in, c_out and rank up to 256): the top corners
# at 128 and 256, one padded channel of 40 per 64 columns at width 96,
# c_in != c_out at odd ranks (past 128 too), K past 128 alone, and ranks
# past 64 (the card's slabs of 64: 65 and 100 in two, 130 in three, past
# both widths) at small widths.  At most two receiver blocks (past rank 64
# a smaller graph), so that the plain versions' [slots, r (c_in + c_out)]
# arrays and the Pallas runs stay small.
WIDE = [(128, 128, 128, 64), (96, 96, 96, 40), (72, 128, 48, 57),
        (256, 256, 256, 64), (136, 250, 200, 33), (48, 48, 256, 16),
        (24, 40, 20, 65), (16, 16, 24, 100), (8, 12, 16, 130)]


def _wide_operands(c_in, c_out, k, rank, seed):
    rng = np.random.default_rng(seed)
    n, e = (100, 500) if rank <= 64 else (60, 150)
    recv = np.sort(rng.integers(0, n, e)).astype(np.int32)
    send = rng.integers(0, n, e).astype(np.int32)
    blocks = tfc.build_scatter_blocks(recv, send, n, rng.random(e) > 0.2,
                                      quantum=64)
    assert blocks.num_blocks <= 2
    slots, ncol = len(blocks.senders_perm), rank * (c_in + c_out)
    scale = (k * c_in) ** -0.5  # messages of order one
    o = dict(h=(np.maximum(rng.normal(size=(slots, k)), 0)).astype(np.float32),
             x=rng.normal(size=(n, c_in)).astype(np.float32),
             w3=(rng.normal(size=(k, ncol)) * scale).astype(np.float32),
             b3=(rng.normal(size=(ncol,)) * scale).astype(np.float32),
             g=rng.normal(size=(blocks.n_pad, c_out)).astype(np.float32))
    o["x_src"] = o["x"][blocks.senders_perm]
    return blocks, o


@pytest.mark.parametrize("gemm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in,c_out,k,rank", WIDE)
def test_plain_lowrank_wide_matches_pallas(c_in, c_out, k, rank, gemm_dtype):
    """The plain B3 and B4 against the JAX package's Pallas kernels in
    interpret mode at widths, K and ranks up to 256, both S forms, with TOL's bounds (each output relative to its own max; w3's and
    b3's gradients in the model's column layout)."""
    blocks, o = _wide_operands(c_in, c_out, k, rank, seed=c_in + k + rank)
    kw = dict(c_in=c_in, c_out=c_out, rank=rank, rows_blk=blocks.rows_blk,
              blk=blocks.blk, gemm_dtype=gemm_dtype)
    j = {key: jnp.asarray(v) for key, v in o.items()}
    ref = np.asarray(jfc.fused_edge_conv_lowrank(
        j["h"], j["x"], jnp.asarray(blocks.senders_perm), j["w3"], j["b3"],
        jnp.asarray(blocks.s_matrix), interpret=True, **kw))
    ref_bwd = jfc._fused_lowrank_bwd_jit(
        j["g"], j["h"], j["x_src"], j["w3"], j["b3"],
        jnp.asarray(blocks.s_matrix), sub=None, interpret=True, **kw)
    t = {key: torch.as_tensor(v) for key, v in o.items()}
    for compact in (False, True):
        got = tfc.fused_edge_conv_lowrank(
            t["h"], t["x"], torch.as_tensor(blocks.senders_perm), t["w3"],
            t["b3"], _s(blocks, compact), **kw)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert _rel(got.numpy(), ref) < TOL[gemm_dtype]
        grads = tfc.fused_edge_conv_lowrank_bwd(
            t["g"], t["h"], t["x_src"], t["w3"], t["b3"], _s(blocks, compact),
            **kw)
        for name, a, b in zip(("dh", "dx_src", "dw3", "db3"), grads, ref_bwd):
            assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
            err = _rel(a.numpy(), b)
            assert err < TOL[gemm_dtype], (name, compact, err)
