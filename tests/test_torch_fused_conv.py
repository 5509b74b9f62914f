"""Port of ops/fused_conv.py: host operands and the fused layer against the
JAX package.

The host half (scatter blocks, prepare_fused) must build identical arrays;
the layer's plain PyTorch version must match the Pallas kernel run in
interpret mode.  The CUDA kernel itself is held against the plain version in
tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_eng_super_resolution_tpu.ops import fused_conv as jfc
from fast_eng_super_resolution_tpu_torch.ops import fused_conv as tfc


def _graph(kind, rng, n=150, e=900):
    recv = np.sort(rng.integers(0, n, e)).astype(np.int32)
    send = rng.integers(0, n, e).astype(np.int32)
    mask = None
    if kind == "unsorted":
        perm = rng.permutation(e)
        recv, send = recv[perm], send[perm]
    elif kind == "isolated":
        keep = (recv % 7 != 0) & (recv < n - 20)  # isolated nodes + empty tail
        recv, send = recv[keep], send[keep]
    elif kind == "masked":
        mask = rng.random(e) > 0.2
    return recv, send, mask, n


def _mlp(rng, c_in, c_out, k):
    return [(rng.normal(size=(1, k)) * 0.5).astype(np.float32),
            (rng.normal(size=(k,)) * 0.1).astype(np.float32),
            (rng.normal(size=(k, k)) * 0.3).astype(np.float32),
            (rng.normal(size=(k,)) * 0.1).astype(np.float32),
            (rng.normal(size=(k, c_in * c_out)) * 0.2).astype(np.float32),
            (rng.normal(size=(c_in * c_out,)) * 0.1).astype(np.float32)]


def _hidden(mlp, ea):
    w1, b1, w2, b2 = mlp[:4]
    return np.maximum(np.maximum(ea @ w1 + b1, 0) @ w2 + b2, 0).astype(np.float32)


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "isolated", "masked"])
def test_scatter_blocks_and_prepare_identical(kind):
    rng = np.random.default_rng(1)
    recv, send, mask, n = _graph(kind, rng)
    ea = rng.random((len(recv), 1)).astype(np.float32)
    for kw in (dict(), dict(rows_blk=16, quantum=64)):
        a = jfc.build_scatter_blocks(recv, send, n, mask, **kw)
        b = tfc.build_scatter_blocks(recv, send, n, mask, **kw)
        for f in ("edge_perm", "s_matrix", "senders_perm", "slot_mask"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert getattr(a, f).dtype == getattr(b, f).dtype
        for f in ("rows_blk", "blk", "num_blocks", "n_nodes", "n_pad"):
            assert getattr(a, f) == getattr(b, f)
        np.testing.assert_array_equal(a.compact_s.slot_rows, b.compact_s.slot_rows)
        np.testing.assert_array_equal(a.compact_s.row_weight, b.compact_s.row_weight)
        for key in ("senders_perm", "senders_dump"):
            np.testing.assert_array_equal(a.train_aux()[key], b.train_aux()[key])
        # padding slots: sender 0, no row
        pad = ~b.slot_mask
        assert np.all(b.senders_perm[pad] == 0)
        assert np.all(b.compact_s.slot_rows[pad] == -1)
    for compact in (False, True):
        pa = jfc.prepare_fused(send, recv, ea, n, mask, compact=compact)
        pb = tfc.prepare_fused(send, recv, ea, n, mask, compact=compact)
        ta = jfc.prepare_fused_train(send, recv, ea, n, mask, compact=compact)
        tb = tfc.prepare_fused_train(send, recv, ea, n, mask, compact=compact)
        for x, y in ((pa, pb), (ta, tb)):
            np.testing.assert_array_equal(x[0], y[0])
            if isinstance(x[1], dict):
                for key in x[1]:
                    np.testing.assert_array_equal(x[1][key], y[1][key])
            else:
                np.testing.assert_array_equal(x[1], y[1])
            if compact:
                np.testing.assert_array_equal(x[2].slot_rows, y[2].slot_rows)
                np.testing.assert_array_equal(x[2].row_weight, y[2].row_weight)
            else:
                np.testing.assert_array_equal(x[2], y[2])
            assert x[3:] == y[3:]


def test_scatter_blocks_size_guard():
    recv = np.sort(np.random.default_rng(0).integers(0, 1000, 5000)).astype(np.int32)
    send = np.zeros(5000, np.int32)
    with pytest.raises(ValueError, match="scatter blocks"):
        tfc.build_scatter_blocks(recv, send, 1000, max_s_bytes=1000)


def _layer_operands(kind, c, k, seed):
    rng = np.random.default_rng(seed)
    recv, send, mask, n = _graph(kind, rng)
    mlp = _mlp(rng, c, c, k)
    x = rng.normal(size=(n, c)).astype(np.float32)
    ea = rng.random((len(recv), 1)).astype(np.float32)
    blocks = tfc.build_scatter_blocks(recv, send, n, mask, quantum=64)
    h = _hidden(mlp, ea[blocks.edge_perm])
    return blocks, h, x, mlp[4], mlp[5], n


def _jax_layer(blocks, h, x, w3, b3, c, gemm_dtype, xe_impl):
    return np.asarray(jfc.fused_edge_conv(
        jnp.asarray(h), jnp.asarray(x), jnp.asarray(blocks.senders_perm),
        jnp.asarray(w3), jnp.asarray(b3), jnp.asarray(blocks.s_matrix),
        c_in=c, c_out=c, rows_blk=blocks.rows_blk, blk=blocks.blk,
        gemm_dtype=gemm_dtype, interpret=True, xe_impl=xe_impl))


def _torch_layer(blocks, h, x, w3, b3, c, gemm_dtype, compact, device="cpu"):
    s = (blocks.compact_s.to(device) if compact
         else torch.as_tensor(blocks.s_matrix, device=device))
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return tfc.fused_edge_conv(t(h), t(x), t(blocks.senders_perm), t(w3),
                               t(b3), s, c_in=c, c_out=c,
                               rows_blk=blocks.rows_blk, blk=blocks.blk,
                               gemm_dtype=gemm_dtype)


# f32: both sides compute the same f32 sums in different orders -> 1e-5 of
# the output's max.  bf16: h, x, w3 are rounded identically on both sides,
# but the JAX 'repeat' layout also rounds each x*W product to bf16 before
# its fold GEMM while the port keeps it in f32 -> up to ~bf16 epsilon (2^-8)
# relative per product; 2e-2 of the max bounds the accumulated difference.
_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("gemm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("xe_impl", ["repeat", "gemm"])
@pytest.mark.parametrize("c", [8, 5])  # 5: the odd-width fold fallback
def test_plain_layer_matches_pallas(c, xe_impl, gemm_dtype):
    blocks, h, x, w3, b3, n = _layer_operands("masked", c, k=6, seed=c)
    ref = _jax_layer(blocks, h, x, w3, b3, c, gemm_dtype, xe_impl)
    got = _torch_layer(blocks, h, x, w3, b3, c, gemm_dtype, compact=True)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err < _TOL[gemm_dtype], err


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "isolated", "masked"])
def test_dense_and_compact_s_agree(kind):
    blocks, h, x, w3, b3, n = _layer_operands(kind, 8, k=6, seed=3)
    dense = _torch_layer(blocks, h, x, w3, b3, 8, "float32", compact=False)
    compact = _torch_layer(blocks, h, x, w3, b3, 8, "float32", compact=True)
    np.testing.assert_array_equal(dense.numpy(), compact.numpy())
    ref = _jax_layer(blocks, h, x, w3, b3, 8, "float32", "gemm")
    assert np.abs(dense.numpy() - ref).max() / np.abs(ref).max() < 1e-5


def test_cpu_tensors_take_plain_version_and_count_nothing():
    blocks, h, x, w3, b3, n = _layer_operands("sorted", 8, k=6, seed=4)
    before = tfc.fused_edge_conv.launches
    _torch_layer(blocks, h, x, w3, b3, 8, "bfloat16", compact=True)
    assert tfc.fused_edge_conv.launches == before


def test_cuda_wrapper_rejects_cpu_operands():
    blocks, h, x, w3, b3, n = _layer_operands("sorted", 8, k=6, seed=5)
    t = torch.as_tensor
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tfc.fused_edge_conv_cuda(t(h), t(x), t(blocks.senders_perm), t(w3),
                                 t(b3), blocks.compact_s.to("cpu"), c_in=8,
                                 c_out=8, rows_blk=64, blk=blocks.blk)
