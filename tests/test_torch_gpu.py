"""The port's CUDA kernels (B1 forward, B2 backward, and their rank-r
counterparts B3 and B4) against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips on a machine without CUDA.  The
file imports neither jax nor the test conftest's JAX setup, so it runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from fast_eng_super_resolution_tpu_torch.ops import fused_conv as tfc

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """Skips on a machine without CUDA (decided at run time, never at
    import, so every test worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _operands(c, k, seed, n=300, e=2500):
    rng = np.random.default_rng(seed)
    recv = np.sort(rng.integers(0, n, e)).astype(np.int32)
    send = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) > 0.2
    blocks = tfc.build_scatter_blocks(recv, send, n, mask, quantum=64)
    slots = len(blocks.senders_perm)
    h = np.maximum(rng.normal(size=(slots, k)), 0).astype(np.float32)
    x = rng.normal(size=(n, c)).astype(np.float32)
    w3 = (rng.normal(size=(k, c * c)) * 0.2).astype(np.float32)
    b3 = (rng.normal(size=(c * c,)) * 0.1).astype(np.float32)
    return blocks, h, x, w3, b3


def _layer(blocks, h, x, w3, b3, c, gemm_dtype, compact, device):
    s = (blocks.compact_s.to(device) if compact
         else torch.as_tensor(blocks.s_matrix, device=device))
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return tfc.fused_edge_conv(t(h), t(x), t(blocks.senders_perm), t(w3),
                               t(b3), s, c_in=c, c_out=c,
                               rows_blk=blocks.rows_blk, blk=blocks.blk,
                               gemm_dtype=gemm_dtype)


# Both sides round h, x and w3 to the GEMM type identically and then work in
# float32 (TF32 off), summing in different orders: 1e-5 of the max.
TOL = 1e-5


@pytest.mark.parametrize("gemm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("c", [48, 64, 5])
def test_kernel_matches_plain(cuda, c, compact, gemm_dtype):
    blocks, h, x, w3, b3 = _operands(c, k=c, seed=c)
    before = tfc.fused_edge_conv.launches
    got = _layer(blocks, h, x, w3, b3, c, gemm_dtype, compact, "cuda")
    torch.cuda.synchronize()
    assert tfc.fused_edge_conv.launches == before + 1
    ref = _layer(blocks, h, x, w3, b3, c, gemm_dtype, compact, "cpu")
    err = (got.cpu() - ref).abs().max().item() / ref.abs().max().item()
    assert err < TOL, err


def test_wrapper_checks_operands(cuda):
    blocks, h, x, w3, b3 = _operands(8, k=6, seed=7)
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    args = (t(h), t(x), t(blocks.senders_perm), t(w3), t(b3),
            blocks.compact_s.to("cuda"))
    kw = dict(c_in=8, c_out=8, rows_blk=64, blk=blocks.blk)
    with pytest.raises(TypeError):  # mixed GEMM dtypes
        tfc.fused_edge_conv_cuda(args[0].bfloat16(), *args[1:], **kw)
    with pytest.raises(TypeError):  # int64 indices
        tfc.fused_edge_conv_cuda(*args[:2], args[2].long(), *args[3:], **kw)
    with pytest.raises(ValueError):  # not contiguous
        tfc.fused_edge_conv_cuda(args[0], args[1].t().contiguous().t(),
                                 *args[2:], **kw)
    with pytest.raises(ValueError):  # 16-row blocks
        tfc.fused_edge_conv_cuda(*args, **{**kw, "rows_blk": 16})
    with pytest.raises(ValueError):  # a CPU operand among CUDA ones
        tfc.fused_edge_conv_cuda(*args[:4], args[4].cpu(), args[5], **kw)


def _bwd(blocks, g, h, x_src, w3, b3, c, gemm_dtype, compact, device):
    s = (blocks.compact_s.to(device) if compact
         else torch.as_tensor(blocks.s_matrix, device=device))
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return tfc.fused_edge_conv_bwd(t(g), t(h), t(x_src), t(w3), t(b3), s,
                                   c_in=c, c_out=c, rows_blk=blocks.rows_blk,
                                   blk=blocks.blk, gemm_dtype=gemm_dtype)


def _g(blocks, c, seed):
    return np.random.default_rng(seed).normal(
        size=(blocks.n_pad, c)).astype(np.float32)


# B2 against its plain version: both round h, x_src, w3 and dmsg = S^T g
# (a single product per slot, exact on both sides) to the GEMM type and then
# sum float32 products in different orders (TF32 off): 1e-5 of each output's
# max.
BWD_TOL = 1e-5


@pytest.mark.parametrize("gemm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("c", [48, 64, 5])
def test_bwd_kernel_matches_plain(cuda, c, compact, gemm_dtype):
    blocks, h, x, w3, b3 = _operands(c, k=c, seed=c)
    args = (blocks, _g(blocks, c, c + 1), h, x[blocks.senders_perm], w3, b3,
            c, gemm_dtype, compact)
    before = tfc.fused_edge_conv_bwd.launches
    got = _bwd(*args, "cuda")
    torch.cuda.synchronize()
    assert tfc.fused_edge_conv_bwd.launches == before + 1
    ref = _bwd(*args, "cpu")
    for name, a, b in zip(("dh", "dx_src", "dw3", "db3"), got, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        err = (a.cpu() - b).abs().max().item() / b.abs().max().item()
        assert err < BWD_TOL, (name, err)


def test_bwd_wrapper_checks_operands(cuda):
    blocks, h, x, w3, b3 = _operands(8, k=6, seed=8)
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    args = (t(_g(blocks, 8, 9)), t(h), t(x[blocks.senders_perm]), t(w3),
            t(b3), blocks.compact_s.to("cuda"))
    kw = dict(c_in=8, c_out=8, rows_blk=64, blk=blocks.blk)
    with pytest.raises(TypeError):  # mixed GEMM dtypes
        tfc.fused_edge_conv_bwd_cuda(args[0], args[1].bfloat16(), *args[2:],
                                     **kw)
    with pytest.raises(TypeError):  # g not float32
        tfc.fused_edge_conv_bwd_cuda(args[0].double(), *args[1:], **kw)
    with pytest.raises(ValueError):  # not contiguous
        tfc.fused_edge_conv_bwd_cuda(*args[:2], args[2].t().contiguous().t(),
                                     *args[3:], **kw)
    with pytest.raises(ValueError):  # 16-row blocks
        tfc.fused_edge_conv_bwd_cuda(*args, **{**kw, "rows_blk": 16})
    with pytest.raises(ValueError):  # wider than the kernel's 64
        tfc.fused_edge_conv_bwd_cuda(*args, **{**kw, "c_out": 65})
    with pytest.raises(ValueError):  # a CPU operand among CUDA ones
        tfc.fused_edge_conv_bwd_cuda(*args[:4], args[4].cpu(), args[5], **kw)


@pytest.mark.parametrize("compact", [True, False])
def test_fused_edge_conv_grads_on_card_match_cpu(cuda, compact):
    """FusedEdgeConv (B1 forward, B2 backward, index_add_ of dx over the
    dump row) on the card against the same layer's plain versions on the
    CPU, float32: 1e-5 of each gradient's max."""
    c = 16
    blocks, h, x, w3, b3 = _operands(c, k=c, seed=10)
    g = _g(blocks, c, 11)

    def grads(device):
        aux = {k: torch.as_tensor(v, device=device)
               for k, v in blocks.train_aux().items()}
        s = (blocks.compact_s.to(device) if compact
             else torch.as_tensor(blocks.s_matrix, device=device))
        ts = [torch.tensor(a, device=device, requires_grad=True)
              for a in (h, x, w3, b3)]
        out = tfc.fused_edge_conv_ad(*ts, s, aux, c_in=c, c_out=c,
                                     rows_blk=blocks.rows_blk, blk=blocks.blk)
        (out * torch.as_tensor(g, device=device)).sum().backward()
        return [t.grad.cpu() for t in ts]

    fwd, bwd = tfc.fused_edge_conv.launches, tfc.fused_edge_conv_bwd.launches
    got = grads("cuda")
    torch.cuda.synchronize()
    assert tfc.fused_edge_conv.launches == fwd + 1
    assert tfc.fused_edge_conv_bwd.launches == bwd + 1
    for name, a, b in zip(("h", "x", "w3", "b3"), got, grads("cpu")):
        err = (a - b).abs().max().item() / b.abs().max().item()
        assert err < BWD_TOL, (name, err)


def _lowrank_operands(c, rank, seed, k=None):
    """Operands of the rank-r layer at width c (K = c unless given): w3 and
    b3 are the edge MLP's head [K, 2 r c] in the model's column layout."""
    blocks, h, x, _, _ = _operands(c, k=k or c, seed=seed)
    rng = np.random.default_rng(seed + 100)
    ncol = 2 * rank * c
    w3 = (rng.normal(size=(h.shape[1], ncol)) * 0.2).astype(np.float32)
    b3 = (rng.normal(size=(ncol,)) * 0.1).astype(np.float32)
    return blocks, h, x, w3, b3


def _lowrank(blocks, h, x, w3, b3, c, rank, gemm_dtype, compact, device):
    s = (blocks.compact_s.to(device) if compact
         else torch.as_tensor(blocks.s_matrix, device=device))
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return tfc.fused_edge_conv_lowrank(
        t(h), t(x), t(blocks.senders_perm), t(w3), t(b3), s, c_in=c, c_out=c,
        rank=rank, rows_blk=blocks.rows_blk, blk=blocks.blk,
        gemm_dtype=gemm_dtype)


def _lowrank_bwd(blocks, g, h, x_src, w3, b3, c, rank, gemm_dtype, compact,
                 device):
    s = (blocks.compact_s.to(device) if compact
         else torch.as_tensor(blocks.s_matrix, device=device))
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return tfc.fused_edge_conv_lowrank_bwd(
        t(g), t(h), t(x_src), t(w3), t(b3), s, c_in=c, c_out=c, rank=rank,
        rows_blk=blocks.rows_blk, blk=blocks.blk, gemm_dtype=gemm_dtype)


# B3 and B4 against their plain versions: both round h, x (x_src), w3 and
# (B4) dmsg to the GEMM type identically, then sum float32 products in
# different orders (TF32 off): 1e-5 of each output's max, as for B1 and B2.
@pytest.mark.parametrize("gemm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("rank", [16, 3])
@pytest.mark.parametrize("c", [48, 5])
def test_lowrank_kernel_matches_plain(cuda, c, rank, compact, gemm_dtype):
    blocks, h, x, w3, b3 = _lowrank_operands(c, rank, seed=c + rank)
    args = (blocks, h, x, w3, b3, c, rank, gemm_dtype, compact)
    before = tfc.fused_edge_conv_lowrank.launches
    got = _lowrank(*args, "cuda")
    torch.cuda.synchronize()
    assert tfc.fused_edge_conv_lowrank.launches == before + 1
    ref = _lowrank(*args, "cpu")
    err = (got.cpu() - ref).abs().max().item() / ref.abs().max().item()
    assert err < TOL, err


@pytest.mark.parametrize("gemm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("rank", [16, 3])
@pytest.mark.parametrize("c", [48, 5])
def test_lowrank_bwd_kernel_matches_plain(cuda, c, rank, compact, gemm_dtype):
    blocks, h, x, w3, b3 = _lowrank_operands(c, rank, seed=c + rank)
    args = (blocks, _g(blocks, c, c + 1), h, x[blocks.senders_perm], w3, b3,
            c, rank, gemm_dtype, compact)
    before = tfc.fused_edge_conv_lowrank_bwd.launches
    got = _lowrank_bwd(*args, "cuda")
    torch.cuda.synchronize()
    assert tfc.fused_edge_conv_lowrank_bwd.launches == before + 1
    ref = _lowrank_bwd(*args, "cpu")
    for name, a, b in zip(("dh", "dx_src", "dw3", "db3"), got, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        err = (a.cpu() - b).abs().max().item() / b.abs().max().item()
        assert err < BWD_TOL, (name, err)


def test_lowrank_wrappers_check_operands(cuda):
    c, rank = 8, 4
    blocks, h, x, w3, b3 = _lowrank_operands(c, rank, seed=12, k=6)
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    fwd = (t(h), t(x), t(blocks.senders_perm), t(w3), t(b3),
           blocks.compact_s.to("cuda"))
    bwd = (t(_g(blocks, c, 13)), t(h), t(x[blocks.senders_perm]), t(w3),
           t(b3), blocks.compact_s.to("cuda"))
    kw = dict(c_in=c, c_out=c, rank=rank, rows_blk=64, blk=blocks.blk)
    for fn, args in ((tfc.fused_edge_conv_lowrank_cuda, fwd),
                     (tfc.fused_edge_conv_lowrank_bwd_cuda, bwd)):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            fn(*args[:4], args[4].cpu(), args[5], **kw)
        for bad in (0, 33):
            with pytest.raises(ValueError, match="rank"):
                fn(*args, **{**kw, "rank": bad})
        with pytest.raises(ValueError):  # a head of another rank's width
            fn(*args, **{**kw, "rank": rank - 1})
        with pytest.raises(ValueError):  # 16-row blocks
            fn(*args, **{**kw, "rows_blk": 16})
    with pytest.raises(TypeError):  # mixed GEMM dtypes
        tfc.fused_edge_conv_lowrank_cuda(fwd[0].bfloat16(), *fwd[1:], **kw)
    with pytest.raises(TypeError):  # int64 indices
        tfc.fused_edge_conv_lowrank_cuda(*fwd[:2], fwd[2].long(), *fwd[3:],
                                         **kw)
    with pytest.raises(TypeError):  # g not float32
        tfc.fused_edge_conv_lowrank_bwd_cuda(bwd[0].double(), *bwd[1:], **kw)
    with pytest.raises(TypeError):  # mixed GEMM dtypes
        tfc.fused_edge_conv_lowrank_bwd_cuda(bwd[0], bwd[1].bfloat16(),
                                             *bwd[2:], **kw)


@pytest.mark.parametrize("compact", [True, False])
def test_fused_edge_conv_lowrank_grads_on_card_match_cpu(cuda, compact):
    """FusedEdgeConvLowrank (B3 forward, B4 backward, index_add_ of dx over
    the dump row) on the card against the same layer's plain versions on
    the CPU, float32: 1e-5 of each gradient's max."""
    c, rank = 16, 4
    blocks, h, x, w3, b3 = _lowrank_operands(c, rank, seed=14)
    g = _g(blocks, c, 15)

    def grads(device):
        aux = {k: torch.as_tensor(v, device=device)
               for k, v in blocks.train_aux().items()}
        s = (blocks.compact_s.to(device) if compact
             else torch.as_tensor(blocks.s_matrix, device=device))
        ts = [torch.tensor(a, device=device, requires_grad=True)
              for a in (h, x, w3, b3)]
        out = tfc.fused_edge_conv_lowrank_ad(
            *ts, s, aux, c_in=c, c_out=c, rank=rank,
            rows_blk=blocks.rows_blk, blk=blocks.blk)
        (out * torch.as_tensor(g, device=device)).sum().backward()
        return [t.grad.cpu() for t in ts]

    fwd = tfc.fused_edge_conv_lowrank.launches
    bwd = tfc.fused_edge_conv_lowrank_bwd.launches
    got = grads("cuda")
    torch.cuda.synchronize()
    assert tfc.fused_edge_conv_lowrank.launches == fwd + 1
    assert tfc.fused_edge_conv_lowrank_bwd.launches == bwd + 1
    for name, a, b in zip(("h", "x", "w3", "b3"), got, grads("cpu")):
        err = (a - b).abs().max().item() / b.abs().max().item()
        assert err < BWD_TOL, (name, err)
