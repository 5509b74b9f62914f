"""The port's CUDA kernels (B1 forward, B2 backward, their rank-r
counterparts B3 and B4, each in its float32 FMA and its bfloat16 tensor-core
design, and B5, the per-edge messages) against their plain PyTorch versions,
on the card.

Every test here is marked ``gpu`` and skips on a machine without CUDA.  The
file imports neither jax nor the test conftest's JAX setup, so it runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""

import os

import numpy as np
import pytest
import torch

from fast_eng_super_resolution_tpu_torch.ops import fused_conv as tfc
from fast_eng_super_resolution_tpu_torch.ops import pallas_mp

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


@pytest.mark.parametrize("gemm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("c,k", [(48, 128), (5, 100), (64, 65)])
def test_kernels_past_k64_match_plain(cuda, c, k, compact, gemm_dtype):
    """B1 and B2 at an edge MLP wider than the width (TEECNet's K = 128 at
    width 48; K not a multiple of 64, split unevenly), against their plain
    versions: the limits above."""
    blocks, h, x, w3, b3 = _operands(c, k=k, seed=c + k)
    fwd, bwd = tfc.fused_edge_conv.launches, tfc.fused_edge_conv_bwd.launches
    got = _layer(blocks, h, x, w3, b3, c, gemm_dtype, compact, "cuda")
    args = (blocks, _g(blocks, c, k), h, x[blocks.senders_perm], w3, b3, c,
            gemm_dtype, compact)
    got_bwd = _bwd(*args, "cuda")
    torch.cuda.synchronize()
    assert tfc.fused_edge_conv.launches == fwd + 1
    assert tfc.fused_edge_conv_bwd.launches == bwd + 1
    ref = _layer(blocks, h, x, w3, b3, c, gemm_dtype, compact, "cpu")
    err = (got.cpu() - ref).abs().max().item() / ref.abs().max().item()
    assert err < TOL, err
    for name, a, b in zip(("dh", "dx_src", "dw3", "db3"), got_bwd,
                          _bwd(*args, "cpu")):
        assert a.shape == b.shape, name
        err = (a.cpu() - b).abs().max().item() / b.abs().max().item()
        assert err < BWD_TOL, (name, err)


def test_k_limits_of_b1_and_b2(cuda):
    blocks, h, x, w3, b3 = _operands(8, k=129, seed=16)
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    kw = dict(c_in=8, c_out=8, rows_blk=64, blk=blocks.blk)
    with pytest.raises(ValueError, match="K=129"):
        tfc.fused_edge_conv_cuda(t(h), t(x), t(blocks.senders_perm), t(w3),
                                 t(b3), blocks.compact_s.to("cuda"), **kw)
    with pytest.raises(ValueError, match="K=129"):
        tfc.fused_edge_conv_bwd_cuda(
            t(_g(blocks, 8, 17)), t(h), t(x[blocks.senders_perm]), t(w3),
            t(b3), blocks.compact_s.to("cuda"), **kw)


# The bfloat16 B1 and B2 run on the tensor cores (csrc/*_wgmma.cu); the
# float32 instances keep the FMA design.  Widths and K around wgmma's
# granularity (N a multiple of 8, depth 16) and its K range.
@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("k", [1, 17, 48, 100, 128])
@pytest.mark.parametrize("c", [5, 16, 48, 64])
def test_wgmma_kernels_match_plain(cuda, c, k, compact):
    assert tfc.design(torch.bfloat16) == "wgmma"
    assert tfc.design(torch.float32) == "fma"
    blocks, h, x, w3, b3 = _operands(c, k=k, seed=10 * c + k)
    got = _layer(blocks, h, x, w3, b3, c, "bfloat16", compact, "cuda")
    args = (blocks, _g(blocks, c, k + 1), h, x[blocks.senders_perm], w3, b3,
            c, "bfloat16", compact)
    got_bwd = _bwd(*args, "cuda")
    torch.cuda.synchronize()
    ref = _layer(blocks, h, x, w3, b3, c, "bfloat16", compact, "cpu")
    err = (got.cpu() - ref).abs().max().item() / ref.abs().max().item()
    assert err < TOL, err
    for name, a, b in zip(("dh", "dx_src", "dw3", "db3"), got_bwd,
                          _bwd(*args, "cpu")):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        err = (a.cpu() - b).abs().max().item() / b.abs().max().item()
        assert err < BWD_TOL, (name, err)


def _skewed_operands(c, k, seed, n):
    """A graph whose first receiver block takes most edges, so that blk is
    large and the other blocks hold tiles of padding only (and one receiver
    block, rows 64-127, has no edge at all)."""
    rng = np.random.default_rng(seed)
    recv = np.concatenate([rng.integers(0, 64, 900),
                           rng.integers(128, n, 200)]).astype(np.int32)
    recv.sort()
    send = rng.integers(0, n, recv.size).astype(np.int32)
    blocks = tfc.build_scatter_blocks(recv, send, n, quantum=64)
    slots = len(blocks.senders_perm)
    h = np.maximum(rng.normal(size=(slots, k)), 0).astype(np.float32)
    x = rng.normal(size=(n, c)).astype(np.float32)
    w3 = (rng.normal(size=(k, c * c)) * 0.2).astype(np.float32)
    b3 = (rng.normal(size=(c * c,)) * 0.1).astype(np.float32)
    return blocks, h, x, w3, b3


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("n", [300, 50])
def test_wgmma_kernels_padding_tiles_and_one_block(cuda, n, compact):
    """Tiles of padding only (n = 300) and a graph of one receiver block
    (n = 50: every part is one tile when the card has more SMs than the
    block has tiles) against the plain versions."""
    c, k = 24, 20
    if n == 50:
        blocks, h, x, w3, b3 = _operands(c, k=k, seed=21, n=50, e=700)
        assert blocks.num_blocks == 1
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        tiles = blocks.blk // 64
        assert tfc.conv_parts(1, tiles, sms) == tiles
    else:
        blocks, h, x, w3, b3 = _skewed_operands(c, k, seed=22, n=n)
        pad_tiles = (blocks.compact_s.slot_rows.reshape(-1, 64) < 0).all(1)
        assert pad_tiles.sum() >= blocks.blk // 64
    got = _layer(blocks, h, x, w3, b3, c, "bfloat16", compact, "cuda")
    args = (blocks, _g(blocks, c, 23), h, x[blocks.senders_perm], w3, b3, c,
            "bfloat16", compact)
    got_bwd = _bwd(*args, "cuda")
    torch.cuda.synchronize()
    ref = _layer(blocks, h, x, w3, b3, c, "bfloat16", compact, "cpu")
    err = (got.cpu() - ref).abs().max().item() / ref.abs().max().item()
    assert err < TOL, err
    for name, a, b in zip(("dh", "dx_src", "dw3", "db3"), got_bwd,
                          _bwd(*args, "cpu")):
        err = (a.cpu() - b).abs().max().item() / b.abs().max().item()
        assert err < BWD_TOL, (name, err)


@pytest.mark.parametrize("compact", [True, False])
def test_wgmma_kernels_bit_identical(cuda, compact):
    """No atomics: two launches on the same inputs give the same bits."""
    c, k = 48, 128
    blocks, h, x, w3, b3 = _operands(c, k=k, seed=24)
    args = (blocks, _g(blocks, c, 25), h, x[blocks.senders_perm], w3, b3, c,
            "bfloat16", compact)
    runs = [(_layer(blocks, h, x, w3, b3, c, "bfloat16", compact, "cuda"),
             *_bwd(*args, "cuda")) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_fused_edge_conv_bf16_grads_on_card_match_cpu(cuda):
    """FusedEdgeConv in bfloat16 (the tensor-core B1 and B2) on the card
    against the same layer's plain versions on the CPU: 1e-5 of each
    gradient's max."""
    c, k = 48, 48
    blocks, h, x, w3, b3 = _operands(c, k=k, seed=26)
    g = _g(blocks, c, 27)

    def grads(device):
        aux = {key: torch.as_tensor(v, device=device)
               for key, v in blocks.train_aux().items()}
        ts = [torch.tensor(a, device=device, requires_grad=True)
              for a in (h, x, w3, b3)]
        out = tfc.fused_edge_conv_ad(*ts, blocks.compact_s.to(device), aux,
                                     c_in=c, c_out=c, rows_blk=blocks.rows_blk,
                                     blk=blocks.blk, gemm_dtype="bfloat16")
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


def _messages_operands(e, k, c, seed):
    rng = np.random.default_rng(seed)
    return (np.maximum(rng.normal(size=(e, k)), 0).astype(np.float32),
            rng.normal(size=(e, c)).astype(np.float32),
            (rng.normal(size=(k, c * c)) * 0.2).astype(np.float32),
            (rng.normal(size=(c * c,)) * 0.1).astype(np.float32))


# B5 against its plain version: both float32 (TF32 off), sums of ~(K+1) c
# products in different orders: 1e-5 of the max.
@pytest.mark.parametrize("k", [128, 48, 1])
@pytest.mark.parametrize("c", [48, 64, 5])
def test_messages_kernel_matches_plain(cuda, c, k):
    """E = 2500: the last 64-edge tile is partly masked."""
    ops = [torch.as_tensor(a) for a in _messages_operands(2500, k, c, c + k)]
    before = pallas_mp.fused_edge_messages.launches
    with torch.no_grad():
        got = pallas_mp.fused_edge_messages(*(a.cuda() for a in ops))
    torch.cuda.synchronize()
    assert pallas_mp.fused_edge_messages.launches == before + 1
    ref = pallas_mp.fused_edge_messages_plain(*ops)
    assert got.shape == ref.shape == (2500, c)
    err = (got.cpu() - ref).abs().max().item() / ref.abs().max().item()
    assert err < TOL, err


def test_messages_wrapper_checks_operands(cuda):
    h, x, w3, b3 = (torch.as_tensor(a, device="cuda")
                    for a in _messages_operands(100, 6, 8, 18))
    fn = pallas_mp.fused_edge_messages_cuda
    with pytest.raises(TypeError):  # float64
        fn(h.double(), x, w3, b3)
    with pytest.raises(ValueError):  # not contiguous
        fn(h, x.t().contiguous().t(), w3, b3)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fn(h, x, w3, b3.cpu())
    with pytest.raises(ValueError, match="K=129"):
        fn(torch.zeros(100, 129, device="cuda"), x,
           torch.zeros(129, 64, device="cuda"), b3)
    with pytest.raises(ValueError, match="c_out"):
        fn(h, x[:, :1].contiguous(), torch.zeros(6, 65, device="cuda"),
           torch.zeros(65, device="cuda"))
    with pytest.raises(RuntimeError, match="no backward"):
        pallas_mp.fused_edge_messages(h, x, w3.requires_grad_(), b3)


# B5's tensor-core design against its plain version: chip_smoke.py's
# MSG_TOL (float32 on both sides, TF32 off; the kernel's products of exact
# bf16 splits sum in another order than the plain version's float32 GEMMs),
# and the 'pallas' request against the 'edge3d' one, PALLAS_TOL (float32 end
# to end, through the layers and the overlap average), both relative to the
# max.
MSG_TOL = 5e-5
PALLAS_TOL = 1e-4


def _messages_rel(h, x, w3, b3):
    ops = [torch.as_tensor(a) for a in (h, x, w3, b3)]
    with torch.no_grad():
        got = pallas_mp.fused_edge_messages_cuda(*(a.cuda() for a in ops))
    torch.cuda.synchronize()
    ref = pallas_mp.fused_edge_messages_plain(*ops)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    return (got.cpu() - ref).abs().max().item() / ref.abs().max().item()


def _rect_messages_operands(e, k, c_in, c_out, seed):
    """B5's operands at any widths (``_messages_operands`` is square)."""
    rng = np.random.default_rng(seed)
    return (np.maximum(rng.normal(size=(e, k)), 0).astype(np.float32),
            rng.normal(size=(e, c_in)).astype(np.float32),
            (rng.normal(size=(k, c_in * c_out)) * 0.2).astype(np.float32),
            (rng.normal(size=(c_in * c_out,)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("c_in,c_out", [(1, 1), (5, 7), (24, 24), (48, 48),
                                        (64, 64)])
@pytest.mark.parametrize("k", [1, 48, 128])
@pytest.mark.parametrize("e", [1, 63, 64, 65, 4097])
def test_messages_wgmma_matches_plain(cuda, e, k, c_in, c_out):
    """One edge, a tile short of one, one, one and a bit, and many tiles
    (an odd number: one consumer warpgroup passes its last stages on)."""
    assert pallas_mp.design() == "wgmma"
    ops = _rect_messages_operands(e, k, c_in, c_out, seed=e + k + c_in)
    assert _messages_rel(*ops) < MSG_TOL


@pytest.mark.parametrize("c_in,c_out,k", [(48, 48, 48), (48, 48, 128),
                                          (5, 7, 1), (64, 64, 17)])
def test_messages_stage_image_kernel_matches_plain(cuda, c_in, c_out, k):
    """The kernel's first launch lays w3 and b3 out as the stage image:
    the same bits as ``stage_image``, its plain version."""
    _, _, w3, b3 = (torch.as_tensor(a, device="cuda")
                    for a in _rect_messages_operands(1, k, c_in, c_out, seed=k))
    image = pallas_mp.stage_image_cuda(w3, b3, c_in)
    torch.cuda.synchronize()
    want = pallas_mp.stage_image(w3.cpu(), b3.cpu(), c_in)
    assert torch.equal(image.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("scale", [1e-20, 1e15])
def test_messages_wgmma_tiny_and_huge_x(cuda, scale):
    """x_src scaled far from 1: the split parts of x keep float32's
    exponent range, so the error relative to the max stays the same."""
    h, x, w3, b3 = _rect_messages_operands(3000, 48, 48, 48, seed=11)
    assert _messages_rel(h, x * np.float32(scale), w3, b3) < MSG_TOL


def test_messages_wgmma_bit_identical(cuda):
    """Each output is written once by one thread: two launches give the
    same bits."""
    ops = [torch.as_tensor(a, device="cuda")
           for a in _rect_messages_operands(5000, 128, 48, 48, seed=12)]
    with torch.no_grad():
        a = pallas_mp.fused_edge_messages_cuda(*ops)
        b = pallas_mp.fused_edge_messages_cuda(*ops)
    assert torch.equal(a, b)


@pytest.mark.parametrize("model", ["neuralop", "teecnet"])
def test_pallas_request_matches_edge3d(cuda, model, tmp_path, monkeypatch):
    """A request served by the model in conv mode 'pallas' (the general
    lane's ``apply``, B5 per layer) against the same checkpoint in mode
    'edge3d', on the card."""
    from fast_eng_super_resolution_tpu_torch.data.dataset import SyntheticDataset
    from fast_eng_super_resolution_tpu_torch.data.reconstruct import overlap_average
    from fast_eng_super_resolution_tpu_torch.models.kernelnn import KernelNN
    from fast_eng_super_resolution_tpu_torch.models.teecnet import TEECNet
    from fast_eng_super_resolution_tpu_torch.sched.scheduler import PartitionScheduler

    monkeypatch.setenv("FESR_FUSED_PREDICT", "0")
    ds = SyntheticDataset(root=str(tmp_path / "data"), sub_size=4,
                          n_high=(16, 8, 8), n_low=(8, 4, 4), num_cases=1)

    def make(mode):
        if model == "teecnet":
            return TEECNet(4, 16, 4, 3, mode=mode, seed=1)
        return KernelNN(16, 16, 3, in_width=4, out_width=4, mode=mode, seed=1)

    log_dir = str(tmp_path / "logs")
    PartitionScheduler("p", 1, ds, make("edge3d"), train=True,
                       log_dir=log_dir)._save_model(0, make("edge3d"))
    x = ds.get_one_full_sample(0)
    n = len(ds.full_mesh(0)["points"])
    gids = [d["global_node_ids"] for d in x]
    fields = {}
    for mode in ("pallas", "edge3d"):
        sched = PartitionScheduler("p", 1, ds, make(mode), train=False,
                                   log_dir=log_dir)
        before = pallas_mp.fused_edge_messages.launches
        fields[mode] = overlap_average(sched.predict(x)[0], gids, n)
        launched = pallas_mp.fused_edge_messages.launches - before
        assert launched == (3 if mode == "pallas" else 0)
    ref, got = fields["edge3d"], fields["pallas"]
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= PALLAS_TOL * np.abs(ref).max()


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


# The bfloat16 B3 and B4 at ranks that are a multiple of 8 run on the tensor
# cores (csrc/fused_edge_conv_lowrank*_wgmma.cu); other ranks and float32
# keep the FMA design.  Widths, K and ranks around the chunks' granularity
# (whole channels of 128 // r, 8-column groups, depth 16): TOL / BWD_TOL of
# each output's max, as for the FMA design.
LOWRANK_WGMMA = [(48, 48, 16), (48, 17, 8), (16, 64, 32), (5, 1, 16),
                 (64, 48, 24), (24, 20, 16), (12, 33, 8)]


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("c,k,rank", LOWRANK_WGMMA)
def test_lowrank_wgmma_kernels_match_plain(cuda, c, k, rank, compact):
    assert tfc.design(torch.bfloat16, rank) == "wgmma"
    blocks, h, x, w3, b3 = _lowrank_operands(c, rank, seed=c + k + rank, k=k)
    fwd = tfc.fused_edge_conv_lowrank.launches
    bwd = tfc.fused_edge_conv_lowrank_bwd.launches
    got = _lowrank(blocks, h, x, w3, b3, c, rank, "bfloat16", compact, "cuda")
    args = (blocks, _g(blocks, c, k + 2), h, x[blocks.senders_perm], w3, b3,
            c, rank, "bfloat16", compact)
    got_bwd = _lowrank_bwd(*args, "cuda")
    torch.cuda.synchronize()
    assert tfc.fused_edge_conv_lowrank.launches == fwd + 1
    assert tfc.fused_edge_conv_lowrank_bwd.launches == bwd + 1
    ref = _lowrank(blocks, h, x, w3, b3, c, rank, "bfloat16", compact, "cpu")
    err = (got.cpu() - ref).abs().max().item() / ref.abs().max().item()
    assert err < TOL, err
    for name, a, b in zip(("dh", "dx_src", "dw3", "db3"), got_bwd,
                          _lowrank_bwd(*args, "cpu")):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        err = (a.cpu() - b).abs().max().item() / b.abs().max().item()
        assert err < BWD_TOL, (name, err)


def _lowrank_head(k, c, rank, seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(k, 2 * rank * c)) * 0.2).astype(np.float32),
            (rng.normal(size=(2 * rank * c,)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("n", [300, 50])
def test_lowrank_wgmma_padding_tiles_and_one_block(cuda, n, compact):
    """Tiles of padding only (n = 300) and a graph of one receiver block
    (n = 50: every part of B3's walk is one tile) against the plain
    versions."""
    c, k, rank = 24, 20, 16
    if n == 50:
        blocks, h, x, _, _ = _operands(c, k=k, seed=31, n=50, e=700)
        assert blocks.num_blocks == 1
    else:
        blocks, h, x, _, _ = _skewed_operands(c, k, seed=32, n=n)
        pad_tiles = (blocks.compact_s.slot_rows.reshape(-1, 64) < 0).all(1)
        assert pad_tiles.sum() >= blocks.blk // 64
    w3, b3 = _lowrank_head(k, c, rank, 33)
    got = _lowrank(blocks, h, x, w3, b3, c, rank, "bfloat16", compact, "cuda")
    args = (blocks, _g(blocks, c, 34), h, x[blocks.senders_perm], w3, b3, c,
            rank, "bfloat16", compact)
    got_bwd = _lowrank_bwd(*args, "cuda")
    torch.cuda.synchronize()
    ref = _lowrank(blocks, h, x, w3, b3, c, rank, "bfloat16", compact, "cpu")
    err = (got.cpu() - ref).abs().max().item() / ref.abs().max().item()
    assert err < TOL, err
    for name, a, b in zip(("dh", "dx_src", "dw3", "db3"), got_bwd,
                          _lowrank_bwd(*args, "cpu")):
        err = (a.cpu() - b).abs().max().item() / b.abs().max().item()
        assert err < BWD_TOL, (name, err)


@pytest.mark.parametrize("compact", [True, False])
def test_lowrank_wgmma_kernels_bit_identical(cuda, compact):
    """No atomics: two launches on the same inputs give the same bits."""
    c, k, rank = 48, 48, 16
    blocks, h, x, w3, b3 = _lowrank_operands(c, rank, seed=35, k=k)
    args = (blocks, _g(blocks, c, 36), h, x[blocks.senders_perm], w3, b3, c,
            rank, "bfloat16", compact)
    runs = [(_lowrank(blocks, h, x, w3, b3, c, rank, "bfloat16", compact,
                      "cuda"), *_lowrank_bwd(*args, "cuda")) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_fused_edge_conv_lowrank_bf16_grads_on_card_match_cpu(cuda):
    """FusedEdgeConvLowrank in bfloat16 (the tensor-core B3 and B4, rank
    16) on the card against the same layer's plain versions on the CPU:
    BWD_TOL of each gradient's max."""
    c, k, rank = 48, 48, 16
    blocks, h, x, w3, b3 = _lowrank_operands(c, rank, seed=37, k=k)
    g = _g(blocks, c, 38)

    def grads(device):
        aux = {key: torch.as_tensor(v, device=device)
               for key, v in blocks.train_aux().items()}
        ts = [torch.tensor(a, device=device, requires_grad=True)
              for a in (h, x, w3, b3)]
        out = tfc.fused_edge_conv_lowrank_ad(
            *ts, blocks.compact_s.to(device), aux, c_in=c, c_out=c,
            rank=rank, rows_blk=blocks.rows_blk, blk=blocks.blk,
            gemm_dtype="bfloat16")
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


def test_lowrank_occupancy_query(cuda):
    """The tensor-core B3/B4 kernels fit an SM at the model's widths."""
    occ = tfc.occupancy(48, 48, 48, rank=16)
    assert set(occ) == {"fwd", "bwd_rows", "bwd_weights"}
    assert all(v >= 1 for v in occ.values()), occ


def _routed_scheduler(tmp_path, device, gemm_dtype):
    """A two-expert KernelNN scheduler (width 16, depth 3, seeded experts)
    serving the small duct at three cases, routed by PCA + k-means fitted
    on its subdomains, on ``device``."""
    from fast_eng_super_resolution_tpu_torch.data.dataset import SyntheticDataset
    from fast_eng_super_resolution_tpu_torch.models.kernelnn import KernelNN
    from fast_eng_super_resolution_tpu_torch.sched import (
        PartitionScheduler, init_classifier, init_encoder)

    ds = SyntheticDataset(root=str(tmp_path / "data"), sub_size=4,
                          n_high=(16, 8, 8), n_low=(8, 4, 4), num_cases=3)
    log_dir = str(tmp_path / "logs")

    def make(seed):
        return KernelNN(16, 16, 3, in_width=4, out_width=4, seed=seed)

    routing = dict(encoder=init_encoder("pca", 2),
                   classifier=init_classifier("kmeans", 2))
    if not os.path.exists(os.path.join(log_dir, "models")):
        fit = PartitionScheduler("r", 2, ds, make(0), train=True,
                                 log_dir=log_dir, device="cpu", **routing)
        for i in range(2):
            fit._save_model(i, make(i + 1))
        routing = dict(encoder=init_encoder("pca", 2),
                       classifier=init_classifier("kmeans", 2))
    return ds, PartitionScheduler("r", 2, ds, make(0), train=False,
                                  log_dir=log_dir, device=device,
                                  gemm_dtype=gemm_dtype, **routing)


@pytest.mark.parametrize("gemm_dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_routed_group(cuda, tmp_path, gemm_dtype):
    """B1 against its plain version on the operands of one routed label
    group: the first layer of expert k over the merge of the subdomains
    routed to k, as the routed lane hands them over."""
    from fast_eng_super_resolution_tpu_torch.core.graph import (merge_batch,
                                                                 pad_and_bucket)
    from fast_eng_super_resolution_tpu_torch.ops.message_passing import (
        apply_edge_mlp_hidden)
    from fast_eng_super_resolution_tpu_torch.sched.serving import _as_raw_graph

    ds, sched = _routed_scheduler(tmp_path, "cuda", gemm_dtype)
    x = ds.get_one_full_sample(0)
    labels = sched._route(x)
    assert sorted(set(labels)) == [0, 1]
    k = int(labels[0])
    idx = np.flatnonzero(labels == k)
    (_, _, batch), = pad_and_bucket([_as_raw_graph(d) for d in x])
    merged, _ = merge_batch(batch.map(lambda a: a[idx]))
    expert = sched.experts[k]
    ea_b, sp, s, rows_blk, blk = expert.prepare_fused(
        merged.senders, merged.receivers, merged.edge_attr,
        merged.x.shape[0], merged.edge_mask, compact=True)
    with torch.no_grad():
        h = apply_edge_mlp_hidden(expert.edge_mlp,
                                  torch.as_tensor(ea_b, device="cuda"),
                                  torch.relu).contiguous()
        xl = expert.fc1(torch.as_tensor(merged.x, device="cuda")).contiguous()
        w3 = expert.edge_mlp[-1].weight.t().contiguous()
        b3 = expert.edge_mlp[-1].bias.contiguous()
        ops = (h, xl, torch.as_tensor(sp, device="cuda"), w3, b3)
        kw = dict(c_in=16, c_out=16, rows_blk=rows_blk, blk=blk,
                  gemm_dtype=gemm_dtype)
        before = tfc.fused_edge_conv.launches
        got = tfc.fused_edge_conv(*ops, s.to("cuda"), **kw)
        torch.cuda.synchronize()
        assert tfc.fused_edge_conv.launches == before + 1
        ref = tfc.fused_edge_conv_plain(*(t.cpu() for t in ops), s.to("cpu"),
                                        **kw)
    err = (got.cpu() - ref).abs().max().item() / ref.abs().max().item()
    assert err < TOL, err


def test_routed_request_on_card_matches_cpu(cuda, tmp_path):
    """A routed request on the card (the fused routed predict and the routed
    lane, B1 per layer per label chunk) against the same scheduler's plain
    versions on the CPU, float32: the same labels, the same refs and
    predictions within 1e-4 of the max."""
    from fast_eng_super_resolution_tpu_torch.data.reconstruct import overlap_average

    ds, card = _routed_scheduler(tmp_path, "cuda", "float32")
    _, cpu = _routed_scheduler(tmp_path, "cpu", "float32")
    x = ds.get_one_full_sample(0)
    n = len(ds.full_mesh(0)["points"])
    before = tfc.fused_edge_conv.launches
    got = card.predict(x)
    torch.cuda.synchronize()
    labels = got[2]
    groups = len(set(labels.tolist()))
    assert groups == 2
    # one chunk per label group (the request is within the edge budget)
    assert tfc.fused_edge_conv.launches - before == 3 * groups
    want = cpu.predict(x)
    np.testing.assert_array_equal(labels, want[2])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[0] + got[3], want[0] + want[3]):
        assert np.abs(a - b).max() <= PALLAS_TOL * np.abs(b).max()
    before = tfc.fused_edge_conv.launches
    lane = card.predict_full(x, n)
    torch.cuda.synchronize()
    assert card.last_lane[0] == "routed"
    assert tfc.fused_edge_conv.launches - before == 3 * groups
    ref = overlap_average(want[0], [d["global_node_ids"] for d in x], n)
    assert np.isfinite(lane[0]).all()
    assert np.abs(lane[0] - ref).max() <= PALLAS_TOL * np.abs(ref).max()


# -- physics: the projection's operators, CG and AMG on the card ------------
# one float32 operator, card vs CPU, sums in other orders: 1e-5 of the max
PHYS_TOL = 1e-5


def _duct_projection(device, shape=(16, 8, 8), seed=0):
    from fast_eng_super_resolution_tpu_torch.data.synthetic import (
        duct_field, make_duct_mesh)
    from fast_eng_super_resolution_tpu_torch.data.tensorize import cells_to_edges
    from fast_eng_super_resolution_tpu_torch.physics.projection import (
        DivergenceFreeProjection)

    mesh = make_duct_mesh(*shape)
    v, p = duct_field(mesh.points)
    v = v + 0.05 * np.random.default_rng(seed).normal(size=v.shape).astype(np.float32)
    edges = cells_to_edges(mesh.cells)
    return DivergenceFreeProjection(mesh.points, edges, v, p[:, 0],
                                    device=device)


def _rel(got, ref):
    return float((got.cpu() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("faithful", [False, True])
def test_physics_ops_card_match_cpu(cuda, faithful):
    """Weights (and the fallback-branch count), divergence, the composite A
    and its adjoint A^T (gathers over the transposed table) and the
    pressure correction: card against CPU, float32, 1e-5 of the max."""
    from fast_eng_super_resolution_tpu_torch.physics import divergence as pdiv

    cpu, card = _duct_projection("cpu"), _duct_projection("cuda")
    fn = pdiv.compute_weights if faithful else pdiv.compute_gradient_weights
    if faithful:
        (w_g, s_g), (w_c, s_c) = (fn(card.points, card.nbr, card.mask, True),
                                  fn(cpu.points, cpu.nbr, cpu.mask, True))
        assert int(s_g.sum()) == int(s_c.sum())
    else:
        w_g, w_c = (fn(card.points, card.nbr, card.mask),
                    fn(cpu.points, cpu.nbr, cpu.mask))
    assert _rel(w_g, w_c) < PHYS_TOL
    w = w_c
    q = torch.as_tensor(np.random.default_rng(1).standard_normal(
        len(w)).astype(np.float32))
    out = {}
    for side, proj, ws, x in (("cpu", cpu, w, q),
                              ("card", card, w.cuda(), q.cuda())):
        mv, _ = pdiv.make_consistent_matvec(proj.nbr, proj.mask, ws,
                                            trace=not faithful)
        rmv = pdiv.make_consistent_rmatvec(proj.nbr, proj.mask, ws,
                                           proj.table, trace=not faithful)
        div = (pdiv.compute_divergence if faithful
               else pdiv.compute_divergence_trace)
        out[side] = (mv(x), rmv(x), div(proj.velocity, proj.nbr, proj.mask, ws),
                     pdiv.apply_pressure_correction(proj.velocity, x, proj.nbr,
                                                    proj.mask, ws, 0.5))
    for got, ref in zip(out["card"], out["cpu"]):
        assert _rel(got, ref) < PHYS_TOL


@pytest.mark.parametrize("trace", [True, False])
def test_physics_adjoint_dot_product_on_card(cuda, trace):
    """<y, A q> = <A^T y, q> on the card, float64."""
    from fast_eng_super_resolution_tpu_torch.physics import divergence as pdiv

    card = _duct_projection("cuda")
    w = card.weights.double()
    mv, _ = pdiv.make_consistent_matvec(card.nbr, card.mask, w, trace=trace)
    rmv = pdiv.make_consistent_rmatvec(card.nbr, card.mask, w, card.table,
                                       trace=trace)
    g = torch.Generator(device="cuda").manual_seed(0)
    y = torch.randn(len(w), dtype=torch.float64, device="cuda", generator=g)
    q = torch.randn(len(w), dtype=torch.float64, device="cuda", generator=g)
    lhs, rhs = float(y @ mv(q)), float(rmv(y) @ q)
    assert abs(lhs - rhs) <= 1e-10 * max(abs(lhs), 1.0)


@pytest.mark.parametrize("loop", ["host", "device"])
def test_physics_projection_repeats_bit_identical(cuda, loop):
    """No operator scatters (no float atomics), so two projections of one
    field on the card give the same bits; and the card's result agrees
    with the CPU's within the loops' tolerance (final norm rtol 2e-2, field
    within 2e-2 of its max)."""
    runs = []
    for device in ("cuda", "cuda", "cpu"):
        proj = _duct_projection(device)
        if loop == "host":
            res = proj.apply_divergence_free_projection(max_iterations=8,
                                                        tolerance=1e-3)
        else:
            res = proj.apply_divergence_free_projection_device(
                max_iterations=8, tolerance=1e-3, precond="amg")
        runs.append(res)
    (v1, p1, f1, _), (v2, p2, f2, _), (vc, _, fc, _) = runs
    assert torch.equal(v1, v2) and torch.equal(p1, p2) and f1 == f2
    assert abs(f1 - fc) <= 2e-2 * fc
    assert _rel(v1, vc) < 2e-2


def test_physics_vcycle_card_matches_cpu(cuda):
    """One V-cycle on the same host-built hierarchy (an implicit level 0
    applying the composite pair, Chebyshev degree 3), card vs CPU: 1e-4 of
    the max (about ten float32 operator passes)."""
    from fast_eng_super_resolution_tpu_torch.physics import amg as pamg

    cpu = _duct_projection("cpu")
    N = pamg.assemble_normal(cpu.nbr.numpy(), cpu.mask.numpy(),
                             cpu.weights.numpy(), a_drop=0.0)
    levels, cinv = pamg.build_hierarchy(N, implicit_level0=True)
    assert levels and "agg" in levels[0]
    from fast_eng_super_resolution_tpu_torch.physics import divergence as pdiv

    card = _duct_projection("cuda")
    r = torch.as_tensor(np.random.default_rng(2).standard_normal(
        N.shape[0]).astype(np.float32))
    out = {}
    for side, proj in (("cpu", cpu), ("card", card)):
        dev = proj.device
        w = cpu.weights.to(dev)   # the same weights on both sides
        mv, _ = pdiv.make_consistent_matvec(proj.nbr, proj.mask, w)
        rmv = pdiv.make_consistent_rmatvec(proj.nbr, proj.mask, w, proj.table)
        lv, ci = pamg.levels_from_arrays(levels, cinv, dev)
        out[side] = pamg.make_vcycle(lv, ci, cheb_degree=3, smooth_band=16.0,
                                     matvec0=lambda q, mv=mv, rmv=rmv: rmv(mv(q)))(
                                         r.to(dev))
    assert _rel(out["card"], out["cpu"]) < 1e-4


def test_physics_wss_card_matches_cpu(cuda):
    """The WSS post-pass on the card against the CPU: 1e-5 of the
    magnitude's max."""
    from fast_eng_super_resolution_tpu_torch.data.synthetic import (
        duct_field, make_duct_mesh)
    from fast_eng_super_resolution_tpu_torch.data.tensorize import cells_to_edges
    from fast_eng_super_resolution_tpu_torch.physics.wss import (
        compute_wall_shear_stress)

    mesh = make_duct_mesh(10, 6, 6)
    v, _ = duct_field(mesh.points)
    edges = cells_to_edges(mesh.cells)
    ids_g, tau_g, mag_g = compute_wall_shear_stress(
        mesh.points, mesh.cells, edges, v, 1e-3, device="cuda")
    ids_c, tau_c, mag_c = compute_wall_shear_stress(
        mesh.points, mesh.cells, edges, v, 1e-3, device="cpu")
    np.testing.assert_array_equal(ids_g, ids_c)
    assert np.abs(mag_g - mag_c).max() <= 1e-5 * mag_c.max()
    assert np.abs(tau_g - tau_c).max() <= 1e-5 * mag_c.max()


# -- the grid family (no kernel: torch.fft / einsums on the card) ----------

def _grid_model(name, impl):
    from fast_eng_super_resolution_tpu_torch.models import fno

    m = (fno.FNO2d(4, 4, 8, in_feats=1) if name == "fno2d"
         else fno.FNO3d(3, 3, 3, 8, in_feats=1))
    m.spectral_impl = impl
    return m


@pytest.mark.parametrize("impl", ["fft", "matmul"])
@pytest.mark.parametrize("name", ["fno2d", "fno3d"])
def test_grid_forward_and_train_step_card_match_cpu(cuda, name, impl,
                                                    monkeypatch):
    """The same weights and batch on the card and the CPU (TF32 off):
    forward rel 1e-5 of the max, and one GridTrainer step's loss and
    gradients rel 1e-4 (float32 in other summation orders; the card's
    'fft' runs cuFFT on the explicitly Hermitian spectrum)."""
    from fast_eng_super_resolution_tpu_torch.parallel.grid_train import GridTrainer

    monkeypatch.delenv("FESR_FNO_IMPL", raising=False)
    shape = (2, 16, 16, 1) if name == "fno2d" else (2, 12, 12, 12, 1)
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    y = (rng.normal(size=shape) * 0.1).astype(np.float32)
    out, loss, grads = {}, {}, {}
    for dev in ("cuda", "cpu"):
        tr = GridTrainer(_grid_model(name, impl).to(dev), lr=1e-3,
                         out_channels=1)
        opt = tr.init(0, x)
        xt, yt = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
        out[dev] = tr.predict(xt).cpu()
        loss[dev] = float(tr.step(opt, xt, yt))
        grads[dev] = {k: v.grad.cpu() for k, v in tr.net.named_parameters()}
    assert _rel(out["cuda"], out["cpu"]) < 1e-5
    assert abs(loss["cuda"] - loss["cpu"]) / loss["cpu"] < 1e-4
    for k, g in grads["cpu"].items():
        err = float((grads["cuda"][k] - g).norm() / g.norm())
        assert err < 1e-4, (k, err)
