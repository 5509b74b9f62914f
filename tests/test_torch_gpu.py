"""The port's CUDA kernel against its plain PyTorch version, on the card.

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
