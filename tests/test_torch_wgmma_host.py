"""Host-side pieces of the bfloat16 tensor-core B1 and B2 (csrc/*_wgmma.cu;
the float32 ones are tests/test_torch_f32_wgmma_host.py's),
on the CPU: the forward's split planner, the weights kernel's tiling and
slot splits, the operand checks of the wrappers, and the exact hi/lo split
of bf16 products that the weights kernel relies on."""

import numpy as np
import pytest
import torch

from fast_eng_super_resolution_tpu_torch.ops import fused_conv as tfc


def test_design_by_type():
    assert tfc.design(torch.bfloat16) == "wgmma"
    assert tfc.design(torch.float32) == "wgmma"


# (num_blocks, tiles per receiver block, SMs): the serving chunk, KernelNN's
# and TEECNet's train batches, one receiver block, more SMs than tiles
PLANS = [(304, 16, 132), (912, 16, 132), (152, 16, 132), (1, 16, 132),
         (1, 1, 132), (3, 2, 132), (5000, 4, 132), (304, 16, 1), (7, 9, 8)]


@pytest.mark.parametrize("nb,tiles,sms", PLANS)
def test_conv_parts_cover_every_tile_once_in_order(nb, tiles, sms):
    parts = tfc.conv_parts(nb, tiles, sms)
    assert 1 <= parts <= tiles
    bounds = tfc.part_bounds(tiles, parts)
    assert len(bounds) == parts
    # in order, contiguous, every tile once, at least one tile per part
    assert bounds[0][0] == 0 and bounds[-1][1] == tiles
    for (lo, hi), (nxt, _) in zip(bounds, bounds[1:] + [(tiles, None)]):
        assert lo < hi == nxt
    covered = [t for lo, hi in bounds for t in range(lo, hi)]
    assert covered == list(range(tiles))


def test_conv_parts_fill_the_card():
    # a grid of at least two waves of three blocks per SM where the tiles
    # allow it; one part per tile where they do not
    for nb, tiles, sms in PLANS:
        parts = tfc.conv_parts(nb, tiles, sms)
        assert nb * parts >= min(nb * tiles, 6 * sms)
    assert tfc.conv_parts(304, 16, 132) == 3
    assert tfc.conv_parts(912, 16, 132) == 1
    assert tfc.conv_parts(152, 16, 132) == 6
    assert tfc.conv_parts(1, 16, 132) == 16


@pytest.mark.parametrize("k,c_in,c_out", [(48, 48, 48), (128, 48, 48),
                                          (1, 5, 5), (17, 64, 64),
                                          (100, 16, 5), (64, 1, 1)])
def test_weight_tiles_cover_the_output_once(k, c_in, c_out):
    cols, rows = tfc.weight_tiles(k, c_in, c_out)
    cover = np.zeros((rows * 64, cols * 128), np.int32)
    for m in range(rows):
        for n in range(cols):
            cover[m * 64:(m + 1) * 64, n * 128:(n + 1) * 128] += 1
    assert (cover[:k, :c_in * c_out] == 1).all()
    # no tile lies wholly outside the output
    assert (rows - 1) * 64 < k and (cols - 1) * 128 < c_in * c_out


@pytest.mark.parametrize("slots,tiles,sms", [(247_808, 18, 132),
                                             (64, 36, 132), (640, 1, 132),
                                             (155_648, 36, 8)])
def test_weight_splits_cover_every_chunk_once(slots, tiles, sms):
    splits = tfc.weight_splits(slots, tiles, sms)
    chunks = slots // 64
    assert 1 <= splits <= chunks
    per = -(-chunks // splits)  # as the kernels cut them
    got = [c for s in range(splits)
           for c in range(s * per, min((s + 1) * per, chunks))]
    assert got == list(range(chunks))


def _small(dt=torch.bfloat16, c=8, k=6):
    rng = np.random.default_rng(3)
    recv = np.sort(rng.integers(0, 100, 300)).astype(np.int32)
    send = rng.integers(0, 100, 300).astype(np.int32)
    blocks = tfc.build_scatter_blocks(recv, send, 100, quantum=64)
    slots = len(blocks.senders_perm)
    t = lambda a, d=dt: torch.as_tensor(a).to(d)  # noqa: E731
    fwd = (t(rng.normal(size=(slots, k))), t(rng.normal(size=(100, c))),
           torch.as_tensor(blocks.senders_perm),
           t(rng.normal(size=(k, c * c))),
           t(rng.normal(size=(c * c,)), torch.float32), blocks.compact_s.to("cpu"))
    bwd = (t(rng.normal(size=(blocks.n_pad, c)), torch.float32), fwd[0],
           t(rng.normal(size=(slots, c))), fwd[3], fwd[4], fwd[5])
    return blocks, fwd, bwd, dict(c_in=c, c_out=c, rows_blk=64, blk=blocks.blk)


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("bad,match", [
    ({"c_out": 65}, "c_out=65"), ({"c_in": 0}, "c_in=0"),
    ({"rows_blk": 16}, "rows_blk=16"), ({"blk": 32}, "blk=32")])
def test_wrappers_refuse_geometry_before_launch(which, bad, match):
    """The bfloat16 wrappers refuse what the tensor-core kernels do not take
    (widths past 64, blocks of other than 64 rows, blk not a multiple of
    64) before they look for a card."""
    _, fwd, bwd, kw = _small()
    fn, args = ((tfc.fused_edge_conv_cuda, fwd) if which == "fwd"
                else (tfc.fused_edge_conv_bwd_cuda, bwd))
    with pytest.raises(ValueError, match=match):
        fn(*args, **{**kw, **bad})


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_wrappers_refuse_k_past_128_and_cpu_tensors(which):
    _, fwd, bwd, kw = _small(k=129)
    fn, args = ((tfc.fused_edge_conv_cuda, fwd) if which == "fwd"
                else (tfc.fused_edge_conv_bwd_cuda, bwd))
    with pytest.raises(ValueError, match="K=129"):
        fn(*args, **kw)
    _, fwd, bwd, kw = _small()
    args = fwd if which == "fwd" else bwd
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fn(*args, **kw)


def test_bf16_product_split_is_exact():
    """p = a b for bf16 a, b has at most 16 significant bits, so hi =
    bf16(p) and lo = bf16(p - hi) give hi + lo == p exactly in float32 (and
    in float64), across the exponent range the gradients use."""
    rng = np.random.default_rng(0)
    n = 200_000
    mant = rng.uniform(1.0, 2.0, (2, n)) * rng.choice([-1.0, 1.0], (2, n))
    expo = rng.integers(-55, 56, (2, n))
    a, b = (torch.as_tensor(mant * np.exp2(expo), dtype=torch.float32)
            .to(torch.bfloat16).float())
    p = a * b
    assert torch.equal(p.double(), a.double() * b.double())  # p exact
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    assert torch.equal(hi + lo, p)
    assert torch.equal(hi.double() + lo.double(), p.double())
    # the split is not trivial: lo carries bits for most products
    assert (lo != 0).float().mean() > 0.9
