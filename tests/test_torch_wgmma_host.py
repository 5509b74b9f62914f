"""Host-side pieces of the bfloat16 tensor-core B1 and B2 (csrc/*_wgmma.cu;
the float32 ones are tests/test_torch_f32_wgmma_host.py's),
on the CPU: the forward's split planner, the weights kernel's tiling and
slot splits, the operand checks of the wrappers, the exact hi/lo split
of bf16 products that the weights kernel relies on, and numpy emulations of
the kernels' loops at widths up to 128 (B1's tile loop: the gather, X @ B3
on the CUDA cores, a product per row of w3 weighted by h, the scatter into
per-part sums; B2's rows kernel and its weights kernel) against the plain
versions, a float64 reference and the JAX package's Pallas kernels in
interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_eng_super_resolution_tpu.ops import fused_conv as jfc
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


# (K, c_in, c_out): every width up to 128 at K up to 128 in one chunk;
# past them, chunks of the widest N that fits a block's shared memory
CHUNKED = [(8, 8, 8), (128, 128, 128), (128, 72, 100), (256, 128, 128),
           (256, 256, 256), (128, 256, 256), (129, 129, 129), (200, 136, 250),
           (256, 48, 256), (72, 256, 40), (1, 256, 1)]


@pytest.mark.parametrize("k,c_in,c_out", CHUNKED)
def test_chunks_fit_a_block_and_cover_every_column(k, c_in, c_out):
    """B1's column chunks of c_out (each a block of its own) and B2's rows
    kernel's chunks of c_in (walked in turn): N a multiple of 8 up to 128
    whose layout fits the 227 KB a block may take, every column covered
    once; one chunk of all the columns wherever it fits, as at every width
    up to 128 at K up to 128 (the instances there are unchanged)."""
    for width, (chunks, n), smem in (
            (c_out, tfc.wgmma_fwd_chunks(k, c_in, c_out),
             lambda n: tfc.wgmma_fwd_smem(k, c_in, min(n, c_out), n)),
            (c_in, tfc.wgmma_rows_chunks(k, c_in, c_out),
             lambda n: tfc.wgmma_rows_smem(k, c_out, n))):
        assert n % 8 == 0 and 8 <= n <= 128
        assert chunks * n >= width and (chunks - 1) * n < width
        assert smem(n) <= tfc.SMEM_MAX
        if chunks > 1:  # the widest fitting N, evened out
            assert smem(-(-_round_up(width, 8) // (chunks - 1))) > tfc.SMEM_MAX \
                or -(-_round_up(width, 8) // (chunks - 1)) > 128
        if max(k, c_in, c_out) <= 128:
            assert (chunks, n) == (1, _round_up(width, 8))
    assert tfc.wgmma_fwd_chunks(256, 256, 256) == (5, 56)
    assert tfc.wgmma_rows_chunks(256, 256, 256) == (5, 56)
    assert tfc.wgmma_fwd_chunks(256, 128, 128) == (2, 64)
    assert tfc.conv_smem_bytes(torch.bfloat16, 128, 128, 128) == 229_888


def _round_up(v, m):
    return -(-v // m) * m


# (K, c_in, c_out) -> bytes of shared memory per block of the bfloat16 B1,
# B2's rows kernel, the float32 B1 and B2's rows kernel, as the libraries'
# *_smem_bytes queries answered on the card (chip_smoke.py's [ptxas] lines)
CARD_SMEM = {
    (48, 48, 48): (48128, 41984, 93056, 80256),
    (128, 48, 48): (58368, 52224, 113536, 100736),
    (128, 128, 128): (229888, 213504, 197504, 164224),
    (256, 256, 256): (223744, 216576, 180864, 147584),
    (128, 256, 256): (229888, 221696, 180864, 147584),
    (129, 129, 129): (153120, 143904, 123520, 98432),
    (200, 136, 250): (190976, 186752, 144000, 135296),
    (256, 48, 256): (133632, 195072, 172928, 135296),
    (72, 256, 40): (155136, 89600, 150144, 102784)}
KINDS = ((torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, False),
         (torch.float32, True))


@pytest.mark.parametrize("shape", sorted(CARD_SMEM))
def test_shared_memory_mirrors_match_the_card(shape):
    """The wrapper's mirror of each B1/B2 layout (``conv_smem_bytes``) gives
    the bytes the kernels' own layouts ask for on the card."""
    got = tuple(tfc.conv_smem_bytes(dt, *shape, backward=bw)
                for dt, bw in KINDS)
    assert got == CARD_SMEM[shape]


@pytest.mark.parametrize("dt,backward", KINDS)
def test_every_width_up_to_256_fits_a_block(dt, backward):
    """Every K, c_in and c_out of 1..256 (a coarse sweep with the corners)
    leaves each B1/B2 block within the 227 KB of shared memory a block may
    take."""
    widths = sorted({1, 8, 64, 127, 128, 129, 200, 255, 256,
                     *range(3, 257, 23)})
    worst = max(tfc.conv_smem_bytes(dt, k, c_in, c_out, backward)
                for k in widths for c_in in widths for c_out in widths)
    assert worst <= tfc.SMEM_MAX


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


# (bad operand, the wrapper's refusal, one launch's refusal): past 256 the
# wrapper runs pieces, so c_out 257 gets as far as the device check, while
# one launch still refuses it as the kernel does
GEOMETRY_CASES = [
    pytest.param({"c_out": 257}, "needs CUDA tensors", "c_out=257 outside",
                 id="bad0-c_out=257"),
    pytest.param({"c_in": 0}, "c_in=0", "c_in=0", id="bad1-c_in=0"),
    pytest.param({"rows_blk": 16}, "rows_blk=16", "rows_blk=16",
                 id="bad2-rows_blk=16"),
    pytest.param({"blk": 32}, "blk=32", "blk=32", id="bad3-blk=32")]


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("bad,match,launch_match", GEOMETRY_CASES)
def test_wrappers_refuse_geometry_before_launch(which, bad, match,
                                                launch_match):
    """The bfloat16 wrappers refuse what the tensor-core kernels do not take
    (a width of 0, blocks of other than 64 rows, blk not a multiple of 64)
    before they look for a card; a width past 256 (pieces) gets as far as
    the device check, and one launch refuses it."""
    _, fwd, bwd, kw = _small()
    fn, launch, args = (
        (tfc.fused_edge_conv_cuda, tfc._fused_edge_conv_launch, fwd)
        if which == "fwd" else
        (tfc.fused_edge_conv_bwd_cuda, tfc._fused_edge_conv_bwd_launch, bwd))
    with pytest.raises(ValueError, match=match):
        fn(*args, **{**kw, **bad})
    with pytest.raises(ValueError, match=launch_match):
        launch(*args, **{**kw, **bad})


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_wrappers_refuse_k_past_256_and_cpu_tensors(which):
    """One launch refuses K 257 as the kernel does; the wrapper runs it as
    two pieces, so it passes the geometry and, like K 6, stops at the CPU
    tensors."""
    _, fwd, bwd, kw = _small(k=257)
    fn, launch, args = (
        (tfc.fused_edge_conv_cuda, tfc._fused_edge_conv_launch, fwd)
        if which == "fwd" else
        (tfc.fused_edge_conv_bwd_cuda, tfc._fused_edge_conv_bwd_launch, bwd))
    with pytest.raises(ValueError, match="K=257 outside the kernel's 1..256"):
        launch(*args, **kw)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fn(*args, **kw)
    _, fwd, bwd, kw = _small()
    args = fwd if which == "fwd" else bwd
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fn(*args, **kw)


def test_geometry_limits_are_each_kernels_own():
    """B1 and B2 take any K, c_in and c_out (past 256 as pieces), one
    launch up to 256; B3 and B4 take them and ranks up to 256: 257 and
    rank 257 are refused before any launch, naming ROADMAP queue B (c4)."""
    conv = dict(K=256, c_in=256, c_out=256)
    tfc._check_geometry(torch.float32, 128, 64, 64, **conv)
    tfc._check_geometry(torch.float32, 128, 64, 64, **dict(conv, K=257))
    with pytest.raises(ValueError, match="K=257 outside the kernel's 1..256"):
        tfc._check_geometry(torch.float32, 128, 64, 64, tfc._MAX_WIDTH,
                            **dict(conv, K=257))
    low = (tfc._MAX_WIDTH, tfc._LOWRANK_PAST)
    with pytest.raises(ValueError, match=r"c_in=257 outside the kernel's "
                       r"1..256 \(B3/B4 past 256: ROADMAP.md queue B \(c4\)"):
        tfc._check_geometry(torch.bfloat16, 128, 64, 64, *low, K=48,
                            c_in=257, c_out=48, rank=16)
    with pytest.raises(ValueError, match="rank=257 outside the kernel's 1..256"):
        tfc._check_geometry(torch.bfloat16, 128, 64, 64, *low, K=48, c_in=48,
                            c_out=48, rank=257)
    tfc._check_geometry(torch.bfloat16, 128, 64, 64, *low, K=256, c_in=256,
                        c_out=256, rank=256)


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


# ---------------------------------------------------------------------------
# the bfloat16 kernels' loops in numpy (csrc/fused_edge_conv_wgmma.cu,
# csrc/fused_edge_conv_bwd_wgmma.cu): every product of the tensor cores is a
# product of bf16 values, exact, summed in float32; the CUDA cores' sums run
# in float32 in the kernels' order

SMS = 132  # the H100's SMs: conv_parts and weight_splits as on the card
PROMOTE = 32  # the weights kernel's chunks per tensor-core sum (kPromote)


def _bf(a):
    """``a`` rounded to bfloat16, as float32 values."""
    return (torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
            .float().numpy())


def _fma(a, b, c):
    """float32 fmaf(a, b, c), elementwise."""
    return (np.float64(1) * a * b + c).astype(np.float32)


def _mm(a, b):
    """A tensor-core product of bf16 values: exact products, read out of
    the float32 accumulator."""
    return (np.asarray(a, np.float64) @ np.asarray(b, np.float64)).astype(
        np.float32)


def _graph(seed, n, e):
    rng = np.random.default_rng(seed)
    recv = np.sort(rng.integers(0, n, e)).astype(np.int32)
    send = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) > 0.2
    return tfc.build_scatter_blocks(recv, send, n, mask, quantum=64)


def _operands(blocks, c_in, c_out, k, seed):
    """h, x and w3 bf16 values (the GEMM type's), b3 and g float32."""
    rng = np.random.default_rng(seed)
    slots = len(blocks.senders_perm)
    o = dict(h=_bf(np.maximum(rng.normal(size=(slots, k)), 0)),
             x=_bf(rng.normal(size=(blocks.n_nodes, c_in))),
             w3=_bf(rng.normal(size=(k, c_in * c_out)) * 0.2),
             b3=(rng.normal(size=(c_in * c_out,)) * 0.1).astype(np.float32),
             g=rng.normal(size=(blocks.n_pad, c_out)).astype(np.float32))
    o["x_src"] = o["x"][blocks.senders_perm]
    return o


def _tiles(blocks):
    """[tiles, 64] slot indices and whether each tile holds a real slot."""
    idx = np.arange(len(blocks.senders_perm)).reshape(-1, 64)
    return idx, (blocks.compact_s.slot_rows[idx] >= 0).any(1)


def _emulate_fwd(blocks, o, c_in, c_out, compact):
    """B1 bfloat16 as csrc/fused_edge_conv_wgmma.cu runs it: per tile msg =
    X @ B3 channel by channel, then per k msg += h[:, k] (X @ W3_k); the
    scatter adds each slot's message into its row in slot order (or sums
    S's column products in the dense form); the parts are summed in
    order."""
    k = o["h"].shape[1]
    idx, real = _tiles(blocks)
    x = o["x"][blocks.senders_perm[idx]]                 # [T, 64, c_in]
    b3 = o["b3"].reshape(c_in, c_out)
    msg = np.zeros((*idx.shape, c_out), np.float32)
    for i in range(c_in):
        msg = _fma(x[..., i:i + 1], b3[i], msg)
    h = o["h"][idx]
    for kk in range(k):
        msg = _fma(h[..., kk:kk + 1], _mm(x, o["w3"][kk].reshape(c_in, c_out)),
                   msg)
    tiles = blocks.blk // 64
    parts = tfc.conv_parts(blocks.num_blocks, tiles, SMS)
    out = np.zeros((parts, blocks.n_pad, c_out), np.float32)
    srow = blocks.compact_s.slot_rows
    for b in range(blocks.num_blocks):
        for p, (lo, hi) in enumerate(tfc.part_bounds(tiles, parts)):
            acc = np.zeros((64, c_out), np.float32)
            for t in range(b * tiles + lo, b * tiles + hi):
                if compact:
                    if not real[t]:
                        continue
                    for s, r in enumerate(srow[idx[t]]):
                        if r >= 0:
                            acc[r] += msg[t, s]
                else:
                    s_tile = blocks.s_matrix[b * 64:(b + 1) * 64,
                                             (t - b * tiles) * 64:
                                             (t - b * tiles + 1) * 64]
                    acc += _mm(s_tile, msg[t])
            rows = slice(b * 64, (b + 1) * 64)
            out[p, rows] = (blocks.compact_s.row_weight[rows, None] * acc
                            if compact else acc)
    total = out[0]
    for p in range(1, parts):
        total = total + out[p]
    return total


def _dmsg(blocks, g, compact):
    """The rows kernel's dmsg rows, rounded to bf16: row_weight g[slot_rows]
    in CompactS form, S^T g summed in float32 in the dense form."""
    nb, blk = blocks.num_blocks, blocks.blk
    if compact:
        srow = blocks.compact_s.slot_rows
        rows = np.repeat(np.arange(nb), blk) * 64 + np.maximum(srow, 0)
        d = blocks.compact_s.row_weight[rows, None] * g[rows]
        return _bf(np.where(srow[:, None] >= 0, d, 0))
    s = blocks.s_matrix.reshape(nb, 64, blk)
    d = np.zeros((nb, blk, g.shape[1]), np.float32)
    gb = g.reshape(nb, 64, -1)
    for r in range(64):
        d = _fma(s[:, r, :, None], gb[:, r, None, :], d)
    return _bf(d.reshape(nb * blk, -1))


def _emulate_bwd(blocks, o, c_in, c_out, compact):
    """B2 bfloat16 as csrc/fused_edge_conv_bwd_wgmma.cu runs it: (dh,
    dx_src, dw3, db3).  Rows kernel, per chunk of c_in
    (``wgmma_rows_chunks``): dx = D @ b3^T channel by channel, then per k
    R_k = D @ W3_k^T at the chunk's channels, dx += h[:, k] R_k, dh[:, k]
    += sum_i x_src R_k.
    Weights kernel: per split, chunk by chunk, h^T (z_hi + z_lo) into the
    tensor cores' sum, added into the split's partial every 32 chunks; db3
    in slot order."""
    k = o["h"].shape[1]
    slots, c2 = len(blocks.senders_perm), c_in * c_out
    idx, real = _tiles(blocks)
    dmsg = _dmsg(blocks, o["g"], compact)
    d, h, xs = dmsg[idx], o["h"][idx], o["x_src"][idx]
    b3t = o["b3"].reshape(c_in, c_out).T
    dx = np.zeros((*idx.shape, c_in), np.float32)
    dh = np.zeros((*idx.shape, k), np.float32)
    # the rows kernel's chunks of c_in, in turn: each adds its share of
    # dh[:, k] to the earlier chunks' in float32
    chunks, n = tfc.wgmma_rows_chunks(k, c_in, c_out)
    for c in range(chunks):
        ch = slice(c * n, min((c + 1) * n, c_in))
        dxc = dx[..., ch]
        for oo in range(c_out):
            dxc = _fma(d[..., oo:oo + 1], b3t[oo, ch], dxc)
        for kk in range(k):
            r = _mm(d, o["w3"][kk].reshape(c_in, c_out)[ch].T)
            dxc = _fma(h[..., kk:kk + 1], r, dxc)
            share = (xs[..., ch].astype(np.float64) * r).sum(-1)
            dh[..., kk] = (share if c == 0 else dh[..., kk] + share).astype(
                np.float32)
        dx[..., ch] = dxc
    if compact:  # padding-only tiles write zeros
        dx[~real], dh[~real] = 0, 0
    cols, row_tiles = tfc.weight_tiles(k, c_in, c_out)
    splits = tfc.weight_splits(slots, cols * row_tiles, SMS)
    chunks = slots // 64
    per = -(-chunks // splits)
    partial = np.zeros((splits, k + 1, c2), np.float32)
    for sp in range(splits):
        total = np.zeros((k, c2), np.float32)
        acc = np.zeros((k, c2), np.float32)
        pending = 0
        dbias = np.zeros(c2, np.float32)
        for ch in range(sp * per, min((sp + 1) * per, chunks)):
            if compact and not real[ch]:
                continue
            rows = slice(64 * ch, 64 * ch + 64)
            z = (o["x_src"][rows, :, None] * dmsg[rows, None, :]).reshape(64, c2)
            z_hi = _bf(z)
            z_lo = _bf(z - z_hi)
            assert np.array_equal(z_hi.astype(np.float64) + z_lo, z)
            acc = (acc + (o["h"][rows].T.astype(np.float64) @ z_hi
                          + o["h"][rows].T.astype(np.float64) @ z_lo)
                   ).astype(np.float32)
            pending += 1
            if pending == PROMOTE:
                total, acc, pending = total + acc, np.zeros_like(acc), 0
            for s in range(64):
                dbias = dbias + z[s]
        partial[sp, :k], partial[sp, k] = total + acc, dbias
    out = partial[0]
    for sp in range(1, splits):
        out = out + partial[sp]
    return (dh.reshape(slots, k), dx.reshape(slots, c_in), out[:k], out[k])


def _f64_fwd(blocks, o, c_in, c_out):
    h, xs = o["h"].astype(np.float64), o["x_src"].astype(np.float64)
    w = (h @ o["w3"].astype(np.float64) + o["b3"]).reshape(-1, c_in, c_out)
    msg = np.einsum("ei,eio->eo", xs, w)
    nb, blk = blocks.num_blocks, blocks.blk
    s = blocks.s_matrix.astype(np.float64).reshape(nb, 64, blk)
    return np.einsum("brs,bso->bro", s, msg.reshape(nb, blk, c_out)).reshape(
        -1, c_out)


def _f64_bwd(o, dmsg, c_in, c_out):
    """The gradients in float64 from the kernels' rounded operands (h,
    x_src, w3 and dmsg bf16 values)."""
    f = {key: v.astype(np.float64) for key, v in o.items()}
    dmsg = dmsg.astype(np.float64)
    z = (f["x_src"][:, :, None] * dmsg[:, None, :]).reshape(len(dmsg), -1)
    w = (f["h"] @ f["w3"] + f["b3"]).reshape(-1, c_in, c_out)
    return (z @ f["w3"].T, np.einsum("eio,eo->ei", w, dmsg), f["h"].T @ z,
            z.sum(0))


def _cpu_s(blocks, compact):
    return (blocks.compact_s.to("cpu") if compact
            else torch.as_tensor(blocks.s_matrix))


def _rel(a, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(a, np.float64) - ref).max() / np.abs(ref).max()


# (c_in, c_out, K): widths 8 and 48, and past 64 (N = 128 and 104; B2's rows
# kernel N = 128 and 72); past 128, B1 in column chunks of 88 and 56 and
# B2's rows kernel in chunks of c_in of 48 and 56 (``wgmma_fwd_chunks``,
# ``wgmma_rows_chunks``)
BF16_SHAPES = [(8, 8, 8), (48, 48, 33), (128, 128, 8), (72, 100, 4),
               (136, 250, 200), (256, 256, 256)]


def _setup(c_in, c_out, k, seed):
    """The graph and operands for a shape: past width 128 two 64-slot tiles
    (the plain versions build [slots, c_in c_out]), past 64 a small one."""
    if max(c_in, c_out) > 128:
        blocks = _graph(seed, 100, 90)
        assert len(blocks.senders_perm) <= 2 * 64
    else:
        wide = c_in * c_out > 64 * 64
        blocks = _graph(seed, *((70, 300) if wide else (150, 900)))
    return blocks, _operands(blocks, c_in, c_out, k, seed + 1)


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("c_in,c_out,k", BF16_SHAPES)
def test_bf16_fwd_tile_loop_matches_plain_float64_and_pallas(c_in, c_out, k,
                                                            compact):
    """B1 bfloat16's emulated loop against ``fused_edge_conv_plain`` in
    bfloat16 and a float64 reference of the same bf16 operands, within 1e-6
    of the max, and against the JAX package's Pallas kernel in interpret
    mode within 2e-2 (its 'repeat' layout rounds each x W product to bf16:
    tests/test_torch_fused_conv.py's bfloat16 tolerance)."""
    blocks, o = _setup(c_in, c_out, k, seed=c_in + c_out + k)
    got = _emulate_fwd(blocks, o, c_in, c_out, compact)
    t = {key: torch.as_tensor(v) for key, v in o.items()}
    plain = tfc.fused_edge_conv(
        t["h"], t["x"], torch.as_tensor(blocks.senders_perm), t["w3"], t["b3"],
        _cpu_s(blocks, compact), c_in=c_in, c_out=c_out, rows_blk=64,
        blk=blocks.blk, gemm_dtype="bfloat16").numpy()
    ref = _f64_fwd(blocks, o, c_in, c_out)
    pallas = np.asarray(jfc.fused_edge_conv(
        jnp.asarray(o["h"]), jnp.asarray(o["x"]),
        jnp.asarray(blocks.senders_perm), jnp.asarray(o["w3"]),
        jnp.asarray(o["b3"]), jnp.asarray(blocks.s_matrix), c_in=c_in,
        c_out=c_out, rows_blk=64, blk=blocks.blk, gemm_dtype="bfloat16",
        interpret=True))
    assert got.shape == ref.shape == plain.shape == (blocks.n_pad, c_out)
    assert _rel(got, ref) <= 1e-6
    assert _rel(got, plain) <= 1e-6
    assert _rel(got, pallas) <= 2e-2


NAMES = ("dh", "dx_src", "dw3", "db3")


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("c_in,c_out,k", BF16_SHAPES)
def test_bf16_bwd_rows_and_weights_match_plain_float64_and_pallas(
        c_in, c_out, k, compact):
    """B2 bfloat16's emulated rows and weights kernels against
    ``fused_edge_conv_bwd_plain`` in bfloat16 and a float64 reference of
    the same rounded operands, within 1e-6 of each output's max, and
    against the JAX package's Pallas backward in interpret mode within 2e-2
    (JAX's bfloat16 backward also rounds W, its products and g to bf16:
    tests/test_torch_fused_bwd.py's bfloat16 tolerance)."""
    blocks, o = _setup(c_in, c_out, k, seed=c_in + c_out + k + 7)
    got = _emulate_bwd(blocks, o, c_in, c_out, compact)
    t = {key: torch.as_tensor(v) for key, v in o.items()}
    plain = [a.numpy() for a in tfc.fused_edge_conv_bwd(
        t["g"], t["h"], t["x_src"], t["w3"], t["b3"], _cpu_s(blocks, compact),
        c_in=c_in, c_out=c_out, rows_blk=64, blk=blocks.blk,
        gemm_dtype="bfloat16")]
    ref = _f64_bwd(o, _dmsg(blocks, o["g"], compact), c_in, c_out)
    pallas = [np.asarray(a) for a in jfc.fused_edge_conv_bwd(
        jnp.asarray(o["g"]), jnp.asarray(o["h"]), jnp.asarray(o["x_src"]),
        jnp.asarray(o["w3"]), jnp.asarray(o["b3"]),
        jnp.asarray(blocks.s_matrix), c_in=c_in, c_out=c_out, rows_blk=64,
        blk=blocks.blk, gemm_dtype="bfloat16", interpret=True)]
    for name, a, r, p, j in zip(NAMES, got, ref, plain, pallas):
        assert a.shape == r.shape == p.shape == j.shape, name
        assert _rel(a, r) <= 1e-6, (name, _rel(a, r))
        assert _rel(a, p) <= 1e-6, (name, _rel(a, p))
        assert _rel(a, j) <= 2e-2, (name, _rel(a, j))
