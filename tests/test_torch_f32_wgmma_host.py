"""Host-side pieces of the float32 B1 and B2 on the tensor cores
(csrc/fused_edge_conv_f32_wgmma.cu, csrc/fused_edge_conv_bwd_f32_wgmma.cu
and csrc/f32_wgmma.cuh), on the CPU: the design and libraries the wrappers
pick, the column chunks and the index map of the stage-image launch, numpy
emulations of the kernels' loops (B1's tile loop: the gather, the
three-part splits, a pass over k per column chunk with the six products in
the kernel's order, the float32 h-weighting and the segmented scatter into
per-part sums; B2's rows kernel, chunk by chunk of c_in, and its weights
kernel) against the plain versions, a float64 reference and the JAX
package's Pallas kernels in interpret mode, at widths up to 256 (past a
depth of 128 A's parts in shared memory and each W~_k in stages of 32
deep), why z = x_src (x) dmsg needs six products, and the float32 wrappers
refusing what the kernels do not take."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_eng_super_resolution_tpu.ops import fused_conv as jfc
from fast_eng_super_resolution_tpu_torch.ops import fused_conv as tfc
from fast_eng_super_resolution_tpu_torch.ops import pallas_mp

# The (A part, B part) of the six products, smallest first (f32_wgmma.cuh
# a_part / b_part): A3 B1, A2 B2, A1 B3, A2 B1, A1 B2, A1 B1.
ORDER = [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]
SMS = 132  # the H100's SMs: conv_parts and weight_splits as on the card


def kmajor(r, d, depth):
    """wgmma_tile.cuh kmajor: offset of (r, d) in a K-major operand."""
    return (r >> 3) * (depth << 3) + (d >> 3) * 64 + (r & 7) * 8 + (d & 7)


def _round_up(v, m):
    return -(-v // m) * m


def _split(a):
    """The three exact bf16 parts of float32 ``a`` (ops/pallas_mp.py:split3,
    the kernels' split3), as float64."""
    return [p.double().numpy() for p in
            pallas_mp.split3(torch.as_tensor(np.asarray(a, np.float32)))]


def _six(a_parts, b_parts):
    """The six products of the split operands in the kernel's order, each
    exact (products of bf16 values summed in float64), read out of the
    float32 accumulator."""
    p = 0.0
    for ai, bi in ORDER:
        p = p + a_parts[ai] @ b_parts[bi]
    return np.asarray(p, np.float32)


def _fma(a, b, c):
    """float32 fmaf(a, b, c), elementwise."""
    return (np.float64(1) * a * b + c).astype(np.float32)


def _chunks(c_in, c_out, by_out):
    """(chunks, n, depth, stage depth) of the stage image: the product's
    rows (c_out by output, c_in by input) in column chunks (f32_wgmma.cuh
    Chunks, the wrapper's ``f32_chunks``) over its depth padded as
    ``f32_depth`` (to 16; past 128 to 32, in stages of 32)."""
    rows, depth = (c_out, c_in) if by_out else (c_in, c_out)
    return (*tfc.f32_chunks(rows, depth), *tfc.f32_depth(depth))


def _image(w3, b3, c_in, c_out, by_out, stages=None, w=None):
    """What the stage-image launch writes (f32_wgmma.cuh stage_image): its
    index map run in numpy, thread index q by thread index q, for the
    stages ``stages`` (all by default).  [stages, 3, n * sd] bf16 values as
    float32, stage (c (K+1) + k) slices + l slice l of chunk c of W~_k.
    ``w``: W~ = [w3; b3] as [K+1, c_in, c_out], if the caller has it."""
    k = w3.shape[0]
    chunks, rows, depth, sd = _chunks(c_in, c_out, by_out)
    slices = depth // sd
    if stages is None:
        stages = np.arange(chunks * (k + 1) * slices)
    per = rows * sd
    q = (np.asarray(stages)[:, None] * per + np.arange(per)).reshape(-1)
    st, r = q // per, q % per
    ck, sl = st // slices, st % slices
    c, kk = ck // (k + 1), ck % (k + 1)
    if by_out:
        il, ol = r // rows, r % rows
        i, o = sl * sd + il, c * rows + ol
        at = kmajor(ol, il, sd)
    else:
        il, ol = r // sd, r % sd
        i, o = c * rows + il, sl * sd + ol
        at = kmajor(il, ol, sd)
    ok = (o < c_out) & (i < c_in)
    if w is None:
        w = np.concatenate([w3, b3[None]]).reshape(k + 1, c_in, c_out)
    v = np.where(ok, w[kk, np.minimum(i, c_in - 1), np.minimum(o, c_out - 1)],
                 0).astype(np.float32)
    image = np.zeros((len(stages), 3, per), np.float32)
    row = np.repeat(np.arange(len(stages)), per)
    for p, part in enumerate(_split(v)):
        image[row, p, at] = part
    return image


def _operand_parts(image, rows, sd, slices=1):
    """Stages read back through kmajor, as the descriptor reads them: the
    slices of each W~_k side by side in depth, [K+1 (per chunk), 3, rows,
    slices * sd]."""
    r, d = np.meshgrid(np.arange(rows), np.arange(sd), indexing="ij")
    parts = image[:, :, kmajor(r, d, sd)]          # [stages, 3, n, sd]
    parts = parts.reshape(-1, slices, 3, rows, sd)
    return np.concatenate(list(parts.transpose(1, 0, 2, 3, 4)), axis=3)


def _chunk_parts(w3, b3, c_in, c_out, by_out, c, k, w=None):
    """Chunk c of W~_k (k = K: b3) as the kernel's walk reads it, [3, n,
    dp]: its stages of the image, read back through kmajor."""
    chunks, n, dp, sd = _chunks(c_in, c_out, by_out)
    slices = dp // sd
    first = (c * (w3.shape[0] + 1) + k) * slices
    image = _image(w3, b3, c_in, c_out, by_out,
                   np.arange(first, first + slices), w)
    return _operand_parts(image, n, sd, slices)[0]


def _chunk_products(a_parts, o, c_in, c_out, by_out, c):
    """The six products of A's parts [..., 64, dp] with chunk c of every
    W~_k, [K+1, ..., 64, n] float32 (``_six`` for each k at once)."""
    k = o["w3"].shape[0]
    w = np.concatenate([o["w3"], o["b3"][None]]).reshape(k + 1, c_in, c_out)
    wt = np.stack([_chunk_parts(o["w3"], o["b3"], c_in, c_out, by_out, c, kk,
                                w) for kk in range(k + 1)])
    wt = wt.transpose(0, 1, 3, 2)                     # [K+1, 3, dp, n]
    lead = (slice(None),) + (None,) * (a_parts[0].ndim - 2)
    p = 0.0
    for ai, bi in ORDER:
        p = p + a_parts[ai][None] @ wt[:, bi].astype(np.float64)[lead]
    return np.asarray(p, np.float32)


@pytest.mark.parametrize("c_in,c_out,want", [
    (48, 48, (1, 48)), (64, 64, (1, 64)), (48, 128, (2, 64)),
    (40, 72, (2, 40)), (72, 128, (4, 32)), (128, 128, (4, 32)),
    (72, 100, (4, 32)), (128, 64, (2, 32)), (100, 72, (3, 24)),
    (128, 1, (1, 8)), (48, 256, (4, 64)), (72, 200, (7, 32)),
    (256, 256, (4, 64)), (136, 250, (4, 64)), (129, 129, (3, 48)),
    (256, 40, (1, 40)), (200, 72, (2, 40))])
def test_chunks_keep_a_stage_within_24_kb(c_in, c_out, want):
    """B1's column chunks of c_out over c_in (B2's rows kernel: of c_in over
    c_out, the same rule): one chunk up to 64 columns, else chunks of at
    most 64, or of 32 at a depth of 65..128; past a depth of 128 chunks of
    at most 64 in stages of 32 deep.  A stage's three parts stay within 24
    KB, and the chunks cover every column once."""
    chunks, n = tfc.f32_chunks(c_out, c_in)
    assert (chunks, n) == want
    assert n % 8 == 0 and chunks * n >= c_out and (chunks - 1) * n < c_out
    dp, sd = tfc.f32_depth(c_in)
    assert dp >= c_in and dp % sd == 0
    assert 3 * 2 * n * sd <= 24 * 1024


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("c_in,c_out", [(136, 24), (24, 136), (160, 72),
                                        (200, 9)])
def test_stage_image_in_slices_past_a_depth_of_128(k, c_in, c_out):
    """Past a depth of 128 (c_in for B1, c_out for B2) each chunk of W~_k is
    dp / 32 stages of 32 deep.  Read back slice by slice through kmajor,
    the parts sum to w3 and b3 exactly in both layouts, zeros past the
    widths, and image_numel sizes the scratch."""
    rng = np.random.default_rng(k + c_in + c_out)
    w3 = rng.normal(size=(k, c_in * c_out)).astype(np.float32)
    b3 = rng.normal(size=(c_in * c_out,)).astype(np.float32)
    want = np.concatenate([w3, b3[None]]).reshape(k + 1, c_in, c_out)
    for by_out, rows, depth, ref in ((True, c_out, c_in,
                                      want.transpose(0, 2, 1)),
                                     (False, c_in, c_out, want)):
        if depth <= 128:
            continue
        image = _image(w3, b3, c_in, c_out, by_out)
        assert image.size == tfc.image_numel(k, rows, depth)
        chunks, n, dp, sd = _chunks(c_in, c_out, by_out)
        assert sd == 32 and dp == _round_up(depth, 32)
        parts = _operand_parts(image, n, sd, dp // sd)  # [chunks (K+1), ...]
        parts = np.concatenate([parts[c * (k + 1):(c + 1) * (k + 1)]
                                for c in range(chunks)], axis=2)
        assert not parts[:, :, rows:].any() and not parts[:, :, :, depth:].any()
        assert np.array_equal(parts.sum(1)[:, :rows, :depth],
                              ref.astype(np.float64))
        # one chunk's stages alone, as the walk reads them
        c = chunks - 1
        one = _chunk_parts(w3, b3, c_in, c_out, by_out, c, k)
        assert np.array_equal(one, parts[k, :, c * n:(c + 1) * n])


def _side_by_side(parts, chunks):
    """[chunks (K+1), 3, n, d] stages as [K+1, 3, chunks n, d]: the column
    chunks of each W~_k side by side."""
    st = parts.shape[0] // chunks
    return np.concatenate([parts[c * st:(c + 1) * st] for c in range(chunks)],
                          axis=2)


@pytest.mark.parametrize("k", [1, 8, 33, 128])
@pytest.mark.parametrize("c_in,c_out", [(1, 1), (5, 7), (48, 48), (64, 64),
                                        (24, 5), (6, 20), (128, 128),
                                        (72, 100), (40, 72)])
def test_stage_image_launch_writes_both_layouts(k, c_in, c_out):
    """By output (B1): bit for bit B5's stage image (ops/pallas_mp.py:
    stage_image), rows o and depth i, where one chunk holds c_out.  By
    input (B2): the same of W~_k^T, rows i and depth o.  Read back through
    kmajor, chunk by chunk, the parts sum to w3 and b3 exactly in both
    layouts, and image_numel sizes the scratch."""
    rng = np.random.default_rng(k + c_in + c_out)
    w3 = rng.normal(size=(k, c_in * c_out)).astype(np.float32)
    b3 = rng.normal(size=(c_in * c_out,)).astype(np.float32)
    want = np.concatenate([w3, b3[None]]).reshape(k + 1, c_in, c_out)
    fwd = _image(w3, b3, c_in, c_out, by_out=True)
    assert fwd.size == tfc.image_numel(k, c_out, c_in)
    chunks, n, dp, _ = _chunks(c_in, c_out, True)
    if chunks == 1:
        ref = pallas_mp.stage_image(torch.as_tensor(w3), torch.as_tensor(b3),
                                    c_in)
        assert np.array_equal(fwd.reshape(-1), ref.double().numpy().reshape(-1))
    parts = _side_by_side(_operand_parts(fwd, n, dp), chunks)  # [K+1, 3, o, i]
    assert not parts[:, :, c_out:].any() and not parts[:, :, :, c_in:].any()
    assert np.array_equal(parts.sum(1)[:, :c_out, :c_in],
                          want.transpose(0, 2, 1).astype(np.float64))
    bwd = _image(w3, b3, c_in, c_out, by_out=False)
    assert bwd.size == tfc.image_numel(k, c_in, c_out)
    chunks, n, dq, _ = _chunks(c_in, c_out, False)
    parts = _side_by_side(_operand_parts(bwd, n, dq), chunks)  # [K+1, 3, i, o]
    assert not parts[:, :, c_in:].any() and not parts[:, :, :, c_out:].any()
    assert np.array_equal(parts.sum(1)[:, :c_in, :c_out], want.astype(np.float64))


def test_design_and_libraries():
    """B1 and B2 run on the tensor cores in both types, each type from its
    own library; B3 and B4 too at every rank, a rank that is not a multiple
    of 8 at its padded rank (tests/test_torch_lowrank_f32_wgmma_host.py)."""
    assert tfc.design(torch.float32) == "wgmma"
    assert tfc.design(torch.bfloat16) == "wgmma"
    assert tfc.design(torch.float32, 16) == "wgmma"
    assert tfc.design(torch.float32, 12) == "wgmma"
    assert tfc.design(torch.bfloat16, 12) == "wgmma"
    libs = {tfc._conv_library(dt, backward=bwd)
            for dt in (torch.float32, torch.bfloat16) for bwd in (False, True)}
    assert libs == {"fused_edge_conv_f32_wgmma", "fused_edge_conv_wgmma",
                    "fused_edge_conv_bwd_f32_wgmma", "fused_edge_conv_bwd_wgmma"}
    assert libs <= set(tfc._SOURCES) and libs <= set(tfc._BINDINGS)
    # the FMA instances of B1 and B2 are gone
    assert "fused_edge_conv" not in tfc._SOURCES
    assert "fused_edge_conv_bwd" not in tfc._SOURCES


# ---------------------------------------------------------------------------
# the kernels' loops in numpy


def _graph(kind, seed, n=150, e=900):
    """A random (or skewed) receiver-sorted graph's scatter blocks; a smaller
    one for the wide shapes, whose plain versions build [slots, c_in c_out]
    arrays."""
    rng = np.random.default_rng(seed)
    if kind == "skewed":  # a crowded first block: blocks with padding tiles
        recv = np.concatenate([rng.integers(0, 64, 500),
                               rng.integers(128, n, 150)])
        mask = None
    else:
        recv = rng.integers(0, n, e)
        mask = rng.random(e) > 0.2
    recv = np.sort(recv).astype(np.int32)
    send = rng.integers(0, n, recv.size).astype(np.int32)
    return tfc.build_scatter_blocks(recv, send, n, mask, quantum=64)


def _operands(blocks, c_in, c_out, k, seed):
    rng = np.random.default_rng(seed)
    slots = len(blocks.senders_perm)
    o = dict(h=np.maximum(rng.normal(size=(slots, k)), 0),
             x=rng.normal(size=(blocks.n_nodes, c_in)),
             w3=rng.normal(size=(k, c_in * c_out)) * 0.2,
             b3=rng.normal(size=(c_in * c_out,)) * 0.1,
             g=rng.normal(size=(blocks.n_pad, c_out)))
    o = {key: v.astype(np.float32) for key, v in o.items()}
    o["x_src"] = o["x"][blocks.senders_perm]
    return o


def _tiles(blocks):
    """[tiles, 64] slot indices and whether each tile holds a real slot."""
    idx = np.arange(len(blocks.senders_perm)).reshape(-1, 64)
    return idx, (blocks.compact_s.slot_rows[idx] >= 0).any(1)


def _emulate_fwd(blocks, o, c_in, c_out, compact):
    """B1 float32 as csrc/fused_edge_conv_f32_wgmma.cu runs it: per tile a
    pass over the K+1 stages for each column chunk of c_out (past 128, each
    chunk a block of its own: the same sums), X's parts reused; each W~_k
    read from its stages of the image (past a c_in of 128, its slices of 32
    deep side by side)."""
    k = o["h"].shape[1]
    chunks, n, dp, _ = _chunks(c_in, c_out, True)
    idx, real = _tiles(blocks)
    # the gather: X = x[senders_perm] per tile, padded to dp columns
    x = np.zeros((*idx.shape, dp), np.float32)
    x[..., :c_in] = o["x"][blocks.senders_perm[idx]]
    xp = _split(x)
    hs = np.concatenate([o["h"][idx], np.ones((*idx.shape, 1), np.float32)], 2)
    msg = np.zeros((*idx.shape, chunks * n), np.float32)
    for c in range(chunks):
        cols = slice(c * n, (c + 1) * n)
        p = _chunk_products(xp, o, c_in, c_out, True, c)
        for kk in range(k + 1):
            msg[..., cols] = _fma(hs[..., kk:kk + 1], p[kk], msg[..., cols])
    msg = msg[..., :c_out]
    # the part walk and the scatter
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
                    cur, run = -1, np.zeros(c_out, np.float32)
                    for s, r in enumerate(srow[idx[t]]):
                        if r != cur:
                            if cur >= 0:
                                acc[cur] += run
                            cur, run = r, np.zeros(c_out, np.float32)
                        if r >= 0:
                            run += msg[t, s]
                    if cur >= 0:
                        acc[cur] += run
                else:
                    s_tile = blocks.s_matrix[b * 64:(b + 1) * 64,
                                             (t - b * tiles) * 64:
                                             (t - b * tiles + 1) * 64]
                    acc += (s_tile.astype(np.float64) @ msg[t]).astype(np.float32)
            rows = slice(b * 64, (b + 1) * 64)
            out[p, rows] = (blocks.compact_s.row_weight[rows, None] * acc
                            if compact else acc)
    total = out[0]
    for p in range(1, parts):
        total = total + out[p]
    return total


def _plain_fwd(blocks, o, c_in, c_out, compact):
    t = {key: torch.as_tensor(v) for key, v in o.items()}
    s = blocks.compact_s.to("cpu") if compact else torch.as_tensor(blocks.s_matrix)
    return tfc.fused_edge_conv(t["h"], t["x"], torch.as_tensor(blocks.senders_perm),
                               t["w3"], t["b3"], s, c_in=c_in, c_out=c_out,
                               rows_blk=64, blk=blocks.blk,
                               gemm_dtype="float32").numpy()


def _f64_fwd(blocks, o, c_in, c_out):
    h, xs = o["h"].astype(np.float64), o["x_src"].astype(np.float64)
    w = (h @ o["w3"].astype(np.float64) + o["b3"]).reshape(-1, c_in, c_out)
    msg = np.einsum("ei,eio->eo", xs, w)
    nb, blk = blocks.num_blocks, blocks.blk
    s = blocks.s_matrix.astype(np.float64).reshape(nb, 64, blk)
    return np.einsum("brs,bso->bro", s, msg.reshape(nb, blk, c_out)).reshape(-1, c_out)


def _jax_fwd(blocks, o, c_in, c_out):
    return np.asarray(jfc.fused_edge_conv(
        jnp.asarray(o["h"]), jnp.asarray(o["x"]), jnp.asarray(blocks.senders_perm),
        jnp.asarray(o["w3"]), jnp.asarray(o["b3"]), jnp.asarray(blocks.s_matrix),
        c_in=c_in, c_out=c_out, rows_blk=64, blk=blocks.blk,
        gemm_dtype="float32", interpret=True))


def _rel(a, ref):
    return np.abs(np.asarray(a, np.float64) - ref).max() / np.abs(ref).max()


# (c_in, c_out, K): widths up to 64 in one chunk; past 64, chunks of 32
# over a depth past 64 (128 x 128, 72 x 100) and of 40 over one within it;
# past 128, a block per chunk of 64, over depths past 128 in stages of 32
# (136 x 250: B2's rows kernel over a depth of 250; 256 x 256 at K 256)
SHAPES = [(8, 8, 8), (16, 16, 33), (48, 48, 33), (6, 20, 8), (128, 128, 8),
          (72, 100, 4), (40, 72, 4), (136, 250, 200), (256, 256, 256)]


def _graph_for(c_in, c_out, seed):
    """The graph for a shape: past width 128 two 64-slot tiles (the plain
    versions build [slots, c_in c_out] and the emulation walks K+1 stages
    per chunk), past 64 a small one."""
    if max(c_in, c_out) > 128:
        blocks = _graph("random", seed, 100, 90)
        assert len(blocks.senders_perm) <= 2 * 64
        return blocks
    wide = c_in * c_out > 64 * 64
    return _graph("random", seed, *((70, 300) if wide else ()))


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("c_in,c_out,k", SHAPES)
def test_fwd_tile_loop_matches_plain_float64_and_pallas(c_in, c_out, k, compact):
    """B1's emulated loop against ``fused_edge_conv_plain`` (float32) and a
    float64 reference, within 1e-6 of the max (float32's own error), and
    against the JAX package's Pallas kernel in interpret mode (float32 at
    Precision.HIGHEST), within 1e-5 of the max."""
    blocks = _graph_for(c_in, c_out, seed=c_in + k)
    o = _operands(blocks, c_in, c_out, k, seed=c_out + 3 * k)
    got = _emulate_fwd(blocks, o, c_in, c_out, compact)
    ref = _f64_fwd(blocks, o, c_in, c_out)
    assert got.shape == ref.shape == (blocks.n_pad, c_out)
    assert _rel(got, ref) <= 1e-6
    assert _rel(got, _plain_fwd(blocks, o, c_in, c_out, compact)) <= 1e-6
    assert _rel(got, _jax_fwd(blocks, o, c_in, c_out)) <= 1e-5


@pytest.mark.parametrize("compact", [True, False])
def test_fwd_tile_loop_with_padding_tiles(compact):
    """Receiver blocks with tiles of padding only (skipped in CompactS
    form, by producer and consumers alike) and one without any edge."""
    blocks = _graph("skewed", seed=40)
    _, real = _tiles(blocks)
    assert (~real).sum() >= blocks.blk // 64
    o = _operands(blocks, 16, 16, 8, seed=41)
    got = _emulate_fwd(blocks, o, 16, 16, compact)
    assert _rel(got, _f64_fwd(blocks, o, 16, 16)) <= 1e-6


# B2: the rows kernel and the weights kernel


def _dmsg(blocks, g, compact):
    """The rows kernel's dmsg tile rows, float32: row_weight g[slot_rows]
    in CompactS form, S^T g summed by FMAs in the dense form."""
    nb, blk = blocks.num_blocks, blocks.blk
    if compact:
        srow = blocks.compact_s.slot_rows
        rows = np.repeat(np.arange(nb), blk) * 64 + np.maximum(srow, 0)
        d = blocks.compact_s.row_weight[rows, None] * g[rows]
        return np.where(srow[:, None] >= 0, d, 0).astype(np.float32)
    s = blocks.s_matrix.reshape(nb, 64, blk)
    d = np.zeros((nb, blk, g.shape[1]), np.float32)
    gb = g.reshape(nb, 64, -1)
    for r in range(64):
        d = _fma(s[:, r, :, None], gb[:, r, None, :], d)
    return d.reshape(nb * blk, -1)


def _emulate_bwd(blocks, o, c_in, c_out, compact, sms=SMS):
    """B2 float32 as csrc/fused_edge_conv_bwd_f32_wgmma.cu runs it: (dh,
    dx_src, dw3, db3).  The rows kernel walks the K+1 stages once per column
    chunk of c_in (each W~_k from its stages of the image: past a c_out of
    128 its slices of 32 deep side by side); each chunk's share of dh[:, k]
    is added to the earlier chunks' in float32."""
    k = o["h"].shape[1]
    slots, c2 = len(blocks.senders_perm), c_in * c_out
    chunks, n, dq, _ = _chunks(c_in, c_out, False)
    idx, real = _tiles(blocks)
    dmsg = _dmsg(blocks, o["g"], compact)
    # (a) rows: R_k = D @ W~_k^T, dx += h~ R_k, dh[:, k] = sum_i x_src R_k
    d = np.zeros((*idx.shape, dq), np.float32)
    d[..., :c_out] = dmsg[idx]
    dp = _split(d)
    hs = np.concatenate([o["h"][idx], np.ones((*idx.shape, 1), np.float32)], 2)
    xs = np.zeros((*idx.shape, chunks * n), np.float32)
    xs[..., :c_in] = o["x_src"][idx]
    dx = np.zeros((*idx.shape, chunks * n), np.float32)
    dh = np.zeros((*idx.shape, k), np.float32)
    for c in range(chunks):
        cols = slice(c * n, (c + 1) * n)
        rs = _chunk_products(dp, o, c_in, c_out, False, c)
        for kk in range(k + 1):
            r = rs[kk]
            dx[..., cols] = _fma(hs[..., kk:kk + 1], r, dx[..., cols])
            if kk < k:
                share = (xs[..., cols].astype(np.float64) * r).sum(-1)
                dh[..., kk] = (dh[..., kk] + share).astype(np.float32)
    if compact:  # padding-only tiles write zeros
        dx[~real], dh[~real] = 0, 0
    dh, dx = dh.reshape(slots, k), dx.reshape(slots, -1)[:, :c_in]
    # (b) weights: per split, chunk by chunk, six passes of h^T z into a
    # fresh accumulator added into the float32 sum; db3 in slot order
    cols, row_tiles = tfc.weight_tiles(k, c_in, c_out)
    splits = tfc.weight_splits(slots, cols * row_tiles, sms)
    chunks = slots // 64
    per = -(-chunks // splits)
    partial = np.zeros((splits, k + 1, c2), np.float32)
    for sp in range(splits):
        total = np.zeros((k, c2), np.float32)
        dbias = np.zeros(c2, np.float32)
        for ch in range(sp * per, min((sp + 1) * per, chunks)):
            if compact and not real[ch]:
                continue
            rows = slice(64 * ch, 64 * ch + 64)
            z = (o["x_src"][rows, :, None] * dmsg[rows, None, :]).reshape(64, c2)
            total = total + _six([p.T for p in _split(o["h"][rows])], _split(z))
            for s in range(64):
                dbias = dbias + z[s]
        partial[sp, :k], partial[sp, k] = total, dbias
    out = partial[0]
    for sp in range(1, splits):
        out = out + partial[sp]
    return dh, dx, out[:k], out[k]


def _plain_bwd(blocks, o, c_in, c_out, compact):
    t = {key: torch.as_tensor(v) for key, v in o.items()}
    s = blocks.compact_s.to("cpu") if compact else torch.as_tensor(blocks.s_matrix)
    return [a.numpy() for a in tfc.fused_edge_conv_bwd(
        t["g"], t["h"], t["x_src"], t["w3"], t["b3"], s, c_in=c_in,
        c_out=c_out, rows_blk=64, blk=blocks.blk, gemm_dtype="float32")]


def _f64_bwd(blocks, o, c_in, c_out):
    nb, blk = blocks.num_blocks, blocks.blk
    f = {key: v.astype(np.float64) for key, v in o.items()}
    s = blocks.s_matrix.astype(np.float64).reshape(nb, 64, blk)
    dmsg = np.einsum("brs,bro->bso", s, f["g"].reshape(nb, 64, -1)).reshape(
        nb * blk, -1)
    z = (f["x_src"][:, :, None] * dmsg[:, None, :]).reshape(len(dmsg), -1)
    w = (f["h"] @ f["w3"] + f["b3"]).reshape(-1, c_in, c_out)
    return (z @ f["w3"].T, np.einsum("eio,eo->ei", w, dmsg), f["h"].T @ z,
            z.sum(0))


def _jax_bwd(blocks, o, c_in, c_out):
    return [np.asarray(a) for a in jfc.fused_edge_conv_bwd(
        jnp.asarray(o["g"]), jnp.asarray(o["h"]), jnp.asarray(o["x_src"]),
        jnp.asarray(o["w3"]), jnp.asarray(o["b3"]), jnp.asarray(blocks.s_matrix),
        c_in=c_in, c_out=c_out, rows_blk=64, blk=blocks.blk,
        gemm_dtype="float32", interpret=True)]


NAMES = ("dh", "dx_src", "dw3", "db3")


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("c_in,c_out,k", SHAPES)
def test_bwd_rows_and_weights_match_plain_float64_and_pallas(c_in, c_out, k,
                                                            compact):
    """B2's emulated rows and weights kernels against
    ``fused_edge_conv_bwd_plain`` and a float64 reference, within 1e-6 of
    each output's max, and against the JAX package's Pallas backward in
    interpret mode, within 1e-5."""
    blocks = _graph_for(c_in, c_out, seed=c_in + k + 1)
    o = _operands(blocks, c_in, c_out, k, seed=c_out + 3 * k + 1)
    got = _emulate_bwd(blocks, o, c_in, c_out, compact)
    plain = _plain_bwd(blocks, o, c_in, c_out, compact)
    jax_ = _jax_bwd(blocks, o, c_in, c_out)
    for name, a, ref, p, j in zip(NAMES, got, _f64_bwd(blocks, o, c_in, c_out),
                                  plain, jax_):
        assert a.shape == ref.shape == p.shape == j.shape, name
        assert _rel(a, ref) <= 1e-6, (name, _rel(a, ref))
        assert _rel(a, p) <= 1e-6, (name, _rel(a, p))
        assert _rel(a, j) <= 1e-5, (name, _rel(a, j))


@pytest.mark.parametrize("sms", [SMS, 2])
def test_bwd_with_padding_tiles_and_few_splits(sms):
    """Padding-only tiles (zeros from the rows kernel, skipped chunks in the
    weights kernel) at the card's split count and at a few long splits."""
    blocks = _graph("skewed", seed=42)
    o = _operands(blocks, 16, 16, 8, seed=43)
    got = _emulate_bwd(blocks, o, 16, 16, True, sms=sms)
    for name, a, ref in zip(NAMES, got, _f64_bwd(blocks, o, 16, 16)):
        assert _rel(a, ref) <= 1e-6, (name, _rel(a, ref))


def test_three_products_would_not_be_float32_exact_for_z():
    """Why six passes in the weights kernel: z = x_src (x) dmsg is a float32
    product with a full 24-bit significand, so h^T z from the three products
    of order >= 2^-8 (h1 z1, h1 z2, h2 z1) errs well past float32's own
    error, while the six of order >= 2^-16 stay at its level (against
    float64).  The bfloat16 instance's two passes were exact only because
    its z was a product of two bf16 values."""
    rng = np.random.default_rng(7)
    h = np.maximum(rng.normal(size=(256, 48)), 0).astype(np.float32)
    xs = rng.normal(size=(256, 16)).astype(np.float32)
    dm = rng.normal(size=(256, 16)).astype(np.float32)
    z = (xs[:, :, None] * dm[:, None, :]).reshape(256, -1)
    hp, zp = [p.T for p in _split(h)], _split(z)
    ref = h.T.astype(np.float64) @ z.astype(np.float64)
    top = np.abs(ref).max()
    err = {"six": np.abs(_six(hp, zp) - ref).max() / top,
           "three": np.abs(sum(hp[a] @ zp[b] for a, b in [(1, 0), (0, 1), (0, 0)])
                           - ref).max() / top,
           "f32": np.abs((h.T @ z).astype(np.float64) - ref).max() / top}
    assert err["six"] <= 2 * err["f32"] + 1e-7
    assert err["three"] > 5 * err["f32"]
    # z's low part carries bits: a two-part split would not be exact
    z1, z2, z3 = _split(z)
    assert (z3 != 0).mean() > 0.5
    assert not np.array_equal(z1 + z2, z.astype(np.float64))


# ---------------------------------------------------------------------------
# the float32 wrappers refuse what the kernels do not take, before any launch


def _small(k=6, c=8):
    blocks = _graph("random", seed=3)
    o = _operands(blocks, c, c, k, seed=4)
    t = {key: torch.as_tensor(v) for key, v in o.items()}
    fwd = (t["h"], t["x"], torch.as_tensor(blocks.senders_perm), t["w3"],
           t["b3"], blocks.compact_s.to("cpu"))
    bwd = (t["g"], t["h"], t["x_src"], t["w3"], t["b3"],
           blocks.compact_s.to("cpu"))
    return fwd, bwd, dict(c_in=c, c_out=c, rows_blk=64, blk=blocks.blk)


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
def test_f32_wrappers_refuse_geometry_before_launch(which, bad, match,
                                                    launch_match):
    fwd, bwd, kw = _small()
    assert fwd[0].dtype == torch.float32
    fn, launch, args = (
        (tfc.fused_edge_conv_cuda, tfc._fused_edge_conv_launch, fwd)
        if which == "fwd" else
        (tfc.fused_edge_conv_bwd_cuda, tfc._fused_edge_conv_bwd_launch, bwd))
    with pytest.raises(ValueError, match=match):
        fn(*args, **{**kw, **bad})
    with pytest.raises(ValueError, match=launch_match):
        launch(*args, **{**kw, **bad})


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_f32_wrappers_refuse_k_past_256_cpu_tensors_and_float64(which):
    fn = tfc.fused_edge_conv_cuda if which == "fwd" else tfc.fused_edge_conv_bwd_cuda
    pick = (lambda f, b: f) if which == "fwd" else (lambda f, b: b)
    launch = (tfc._fused_edge_conv_launch if which == "fwd"
              else tfc._fused_edge_conv_bwd_launch)
    # one launch refuses K 257 as the kernel does; the wrapper runs it as
    # two pieces: past the geometry, it stops at the CPU tensors
    fwd, bwd, kw = _small(k=257)
    with pytest.raises(ValueError, match="K=257 outside the kernel's 1..256"):
        launch(*pick(fwd, bwd), **kw)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fn(*pick(fwd, bwd), **kw)
    fwd, bwd, kw = _small()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fn(*pick(fwd, bwd), **kw)
    args = list(pick(fwd, bwd))
    at = 0 if which == "fwd" else 1  # h_blocked
    args[at] = args[at].double()
    with pytest.raises(TypeError, match="float64"):
        fn(*args, **kw)
