"""Host-side pieces of the float32 B3 and B4 on the tensor cores
(csrc/fused_edge_conv_lowrank_f32_wgmma.cu,
csrc/fused_edge_conv_lowrank_bwd_f32_wgmma.cu and csrc/lowrank_f32_wgmma.cuh),
on the CPU: the design and libraries the wrappers pick, the index map of the
stage-image launch in its three readings (kUv, kP, kQ) over the head padded
to 8 ceil(r / 8) (zeros at q >= r, b3 padded after the stages; past a
depth of 64 each chunk in stages of 32; past rank 64 slab by slab), the
sizes and the slab map the wrappers derive from it at every rank 1-256,
numpy emulations of
the kernels' walks (B3: h split once per tile, the six products of each
chunk in the kernel's order, + b3, t and msg in float32, the segmented
scatter into per-part sums; B4's rows kernel over the V, U, P and Q chunks
and its weights kernel) against the plain versions, a float64 reference and
the JAX package's Pallas kernels in interpret mode, why dmsg and duv need
all three parts, tiles of padding only, and the float32 rank-r wrappers
refusing what the kernels do not take."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_eng_super_resolution_tpu.ops import fused_conv as jfc
from fast_eng_super_resolution_tpu_torch.ops import fused_conv as tfc
from test_torch_f32_wgmma_host import (SMS, _dmsg, _fma, _graph, _rel, _six,
                                       _split, _tiles, kmajor)

RANKS = [8, 16, 24, 32]
PADDED_RANKS = [1, 3, 5, 12, 20, 27, 31]  # run at 8 ceil(r / 8)
WIDE_RANKS = [33, 40, 48, 57, 64]  # one padded channel per chunk


def _stage_depth(dp):
    """lowrank_f32_wgmma.cuh stage_depth: a chunk's stage holds all of its
    depth up to 64, else 32 of it."""
    return dp if dp <= 64 else 32


def _round_up(v, m):
    return -(-v // m) * m


def _real_col(c, rp, r):
    """lowrank_wgmma.cuh real_col: the model's column of padded column c
    (channel c // rp, q = c % rp), -1 at q >= r."""
    ch, q = c // rp, c % rp
    return np.where(q < r, ch * r + q, -1)


def _slab_col(c, s, r, rp):
    """lowrank_wgmma.cuh slab_col: the padded head's column of column c of
    slab s's head at rank r (channel c // r, q = r s + c % r)."""
    return c // r * rp + s * r + c % r


def _slabs(rank):
    """(rp, R, slabs): the padded rank, a slab's rank (rp up to 64) and the
    slabs walked in turn."""
    return (tfc.padded_rank(rank), tfc.lowrank_slab_rank(rank),
            tfc.lowrank_slabs(rank))


def _chunks(k, c_in, c_out, rank, backward):
    """(reading, first column, columns, slab) of each stage, as
    lowrank_f32_wgmma.cuh's fwd_chunk / bwd_chunk lay them out over each
    slab's head of rank R (the head padded to rp = 8 ceil(rank / 8) up to
    64, itself the one slab): G = N // R whole channels (or k) per chunk;
    the forward's U then V chunks of uv, the rows kernel's V, U, P and Q
    chunks, slab after slab."""
    _, r, slabs = _slabs(rank)
    g = tfc.lowrank_chunk_cols(rank) // r

    def groups(reading, n, base, s):
        return [(reading, base + c0 * r, min(g, n - c0) * r, s)
                for c0 in range(0, n, g)]

    out = []
    for s in range(slabs):
        u = groups("uv", c_in, 0, s)
        v = groups("uv", c_out, r * c_in, s)
        out += (u + v if not backward else
                v + u + groups("p", k, 0, s) + groups("q", k, 0, s))
    return out


def _chunk_stages(w3, k, c_in, c_out, rank, backward):
    """What the stage-image launch writes for each chunk, in walk order
    (lowrank_f32_wgmma.cuh lowrank_image): its index map run in numpy over
    the chunk's thread indices, the padded columns (q >= rank) read as
    zeros; the chunk's depth rows l sd .. in its stage l (sd =
    _stage_depth(dp)).  Yields [dp / sd, 3, N * sd] bf16 values as float32
    per chunk, so that a wide head's image is never whole in memory."""
    rp, r, _ = _slabs(rank)
    n = tfc.lowrank_chunk_cols(rank)
    dp = tfc.lowrank_image_depth(max(k, c_in, c_out) if backward else k)
    sd = _stage_depth(dp)
    slices = dp // sd
    per = n * sd
    e = np.arange(slices * per)
    sl, row, dl = e // per, e % per % n, e % per // n
    d = sl * sd + dl
    at_k = kmajor(row, dl, sd)
    ncol = w3.shape[1]
    flat = w3.reshape(-1)
    for reading, lo, cw, slab in _chunks(k, c_in, c_out, rank, backward):
        depth = {"uv": k, "p": c_in, "q": c_out}[reading]
        col = lo + row
        kk, qq = col // r, col % r + slab * r
        ok = (row < cw) & (d < depth) & (qq < rank)
        if reading == "uv":
            at = d * ncol + _real_col(_slab_col(col, slab, r, rp), rp, rank)
        else:
            at = (kk * ncol + (rank * c_in if reading == "q" else 0)
                  + d * rank + qq)
        v = np.where(ok, flat[np.where(ok, at, 0)], 0).astype(np.float32)
        block = np.zeros((slices, 3, per), np.float32)
        for p, part in enumerate(_split(v)):
            block[sl, p, at_k] = part
        yield block


def _b3_padded(b3, c_in, c_out, rank):
    """b3 as the image holds it after the stages: padded to rp, zeros at
    q >= rank, slab by slab ([R (c_in + c_out)] each)."""
    rp, r, _ = _slabs(rank)
    e = np.arange(rp * (c_in + c_out))
    sl = e // (r * (c_in + c_out))
    rcb = _real_col(_slab_col(e - sl * r * (c_in + c_out), sl, r, rp), rp,
                    rank)
    return np.where(rcb >= 0, b3[np.maximum(rcb, 0)], 0).astype(np.float32)


def _image(w3, b3, k, c_in, c_out, rank, backward):
    """The whole stage image: each chunk's stages (``_chunk_stages``) in
    turn, [stages, 3, N * sd], and the padded b3 written after them."""
    image = np.concatenate(list(_chunk_stages(w3, k, c_in, c_out, rank,
                                              backward)))
    return image, _b3_padded(b3, c_in, c_out, rank)


def _zero_padded(w3, rank):
    """w3 [K, rank * nch] as the head of rank 8 ceil(rank / 8) with zero
    columns at q >= rank, built by reshaping (independent of the index
    maps above)."""
    k, ncol = w3.shape
    rp, nch = tfc.padded_rank(rank), ncol // rank
    w = np.zeros((k, nch, rp), w3.dtype)
    w[:, :, :rank] = w3.reshape(k, nch, rank)
    return w.reshape(k, nch * rp)


def _stages(image, n, dp):
    """The image read back through kmajor, as the descriptor reads each
    stage, a chunk's stages side by side in depth: [chunks, 3, N, dp]."""
    sd = _stage_depth(dp)
    r, d = np.meshgrid(np.arange(n), np.arange(sd), indexing="ij")
    st = image[:, :, kmajor(r, d, sd)]  # [stages, 3, N, sd]
    st = st.reshape(-1, dp // sd, 3, n, sd).transpose(0, 2, 3, 1, 4)
    return st.reshape(-1, 3, n, dp)


@pytest.mark.parametrize("k,c_in,c_out,rank", [
    (*shape, r) for r in RANKS + PADDED_RANKS
    for shape in [(48, 48, 48), (5, 7, 3), (64, 64, 64), (17, 33, 20)]] + [
    (*shape, r) for r in WIDE_RANKS + [8, 27]
    for shape in [(128, 128, 128), (100, 72, 33), (48, 48, 48), (20, 5, 80)]
    if shape != (48, 48, 48) or r in WIDE_RANKS] + [
    (256, 48, 48, 16), (48, 256, 256, 16), (64, 256, 48, 24),
    (200, 136, 250, 33), (72, 40, 256, 40)])
def test_stage_image_in_all_three_readings(k, c_in, c_out, rank):
    """Read back through kmajor, the parts of each stage sum exactly to its
    chunk of the head padded to rp = 8 ceil(r / 8) (w3p, zero columns at q
    >= r) in its reading, zeros elsewhere: the kUv stages of the forward
    (and of B4's rows kernel, V first) concatenate to w3p^T, the kP stages
    to W3U^T and the kQ stages to W3V^T, with W3U[i, k rp + q] = w3p[k, i
    rp + q] and W3V[o, k rp + q] = w3p[k, rp c_in + o rp + q]; b3 follows
    padded the same way; and lowrank_image_numel sizes the scratch."""
    rng = np.random.default_rng(k + c_in + rank)
    rp = tfc.padded_rank(rank)
    w3 = rng.normal(size=(k, rank * (c_in + c_out))).astype(np.float32)
    b3 = rng.normal(size=rank * (c_in + c_out)).astype(np.float32)
    w3p, ru = _zero_padded(w3, rank), rp * c_in
    w3u = w3p[:, :ru].reshape(k, c_in, rp).transpose(1, 0, 2).reshape(c_in, -1)
    w3v = w3p[:, ru:].reshape(k, c_out, rp).transpose(1, 0, 2).reshape(c_out, -1)
    n = tfc.lowrank_chunk_cols(rank)
    assert n % rp == 0 and n % 8 == 0 and n <= 64
    for backward in (False, True):
        image, b3p = _image(w3, b3, k, c_in, c_out, rank, backward)
        assert image.size + 2 * b3p.size == tfc.lowrank_image_numel(
            k, c_in, c_out, rank, backward)
        assert np.array_equal(b3p, _zero_padded(b3[None], rank)[0])
        dp = tfc.lowrank_image_depth(max(k, c_in, c_out) if backward else k)
        # a stage stays within 24 KB: the ring's four in under half an SM
        assert 3 * 2 * n * _stage_depth(dp) <= 24 * 1024
        stages = _stages(image, n, dp)
        whole = stages.sum(1)
        got = {"uv": [], "p": [], "q": []}
        for c, (reading, lo, cw, _) in enumerate(
                _chunks(k, c_in, c_out, rank, backward)):
            depth = {"uv": k, "p": c_in, "q": c_out}[reading]
            got[reading].append((lo, whole[c, :cw, :depth]))
            assert not whole[c, cw:].any() and not whole[c, :, depth:].any()
            # each part is a bf16 value
            part = stages[c].astype(np.float32)
            assert np.array_equal(torch.as_tensor(part).bfloat16().float().numpy(),
                                  part)
        uv = np.concatenate([b for _, b in sorted(got["uv"], key=lambda x: x[0])])
        assert np.array_equal(uv, w3p.T.astype(np.float64))
        if backward:
            assert np.array_equal(np.concatenate([b for _, b in got["p"]]),
                                  w3u.T.astype(np.float64))
            assert np.array_equal(np.concatenate([b for _, b in got["q"]]),
                                  w3v.T.astype(np.float64))


@pytest.mark.parametrize("c_in,c_out,k", [(48, 48, 48), (5, 7, 3),
                                          (64, 64, 64), (1, 64, 17),
                                          (128, 128, 128), (72, 128, 100),
                                          (256, 256, 256), (136, 250, 200),
                                          (48, 48, 256), (256, 40, 72)])
def test_padded_map_and_sizes_at_every_rank(c_in, c_out, k):
    """At every rank 1-256 (the map alone, no data): rp = 8 ceil(r / 8) up
    to 64, 64 ceil(r / 64) past it, in slabs of R = 64; up to 64 the padded
    columns' map gives every model column once, in order, and -1 exactly
    at q >= r (past it test_slab_map_at_every_rank); a chunk holds whole
    channels of a slab's head, as many as fit in 64 columns; the stage
    image (every slab's chunks), the bfloat16 scratch of the padded w3 and
    B4's weight tiles are sized from rp."""
    nch = c_in + c_out
    # past rank 64 each slab walks rank 64's chunks
    per_slab = {bw: len(_chunks(k, c_in, c_out, 64, bw)) for bw in (False, True)}
    for rank in range(1, 257):
        rp, r, slabs = _slabs(rank)
        assert rp % 8 == 0 and r * slabs == rp
        assert rank <= rp < rank + (8 if rank <= 64 else 64)
        if rank <= 64:
            cols = np.arange(rp * nch)
            rc = _real_col(cols, rp, rank)
            assert np.array_equal(rc[rc >= 0], np.arange(rank * nch))
            assert np.array_equal(rc < 0, cols % rp >= rank)
        n = tfc.lowrank_chunk_cols(rank)
        assert n % r == 0 and n <= 64 < n + r
        assert n == {24: 48, 40: 40, 48: 48, 56: 56}.get(r, 64)
        for backward in (False, True):
            stages = (len(_chunks(k, c_in, c_out, rank, backward))
                      if rank <= 64 else slabs * per_slab[backward])
            depth = max(k, c_in, c_out) if backward else k
            dp = tfc.lowrank_image_depth(depth)
            assert dp == (_round_up(depth, 16) if depth <= 64
                          else _round_up(depth, 32))
            assert tfc.lowrank_image_numel(k, c_in, c_out, rank, backward) == \
                stages * 3 * n * dp + 2 * rp * nch
        tiles, row_tiles = tfc.lowrank_weight_tiles(k, c_in, c_out, rank)
        assert (tiles - 1) * 128 < rp * nch <= tiles * 128
        assert (row_tiles - 1) * 64 < k <= row_tiles * 64
        assert tfc.lowrank_pad_numel(k, c_in, c_out, rank) == (
            0 if rp == rank else k * rp * nch)


@pytest.mark.parametrize("c_in,c_out", [(3, 2), (1, 1)])
def test_slab_map_at_every_rank(c_in, c_out):
    """At every rank 1-256, the image's column map: each slab's column
    (channel, q) is the padded head's (channel, R s + q), by plain indexing
    of the head as [channels, rp], and the slabs cover it once; real_col
    sends it to the model's column channel r + R s + q where R s + q < r,
    every model column once, else -1; b3 follows padded, slab by slab."""
    nch = c_in + c_out
    for rank in range(1, 257):
        rp, r, slabs = _slabs(rank)
        grid = np.arange(rp * nch).reshape(nch, rp)
        c = np.arange(r * nch)
        by_slab = [_slab_col(c, s, r, rp) for s in range(slabs)]
        for s, sc in enumerate(by_slab):
            assert np.array_equal(sc, grid[c // r, r * s + c % r])
            rc = _real_col(sc, rp, rank)
            q = r * s + c % r
            assert np.array_equal(rc, np.where(q < rank, c // r * rank + q, -1))
        every = np.concatenate(by_slab)
        assert np.array_equal(np.sort(every), np.arange(rp * nch))
        rc = _real_col(every, rp, rank)
        assert np.array_equal(np.sort(rc[rc >= 0]), np.arange(rank * nch))
        b3 = np.arange(rank * nch, dtype=np.float32) + 1
        b3p = _b3_padded(b3, c_in, c_out, rank).reshape(slabs, nch, r)
        want = np.zeros((nch, rp), np.float32)
        want[:, :rank] = b3.reshape(nch, rank)
        assert np.array_equal(b3p, want.reshape(nch, slabs, r).transpose(1, 0, 2))


@pytest.mark.parametrize("rank", RANKS)
def test_design_and_libraries_by_rank(rank):
    """Float32 B3/B4 take the tensor cores from their own libraries at a
    rank that is a multiple of 8 and at the ranks just past it (padded to
    the next multiple of 8); no FMA library is left."""
    for dt in (torch.float32, torch.bfloat16):
        assert tfc.design(dt, rank) == "wgmma"
        assert tfc.design(dt, rank - 7) == "wgmma"
        assert tfc.padded_rank(rank - 7) == tfc.padded_rank(rank) == rank
    libs = (tfc._lowrank_library(torch.float32),
            tfc._lowrank_library(torch.float32, backward=True))
    assert libs == ("fused_edge_conv_lowrank_f32_wgmma",
                    "fused_edge_conv_lowrank_bwd_f32_wgmma")
    for lib in libs:
        assert tfc._SOURCES[lib] == lib + ".cu" and lib in tfc._BINDINGS
    assert "fused_edge_conv_lowrank" not in tfc._SOURCES
    assert "fused_edge_conv_lowrank_bwd" not in tfc._SOURCES


# ---------------------------------------------------------------------------
# the kernels' walks in numpy


def _operands(blocks, c_in, c_out, k, rank, seed):
    rng = np.random.default_rng(seed)
    slots, ncol = len(blocks.senders_perm), rank * (c_in + c_out)
    o = dict(h=np.maximum(rng.normal(size=(slots, k)), 0),
             x=rng.normal(size=(blocks.n_nodes, c_in)),
             w3=rng.normal(size=(k, ncol)) * 0.2,
             b3=rng.normal(size=(ncol,)) * 0.1,
             g=rng.normal(size=(blocks.n_pad, c_out)))
    o = {key: v.astype(np.float32) for key, v in o.items()}
    o["x_src"] = o["x"][blocks.senders_perm]
    return o


def _pad(a, depth):
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, depth - a.shape[-1])])


def _scatter(blocks, msg, compact, real, idx):
    """B1's part walk and scatter of per-tile messages [tiles, 64, c_out]
    into the output, the partials summed in order; with a leading slab axis
    [slabs, tiles, 64, c_out] each tile's slabs in turn."""
    c_out = msg.shape[-1]
    slabs = msg if msg.ndim == 4 else msg[None]
    tiles = blocks.blk // 64
    parts = tfc.conv_parts(blocks.num_blocks, tiles, SMS)
    out = np.zeros((parts, blocks.n_pad, c_out), np.float32)
    srow = blocks.compact_s.slot_rows
    for b in range(blocks.num_blocks):
        for p, (lo, hi) in enumerate(tfc.part_bounds(tiles, parts)):
            acc = np.zeros((64, c_out), np.float32)
            for t, m in ((t, m) for t in range(b * tiles + lo, b * tiles + hi)
                         for m in slabs):
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
                            run += m[t, s]
                    if cur >= 0:
                        acc[cur] += run
                else:
                    s_tile = blocks.s_matrix[b * 64:(b + 1) * 64,
                                             (t - b * tiles) * 64:
                                             (t - b * tiles + 1) * 64]
                    acc += (s_tile.astype(np.float64) @ m[t]).astype(np.float32)
            rows = slice(b * 64, (b + 1) * 64)
            out[p, rows] = (blocks.compact_s.row_weight[rows, None] * acc
                            if compact else acc)
    total = out[0]
    for p in range(1, parts):
        total = total + out[p]
    return total


def _uv(acc, b3, lo, cw, rank):
    """A kUv chunk's accumulator plus b3: [tiles, 64, channels, rank]."""
    uv = (acc[..., :cw] + b3[lo:lo + cw]).astype(np.float32)
    return uv.reshape(*uv.shape[:-1], cw // rank, rank)


def _emulate_fwd(blocks, o, c_in, c_out, rank, compact):
    """B3 float32 as csrc/fused_edge_conv_lowrank_f32_wgmma.cu runs it, at
    the padded rank rp (t [..., rp], zero at q >= rank), past 64 slab by
    slab (each slab's messages scattered in turn)."""
    k = o["h"].shape[1]
    rp, r, slabs = _slabs(rank)
    n, dp, ru = tfc.lowrank_chunk_cols(rank), tfc.lowrank_image_depth(k), r * c_in
    nb3 = r * (c_in + c_out)
    b3p = _b3_padded(o["b3"], c_in, c_out, rank)
    stages = _chunk_stages(o["w3"], k, c_in, c_out, rank, False)
    idx, real = _tiles(blocks)
    hp = _split(_pad(o["h"][idx], dp))
    x = o["x"][blocks.senders_perm[idx]]
    t = np.zeros((*idx.shape, rp), np.float32)
    msg = np.zeros((slabs, *idx.shape, c_out), np.float32)
    for (_, lo, cw, sl), block in zip(_chunks(k, c_in, c_out, rank, False),
                                      stages):
        st = _stages(block, n, dp)[0]
        uv = _uv(_six(hp, [st[p].T for p in range(3)]),
                 b3p[sl * nb3:(sl + 1) * nb3], lo, cw, r)
        ts = slice(sl * r, (sl + 1) * r)
        if lo < ru:  # t[s, q] += x[s, i] U[s, i, q]
            for gi in range(cw // r):
                i = lo // r + gi
                t[..., ts] = _fma(x[..., i:i + 1], uv[..., gi, :], t[..., ts])
        else:  # msg[s, o] = sum_q V[s, o, q] t[s, q]
            o0 = (lo - ru) // r
            msg[sl, ..., o0:o0 + cw // r] = (uv * t[..., None, ts]).sum(-1)
    assert not t[..., rank:].any()
    return _scatter(blocks, msg, compact, real, idx)


def _plain_fwd(blocks, o, c_in, c_out, rank, compact):
    t = {key: torch.as_tensor(v) for key, v in o.items()}
    s = blocks.compact_s.to("cpu") if compact else torch.as_tensor(blocks.s_matrix)
    return tfc.fused_edge_conv_lowrank(
        t["h"], t["x"], torch.as_tensor(blocks.senders_perm), t["w3"], t["b3"],
        s, c_in=c_in, c_out=c_out, rank=rank, rows_blk=64, blk=blocks.blk,
        gemm_dtype="float32").numpy()


def _f64_parts(o, c_in, c_out, rank):
    f = {key: v.astype(np.float64) for key, v in o.items()}
    uv = f["h"] @ f["w3"] + f["b3"]
    ru = rank * c_in
    return (f, uv[:, :ru].reshape(-1, c_in, rank),
            uv[:, ru:].reshape(-1, c_out, rank))


def _f64_fwd(blocks, o, c_in, c_out, rank):
    f, u, v = _f64_parts(o, c_in, c_out, rank)
    t = np.einsum("ei,eiq->eq", f["x_src"], u)
    msg = np.einsum("eq,eoq->eo", t, v)
    nb, blk = blocks.num_blocks, blocks.blk
    s = blocks.s_matrix.astype(np.float64).reshape(nb, 64, blk)
    return np.einsum("brs,bso->bro", s, msg.reshape(nb, blk, c_out)).reshape(-1, c_out)


def _kw(blocks, c_in, c_out, rank):
    return dict(c_in=c_in, c_out=c_out, rank=rank, rows_blk=64, blk=blocks.blk,
                gemm_dtype="float32", interpret=True)


def _jax_fwd(blocks, o, c_in, c_out, rank):
    return np.asarray(jfc.fused_edge_conv_lowrank(
        jnp.asarray(o["h"]), jnp.asarray(o["x"]), jnp.asarray(blocks.senders_perm),
        jnp.asarray(o["w3"]), jnp.asarray(o["b3"]), jnp.asarray(blocks.s_matrix),
        **_kw(blocks, c_in, c_out, rank)))


# (c_in, c_out, K, rank): past rank 32 one padded channel per chunk, past
# a depth of 64 the A operands in shared memory and each chunk in stages
# of 32 (the deep walk); past a K, c_in or c_out of 128 the wide layouts
# (the same sums: B3's part sums in device memory, B4's P half of dh in
# dh), at 256 and each wall alone, on a smaller graph; past rank 64 two
# slabs of 64 (rank 100: the second 36 real)
SHAPES = [(16, 16, 16, 16), (12, 20, 33, 8), (9, 7, 5, 24), (8, 8, 17, 32),
          (16, 16, 16, 12), (12, 20, 33, 1), (9, 7, 5, 20), (8, 8, 17, 31),
          (7, 9, 12, 3), (7, 9, 100, 40), (10, 6, 70, 57), (6, 80, 9, 64),
          (9, 7, 128, 16), (256, 256, 256, 64), (48, 48, 256, 16),
          (256, 48, 64, 24), (5, 4, 20, 100)]


def _walk_graph(c_in, c_out, k, seed, rank=1):
    """The walks' graph; past a width or K of 128, or past rank 64, a
    smaller one (a few tiles), whose plain versions, float64 references and
    Pallas runs stay small."""
    if max(c_in, c_out, k) > 128 or rank > 64:
        return _graph("random", seed=seed, n=60, e=200)
    return _graph("random", seed=seed)


@pytest.mark.parametrize("c_in,c_out,k,rank", SHAPES)
def test_fwd_walk_matches_plain_float64_and_pallas(c_in, c_out, k, rank):
    """B3's emulated walk, in both S forms, against
    ``fused_edge_conv_lowrank_plain`` (float32) and a float64 reference
    within 1e-6 of the max, and against the JAX package's Pallas kernel in
    interpret mode (float32 at Precision.HIGHEST) within 1e-5."""
    blocks = _walk_graph(c_in, c_out, k, seed=c_in + k, rank=rank)
    o = _operands(blocks, c_in, c_out, k, rank, seed=c_out + 3 * k)
    ref = _f64_fwd(blocks, o, c_in, c_out, rank)
    jax_ = _jax_fwd(blocks, o, c_in, c_out, rank)
    for compact in (True, False):
        got = _emulate_fwd(blocks, o, c_in, c_out, rank, compact)
        assert got.shape == ref.shape == (blocks.n_pad, c_out)
        assert _rel(got, ref) <= 1e-6
        assert _rel(got, _plain_fwd(blocks, o, c_in, c_out, rank, compact)) <= 1e-6
        assert _rel(got, jax_) <= 1e-5


def _emulate_bwd(blocks, o, c_in, c_out, rank, compact, sms=SMS):
    """B4 float32 as csrc/fused_edge_conv_lowrank_bwd_f32_wgmma.cu runs it
    at the padded rank rp, dw3 and db3 written back to the model's columns:
    (dh, dx_src, dw3, db3)."""
    k = o["h"].shape[1]
    slots = len(blocks.senders_perm)
    rp, r, _ = _slabs(rank)
    ru, ncol, nb3 = r * c_in, rp * (c_in + c_out), r * (c_in + c_out)
    n, dp = (tfc.lowrank_chunk_cols(rank),
             tfc.lowrank_image_depth(max(k, c_in, c_out)))
    b3p = _b3_padded(o["b3"], c_in, c_out, rank)
    stages = _chunk_stages(o["w3"], k, c_in, c_out, rank, True)
    idx, real = _tiles(blocks)
    dmsg = _dmsg(blocks, o["g"], compact)
    # (a) rows: A = split h over the V and U chunks, split x_src over the P
    # chunks, split dmsg over the Q chunks
    d, xs = dmsg[idx], o["x_src"][idx]
    a = {"uv": _split(_pad(o["h"][idx], dp)), "p": _split(_pad(xs, dp)),
         "q": _split(_pad(d, dp))}
    t, dt = (np.zeros((*idx.shape, rp), np.float32) for _ in range(2))
    dx = np.zeros((*idx.shape, c_in), np.float32)
    dh_p, dh = (np.zeros((*idx.shape, k), np.float32) for _ in range(2))
    for (reading, lo, cw, sl), block in zip(
            _chunks(k, c_in, c_out, rank, True), stages):
        st = _stages(block, n, dp)[0]
        acc = _six(a[reading], [st[p].T for p in range(3)])
        qs = slice(sl * r, (sl + 1) * r)  # the slab's t and dt
        if reading == "uv":
            uv = _uv(acc, b3p[sl * nb3:(sl + 1) * nb3], lo, cw, r)
            for gi in range(cw // r):
                ch = (lo - ru if lo >= ru else lo) // r + gi
                if lo >= ru:  # dt[s, q] += dmsg[s, o] V[s, o, q]
                    dt[..., qs] = _fma(d[..., ch:ch + 1], uv[..., gi, :],
                                       dt[..., qs])
                else:  # t += x U; dx_src[s, i] += sum_q U[s, i, q] dt[s, q]
                    t[..., qs] = _fma(xs[..., ch:ch + 1], uv[..., gi, :],
                                      t[..., qs])
                    dx[..., ch] += (uv[..., gi, :] * dt[..., qs]).sum(-1)
        else:  # dh[s, k] += sum_q dt P[s, k, q] + sum_q t Q[s, k, q]
            pq = acc[..., :cw].reshape(*idx.shape, cw // r, r)
            ks = slice(lo // r, lo // r + cw // r)
            if reading == "p":
                dh_p[..., ks] = (pq * dt[..., None, qs]).sum(-1)
            else:
                dh[..., ks] += dh_p[..., ks] + (pq * t[..., None, qs]).sum(-1)
    if compact:  # padding-only tiles write zeros
        for a_ in (dh, dx, t, dt):
            a_[~real] = 0
    dh, dx = dh.reshape(slots, k), dx.reshape(slots, c_in)
    t, dt = t.reshape(slots, rp), dt.reshape(slots, rp)
    assert not t[:, rank:].any() and not dt[:, rank:].any()
    # (b) weights: per split, chunk by chunk, six passes of h^T duv into a
    # fresh accumulator added into the float32 sum; db3 in slot order
    tiles, row_tiles = tfc.lowrank_weight_tiles(k, c_in, c_out, rank)
    splits = tfc.weight_splits(slots, tiles * row_tiles, sms)
    chunks = slots // 64
    per = -(-chunks // splits)
    partial = np.zeros((splits, k + 1, ncol), np.float32)
    for sp in range(splits):
        total = np.zeros((k, ncol), np.float32)
        dbias = np.zeros(ncol, np.float32)
        for ch in range(sp * per, min((sp + 1) * per, chunks)):
            if compact and not real[ch]:
                continue
            rows = slice(64 * ch, 64 * ch + 64)
            duv = np.concatenate(
                [(o["x_src"][rows, :, None] * dt[rows, None, :]).reshape(64, -1),
                 (dmsg[rows, :, None] * t[rows, None, :]).reshape(64, -1)], 1)
            total = total + _six([p.T for p in _split(o["h"][rows])], _split(duv))
            for s in range(64):
                dbias = dbias + duv[s]
        partial[sp, :k], partial[sp, k] = total, dbias
    # each split writes its padded columns' sums at the model's columns
    rc = _real_col(np.arange(ncol), rp, rank)
    assert sorted(rc[rc >= 0]) == list(range(rank * (c_in + c_out)))
    assert not partial[..., rc < 0].any()
    real_partial = np.zeros((splits, k + 1, rank * (c_in + c_out)), np.float32)
    real_partial[..., rc[rc >= 0]] = partial[..., rc >= 0]
    out = real_partial[0]
    for sp in range(1, splits):
        out = out + real_partial[sp]
    return dh, dx, out[:k], out[k]


def _plain_bwd(blocks, o, c_in, c_out, rank, compact):
    t = {key: torch.as_tensor(v) for key, v in o.items()}
    s = blocks.compact_s.to("cpu") if compact else torch.as_tensor(blocks.s_matrix)
    return [a.numpy() for a in tfc.fused_edge_conv_lowrank_bwd(
        t["g"], t["h"], t["x_src"], t["w3"], t["b3"], s, c_in=c_in,
        c_out=c_out, rank=rank, rows_blk=64, blk=blocks.blk,
        gemm_dtype="float32")]


def _f64_bwd(blocks, o, c_in, c_out, rank):
    f, u, v = _f64_parts(o, c_in, c_out, rank)
    nb, blk = blocks.num_blocks, blocks.blk
    s = blocks.s_matrix.astype(np.float64).reshape(nb, 64, blk)
    dmsg = np.einsum("brs,bro->bso", s, f["g"].reshape(nb, 64, -1)).reshape(
        nb * blk, -1)
    t = np.einsum("ei,eiq->eq", f["x_src"], u)
    dt = np.einsum("eo,eoq->eq", dmsg, v)
    slots = len(dmsg)
    duv = np.concatenate([(f["x_src"][:, :, None] * dt[:, None, :]).reshape(slots, -1),
                          (dmsg[:, :, None] * t[:, None, :]).reshape(slots, -1)], 1)
    return (duv @ f["w3"].T, np.einsum("eiq,eq->ei", u, dt), f["h"].T @ duv,
            duv.sum(0))


def _jax_bwd(blocks, o, c_in, c_out, rank):
    return [np.asarray(a) for a in jfc._fused_lowrank_bwd_jit(
        jnp.asarray(o["g"]), jnp.asarray(o["h"]), jnp.asarray(o["x_src"]),
        jnp.asarray(o["w3"]), jnp.asarray(o["b3"]), jnp.asarray(blocks.s_matrix),
        sub=None, **_kw(blocks, c_in, c_out, rank))]


NAMES = ("dh", "dx_src", "dw3", "db3")


@pytest.mark.parametrize("c_in,c_out,k,rank", SHAPES)
def test_bwd_rows_and_weights_match_plain_float64_and_pallas(c_in, c_out, k,
                                                            rank):
    """B4's emulated rows and weights kernels, in both S forms, against
    ``fused_edge_conv_lowrank_bwd_plain`` and a float64 reference within
    1e-6 of each output's max, and against the JAX package's Pallas
    backward in interpret mode within 1e-5; dw3 and db3 in the model's
    column layout (the JAX function unpermutes its own)."""
    blocks = _walk_graph(c_in, c_out, k, seed=c_in + k + 1, rank=rank)
    o = _operands(blocks, c_in, c_out, k, rank, seed=c_out + 3 * k + 1)
    ref = _f64_bwd(blocks, o, c_in, c_out, rank)
    jax_ = _jax_bwd(blocks, o, c_in, c_out, rank)
    for compact in (True, False):
        got = _emulate_bwd(blocks, o, c_in, c_out, rank, compact)
        plain = _plain_bwd(blocks, o, c_in, c_out, rank, compact)
        for name, a, r, p, j in zip(NAMES, got, ref, plain, jax_):
            assert a.shape == r.shape == p.shape == j.shape, name
            assert _rel(a, r) <= 1e-6, (name, compact, _rel(a, r))
            assert _rel(a, p) <= 1e-6, (name, compact, _rel(a, p))
            assert _rel(a, j) <= 1e-5, (name, compact, _rel(a, j))


@pytest.mark.parametrize("sms", [SMS, 2])
def test_padding_tiles_and_few_splits(sms):
    """Tiles of padding only (skipped by B3's producer and consumers, zeros
    from B4's rows kernel, skipped chunks in its weights kernel) and one
    receiver block without any edge, at the card's split count and at a
    few long splits."""
    blocks = _graph("skewed", seed=44)
    _, real = _tiles(blocks)
    assert (~real).sum() >= blocks.blk // 64
    o = _operands(blocks, 16, 16, 8, 16, seed=45)
    got = _emulate_fwd(blocks, o, 16, 16, 16, True)
    assert _rel(got, _f64_fwd(blocks, o, 16, 16, 16)) <= 1e-6
    got = _emulate_bwd(blocks, o, 16, 16, 16, True, sms=sms)
    for name, a, ref in zip(NAMES, got, _f64_bwd(blocks, o, 16, 16, 16)):
        assert _rel(a, ref) <= 1e-6, (name, _rel(a, ref))


def _truncated(parts, keep):
    return [p if i < keep else np.zeros_like(p) for i, p in enumerate(parts)]


@pytest.mark.parametrize("operand", ["dmsg", "duv"])
def test_dmsg_and_duv_need_all_three_parts(operand):
    """dmsg = row_weight g[slot_rows] (Q = dmsg @ W3V in the rows kernel)
    and duv = x_src (x) dt (h^T duv in the weights kernel) are float32
    products with full 24-bit significands: from one part (a bf16 rounding)
    or two parts the six products err well past float32's own error, from
    all three they stay at its level (against float64)."""
    rng = np.random.default_rng(8)
    rank, c = 16, 16
    if operand == "dmsg":
        deg = rng.integers(1, 9, size=(256, 1))
        a = ((1.0 / deg).astype(np.float32)
             * rng.normal(size=(256, c)).astype(np.float32))
        b = (rng.normal(size=(c, 48 * rank)) * 0.2).astype(np.float32)
        lhs, rhs = a, b
        a_parts, b_parts = _split(lhs), _split(rhs)
    else:
        h = np.maximum(rng.normal(size=(256, 48)), 0).astype(np.float32)
        xs = rng.normal(size=(256, c)).astype(np.float32)
        dt = rng.normal(size=(256, rank)).astype(np.float32)
        duv = (xs[:, :, None] * dt[:, None, :]).reshape(256, -1)
        lhs, rhs = h.T, duv
        a_parts, b_parts = [p.T for p in _split(h)], _split(duv)
    ref = lhs.astype(np.float64) @ rhs.astype(np.float64)
    top = np.abs(ref).max()
    f32 = np.abs((lhs @ rhs).astype(np.float64) - ref).max() / top
    split = b_parts if operand == "duv" else a_parts

    def err(keep):
        parts = _truncated(split, keep)
        got = _six(a_parts, parts) if operand == "duv" else _six(parts, b_parts)
        return np.abs(got - ref).max() / top

    assert err(3) <= 2 * f32 + 1e-7
    assert err(2) > 5 * f32 and err(1) > 5 * f32
    assert (split[2] != 0).mean() > 0.5


# ---------------------------------------------------------------------------
# the float32 rank-r wrappers refuse what the kernels do not take, before
# any launch


def _small(k=6, c=8, rank=16):
    blocks = _graph("random", seed=3)
    o = _operands(blocks, c, c, k, rank, seed=4)
    t = {key: torch.as_tensor(v) for key, v in o.items()}
    fwd = (t["h"], t["x"], torch.as_tensor(blocks.senders_perm), t["w3"],
           t["b3"], blocks.compact_s.to("cpu"))
    bwd = (t["g"], t["h"], t["x_src"], t["w3"], t["b3"],
           blocks.compact_s.to("cpu"))
    return fwd, bwd, dict(c_in=c, c_out=c, rank=rank, rows_blk=64,
                          blk=blocks.blk)


def _fn(which, fwd, bwd):
    return ((tfc.fused_edge_conv_lowrank_cuda, fwd) if which == "fwd"
            else (tfc.fused_edge_conv_lowrank_bwd_cuda, bwd))


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("bad,match", [
    ({"rank": 257}, "rank=257"),
    ({"c_out": 257}, "c_out=257 outside the kernel's 1..256"),
    ({"c_in": 0}, "c_in=0"), ({"rows_blk": 16}, "rows_blk=16"),
    ({"blk": 32}, "blk=32")])
def test_f32_lowrank_wrappers_refuse_geometry_before_launch(which, bad, match):
    fwd, bwd, kw = _small()
    assert fwd[0].dtype == torch.float32
    assert tfc.design(torch.float32, kw["rank"]) == "wgmma"
    fn, args = _fn(which, fwd, bwd)
    with pytest.raises(ValueError, match=match):
        fn(*args, **{**kw, **bad})


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_f32_lowrank_wrappers_refuse_k_past_64_cpu_tensors_and_float64(which):
    """K past the kernels' 256 (the name is from when they stopped at 64),
    CPU tensors and float64 are refused before any launch."""
    fwd, bwd, kw = _small(k=257)
    fn, args = _fn(which, fwd, bwd)
    with pytest.raises(ValueError, match="K=257 outside the kernel's 1..256"):
        fn(*args, **kw)
    fwd, bwd, kw = _small()
    fn, args = _fn(which, fwd, bwd)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fn(*args, **kw)
    args = list(args)
    at = 0 if which == "fwd" else 1  # h_blocked
    args[at] = args[at].double()
    with pytest.raises(TypeError, match="float64"):
        fn(*args, **kw)
