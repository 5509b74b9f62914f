"""Host-side pieces of the bfloat16 tensor-core B3 and B4
(csrc/fused_edge_conv_lowrank_wgmma.cu, csrc/fused_edge_conv_lowrank_bwd_wgmma.cu
and csrc/lowrank_wgmma.cuh), on the CPU: the design rule by type and rank,
the exact three-part bf16 split of float32 values that the weights kernel
relies on, the wgmma accumulator's column -> (channel, q) mapping, the chunk
schedules and column and row tiles (ranks up to 64, widths and K up to
128), the padded head of a rank that is not a
multiple of 8 (pad_head's copy of w3, b3 staged padded, dw3/db3 written back
to the model's columns), the slabs of 64 past rank 64 (the column map at
every rank 1-256), a numpy emulation of both kernels' tile loops
(the w3 pieces they stage, the accumulator values each thread holds, the
per-thread sums and quad shuffles; past rank 64 slab by slab) against the
plain versions' indexing, and the wrappers refusing geometry they do not
take."""

import numpy as np
import pytest
import torch

from fast_eng_super_resolution_tpu_torch.ops import fused_conv as tfc

THREADS = np.arange(128)[:, None]   # a warpgroup's threads
VALUES = np.arange(64)[None, :]     # an m64n128 accumulator's values j


def acc_row(t, j):
    """wgmma_tile.cuh acc_row: the row of value j of thread t."""
    return 16 * (t // 32) + (t % 32) // 4 + 8 * ((j >> 1) & 1)


def acc_col(t, j):
    """wgmma_tile.cuh acc_col: the column of value j of thread t."""
    return 8 * (j >> 2) + 2 * (t % 4) + (j & 1)


def channel_of(j, r8):
    """lowrank_wgmma.cuh channel_of."""
    return (j >> 2) // r8


def q_of(t, j, r8):
    """lowrank_wgmma.cuh q_of."""
    return 8 * ((j >> 2) % r8) + 2 * (t % 4) + (j & 1)


def lowrank_chunks(k, c_in, c_out, rank, backward=False):
    """The 128-column chunks B3 (``backward`` False) or B4's rows kernel
    walks per 64-slot tile, in order, as (kind, first column, columns), as
    the kernels build them: 'u' and 'v' chunks of uv's U and V columns in
    whole channels of G = 128 // rank (rank the padded one, 8 .. 64: G 16
    .. 2); in B4 the V chunks first, then the U
    chunks, then for each group of G rows k of w3 a 'p' chunk (P = x_src @
    W3U) and a 'q' chunk (Q = dmsg @ W3V) over the (k, q) columns
    k*rank + q."""
    g = 128 // rank

    def groups(kind, n, base):
        return [(kind, base + c0 * rank, min(g, n - c0) * rank)
                for c0 in range(0, n, g)]

    u = groups("u", c_in, 0)
    v = groups("v", c_out, rank * c_in)
    if not backward:
        return u + v
    pq = [c for p, q in zip(groups("p", k, 0), groups("q", k, 0))
          for c in (p, q)]
    return v + u + pq


@pytest.mark.parametrize("dt,rank,want", [
    (torch.bfloat16, None, "wgmma"), (torch.float32, None, "wgmma"),
    (torch.bfloat16, 8, "wgmma"), (torch.bfloat16, 16, "wgmma"),
    (torch.bfloat16, 24, "wgmma"), (torch.bfloat16, 32, "wgmma"),
    (torch.bfloat16, 3, "wgmma"), (torch.bfloat16, 12, "wgmma"),
    (torch.bfloat16, 1, "wgmma"), (torch.float32, 16, "wgmma"),
    (torch.float32, 8, "wgmma"), (torch.float32, 24, "wgmma"),
    (torch.float32, 32, "wgmma"), (torch.float32, 3, "wgmma")])
def test_design_by_type_and_rank(dt, rank, want):
    """B1/B2 and B3/B4 take the tensor cores in both types at every rank,
    a rank that is not a multiple of 8 at its padded rank."""
    assert tfc.design(dt, rank) == want


def _split3(v: torch.Tensor):
    d1 = v.to(torch.bfloat16).float()
    r1 = v - d1
    d2 = r1.to(torch.bfloat16).float()
    d3 = (r1 - d2).to(torch.bfloat16).float()
    return d1, d2, d3


def _float32_values(kind: str, n: int = 200_000) -> torch.Tensor:
    rng = np.random.default_rng(["normal", "tiny", "huge", "negative",
                                 "products"].index(kind))
    if kind == "products":  # duv as the kernel forms it: bf16 x float32
        a = torch.as_tensor(rng.normal(size=n), dtype=torch.float32)
        b = torch.as_tensor(rng.normal(size=n) * np.exp2(rng.integers(-30, 30, n)),
                            dtype=torch.float32)
        return a.to(torch.bfloat16).float() * b
    lo, hi = {"normal": (-30, 30), "tiny": (-110, -90), "huge": (100, 127),
              "negative": (-60, 60)}[kind]
    # full 24-bit significands, so that all three parts carry bits
    mant = 1.0 + rng.integers(0, 1 << 23, n) / float(1 << 23)
    v = mant * np.exp2(rng.integers(lo, hi, n).astype(np.float64))
    if kind == "huge":
        v = np.minimum(v, 3.38e38)
    sign = -1.0 if kind == "negative" else rng.choice([-1.0, 1.0], n)
    return torch.as_tensor(sign * v, dtype=torch.float32)


@pytest.mark.parametrize("kind", ["normal", "tiny", "huge", "negative",
                                  "products"])
def test_three_part_split_is_exact(kind):
    """d1 = bf16(v), d2 = bf16(v - d1), d3 = bf16(v - d1 - d2): each
    remainder is exact in float32 and 8 + 8 + 8 significant bits cover
    float32's 24, so d1 + d2 + d3 == v exactly (in float64), for tiny
    (2^-110), huge (up to 3.38e38) and negative values alike."""
    v = _float32_values(kind)
    d1, d2, d3 = _split3(v)
    for d in (d1, d2, d3):  # each part is a bf16 value
        assert torch.equal(d.to(torch.bfloat16).float(), d)
        assert torch.isfinite(d).all()
    assert torch.equal(d1.double() + d2.double() + d3.double(), v.double())
    # the split is not trivial: the third part carries bits for most values
    assert (d3 != 0).float().mean() > 0.5


def test_two_part_split_is_not_exact():
    """Two bf16 parts cover 16 of float32's 24 significant bits: without
    the third, most float32 values are not represented."""
    v = _float32_values("products")
    d1, d2, _ = _split3(v)
    assert (d1.double() + d2.double() != v.double()).float().mean() > 0.5


@pytest.mark.parametrize("rank", [8, 16, 24, 32, 40, 48, 56, 64])
def test_accumulator_maps_to_channel_and_q(rank):
    """The column of accumulator value j of thread t is channel
    channel_of(j) * rank + q_of(t, j) of its chunk; every thread holds the
    same 2 r/8 values of q for every channel, and the 4 threads of a quad
    (one row) hold each (channel, q) of the chunk's whole channels once."""
    r8 = rank // 8
    g = 128 // rank
    col = acc_col(THREADS, VALUES)
    ch = channel_of(VALUES, r8) + 0 * THREADS
    q = q_of(THREADS, VALUES, r8)
    real = ch < g  # r = 24, 40: the last 8 of 128 columns hold no whole
    # channel, r = 48 (56) the last 32 (16)
    assert np.array_equal((ch * rank + q)[real], col[real])
    assert (q[real] < rank).all()
    for t in range(128):
        sets = [set(q[t][(ch[t] == c) & real[t]]) for c in range(g)]
        assert all(s == sets[0] for s in sets) and len(sets[0]) == 2 * r8
    rows = acc_row(THREADS, VALUES)
    for quad in range(32):
        for row in set(rows[4 * quad:4 * quad + 4].ravel()):
            sel = (rows[4 * quad:4 * quad + 4] == row) & real[4 * quad:4 * quad + 4]
            pairs = sorted(zip(ch[4 * quad:4 * quad + 4][sel],
                               q[4 * quad:4 * quad + 4][sel]))
            assert pairs == [(c, qq) for c in range(g) for qq in range(rank)]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("k,c_in,c_out,rank", [
    (48, 48, 48, 16), (48, 48, 48, 8), (64, 64, 64, 32), (17, 5, 7, 16),
    (1, 1, 1, 8), (20, 30, 13, 24), (64, 64, 64, 24), (128, 128, 128, 64),
    (96, 96, 96, 40), (128, 72, 128, 48), (100, 127, 127, 56),
    (48, 48, 48, 40), (128, 128, 128, 8), (256, 256, 256, 64),
    (256, 48, 48, 16), (64, 256, 48, 24), (200, 136, 250, 40),
    (256, 256, 256, 8)])
def test_lowrank_chunks_cover_every_column_once_in_order(k, c_in, c_out,
                                                         rank, backward):
    """The forward walks uv's U then V columns; the rows kernel its V then U
    columns, then P and Q chunks over the (k, q) columns in pairs: each
    column once, in order, in chunks of whole channels of at most 128
    columns; past a depth of 128 each chunk's stages of 64 cover its depth
    once, in order."""
    chunks = lowrank_chunks(k, c_in, c_out, rank, backward)
    kp, dpi, dpo = (-(-n // 16) * 16 for n in (k, c_in, c_out))
    bd = _ring_depth(max(kp, dpi, dpo) if backward else kp)
    for kind, _, _ in chunks:
        depth = {"u": kp, "v": kp, "p": dpi, "q": dpo}[kind]
        pieces = [(d0, min(bd, depth - d0)) for d0 in range(0, depth, bd)]
        assert all(dd % 16 == 0 and 0 < dd <= 128 for _, dd in pieces)
        assert sum(dd for _, dd in pieces) == depth
        assert len(pieces) == 1 or bd == 64
    ru, ncol = rank * c_in, rank * (c_in + c_out)
    for kind, lo, cw in chunks:
        assert 0 < cw <= 128 and cw % rank == 0 and lo % rank == 0
        assert cw == 128 // rank * rank or lo + cw in (ru, ncol, k * rank)
    uv = [c for c in chunks if c[0] in "uv"]
    order = (sorted(uv, key=lambda c: (c[0] == "u", c[1])) if backward
             else sorted(uv, key=lambda c: c[1]))
    assert uv == order
    covered = [col for _, lo, cw in uv for col in range(lo, lo + cw)]
    assert sorted(covered) == list(range(ncol))
    assert all(c[1] < ru for c in uv if c[0] == "u")
    pq = [c for c in chunks if c[0] in "pq"]
    if not backward:
        assert not pq
        return
    assert chunks[:len(uv)] == uv and chunks[len(uv):] == pq
    assert [c[0] for c in pq] == ["p", "q"] * (len(pq) // 2)
    for kind in "pq":
        cols = [col for kd, lo, cw in pq if kd == kind
                for col in range(lo, lo + cw)]
        assert cols == list(range(k * rank))


@pytest.mark.parametrize("rank,c_in,c_out", [(16, 48, 48), (8, 5, 5),
                                             (32, 64, 64), (24, 13, 30),
                                             (12, 48, 48), (3, 5, 5),
                                             (31, 64, 64), (20, 13, 30),
                                             (64, 128, 128), (40, 96, 96),
                                             (57, 127, 127), (20, 72, 128),
                                             (8, 128, 128), (64, 256, 256),
                                             (33, 136, 250), (24, 256, 48)])
def test_lowrank_weight_tiles_cover_the_output_once(rank, c_in, c_out):
    """At K 1-256, the 128-column by 64-row tiles cover the padded dw3 [K,
    rp (c_in + c_out)] once, and row K (db3) once, from the first row
    tile's blocks (each tile writes its columns with q < r to the
    model's)."""
    ncol = tfc.padded_rank(rank) * (c_in + c_out)
    for k in (1, 48, 64, 65, 100, 128, 200, 256):
        tiles, row_tiles = tfc.lowrank_weight_tiles(k, c_in, c_out, rank)
        cover = np.zeros((k + 1, tiles * 128), np.int32)
        for n in range(tiles):
            for kt in range(row_tiles):
                k0 = 64 * kt
                cover[k0:min(k0 + 64, k), n * 128:(n + 1) * 128] += 1
                if k0 == 0:  # db3: the thread that forms its column
                    cover[k, n * 128:(n + 1) * 128] += 1
        assert (cover[:, :ncol] == 1).all() and (tiles - 1) * 128 < ncol
        assert (row_tiles - 1) * 64 < k <= row_tiles * 64
    tiles, row_tiles = tfc.lowrank_weight_tiles(128, c_in, c_out, rank)
    # with the slot splits the wrapper picks, every 64-slot chunk once, in
    # order (a split past the last chunk writes a zero partial)
    chunks = 247_808 // 64
    splits = tfc.weight_splits(247_808, tiles * row_tiles, 132)
    per = -(-chunks // splits)  # as the kernel cuts them
    got = [c for sp in range(splits)
           for c in range(sp * per, min((sp + 1) * per, chunks))]
    assert got == list(range(chunks))


# ---------------------------------------------------------------------------
# numpy emulation of the kernels' tile loops (float64, one 64-slot tile)


def slab_col(c, s, r, rp):
    """lowrank_wgmma.cuh slab_col: the padded head's column of column c of
    slab s's head at rank r (channel c // r, q = r s + c % r)."""
    return c // r * rp + s * r + c % r


def _stage(w3, kind, lo, cw, depth, real, rank, c_in, d0=0, rp=None, s0=0):
    """The B operand [128 columns, depth] as ChunkCopy copies it for the
    stage of a chunk from depth row d0 on: piece p of 8 columns at depth
    row d0 + d read as 8 consecutive entries of w3 from the piece's offset
    (lowrank_wgmma.cuh), zeros outside the chunk.  Past rank 64 (kSlab) the
    chunk's columns are those of the slab whose first q is s0 (its head at
    ``rank`` 64) in w3 padded to ``rp``."""
    rp = rank if rp is None else rp
    ncol = w3.shape[1]
    flat = w3.reshape(-1)
    d = d0 + np.arange(depth)[None, :]
    n = np.arange(0, 128, 8)[:, None]
    ok = (d < real) & (n < cw)
    if kind == "uv":
        off = d * ncol + slab_col(lo + n, s0 // rank, rank, rp)
    else:
        kk, q = (lo + n) // rank, (lo + n) % rank
        off = kk * ncol + (rp * c_in if kind == "q" else 0) + d * rp + s0 + q
    vals = flat[np.where(ok, off, 0)[..., None] + np.arange(8)]
    vals = np.where(ok[..., None], vals, 0.0)  # [piece, depth, 8]
    return vals.transpose(0, 2, 1).reshape(128, depth)


def _ring_depth(dmax):
    """A ring buffer's depth: a whole chunk up to a depth of 128, else a
    stage of 64 (lowrank_wgmma.cuh staged, kStage)."""
    return dmax if dmax <= 128 else 64


def _staged(a, w3, kind, lo, cw, depth, real, rank, c_in, bd, rp=None,
            s0=0):
    """A chunk's product as the kernels run it: stage by stage of bd deep
    (product_stage), each stage's B copied by ChunkCopy, into one
    accumulator."""
    acc = 0.0
    for d0 in range(0, depth, bd):
        dd = min(bd, depth - d0)
        acc = acc + _products(a[:, d0:d0 + dd],
                              _stage(w3, kind, lo, cw, dd, real, rank, c_in,
                                     d0, rp, s0))
    return acc


def _products(a, b):
    """Each thread's accumulator values of a m64n128 product a @ b^T."""
    full = np.zeros((64, 128))
    full[:, :] = a @ b.T
    return full[acc_row(THREADS, VALUES), acc_col(THREADS, VALUES)]


def _tile(rank, c_in, c_out, k, seed):
    rng = np.random.default_rng(seed)
    ncol = rank * (c_in + c_out)
    return dict(h=rng.normal(size=(64, k)), x=rng.normal(size=(64, c_in)),
                d=rng.normal(size=(64, c_out)),
                w3=rng.normal(size=(k, ncol)), b3=rng.normal(size=ncol))


def _pad(a, depth):
    return np.pad(a, ((0, 0), (0, depth - a.shape[1])))


def _plain(o, rank, c_in):
    """The plain versions' quantities for one tile, written out."""
    uv = o["h"] @ o["w3"] + o["b3"]
    u = uv[:, :rank * c_in].reshape(64, c_in, rank)
    v = uv[:, rank * c_in:].reshape(64, -1, rank)
    t = np.einsum("ei,eiq->eq", o["x"], u)
    dt = np.einsum("eo,eoq->eq", o["d"], v)
    duv = np.concatenate([(o["x"][:, :, None] * dt[:, None, :]).reshape(64, -1),
                          (o["d"][:, :, None] * t[:, None, :]).reshape(64, -1)], 1)
    return dict(t=t, msg=np.einsum("eq,eoq->eo", t, v), dt=dt,
                dx=np.einsum("eiq,eq->ei", u, dt), duv=duv,
                dh=duv @ o["w3"].T)


def _emulate(o, rank, c_in, c_out, k, backward, rp=None, slab=0):
    """Both kernels' chunk loops over one tile, thread by thread: t and dt
    accumulated per thread at its q (tq, dq [thread, half, r/8, 2]), msg,
    dx_src and dh as per-thread partials summed over each quad.  With
    ``rp`` (past rank 64): slab ``slab``'s walk at ``rank`` 64 on w3 and b3
    padded to rp, its terms of msg, dx_src and dh and its t and dt."""
    s0 = 64 * slab if rp is not None else 0
    r8, g = rank // 8, 128 // rank
    kp, dpi, dpo = (-(-n // 16) * 16 for n in (k, c_in, c_out))
    rows = acc_row(THREADS, VALUES)
    hf, m, b = (VALUES >> 1) & 1, (VALUES >> 2) % r8, VALUES & 1
    ch = channel_of(VALUES, r8) + 0 * THREADS
    q = q_of(THREADS, VALUES, r8)
    tq = np.zeros((128, 2, r8, 2))
    dq = np.zeros((128, 2, r8, 2))
    out = {"msg": np.zeros((64, c_out)), "dx": np.zeros((64, c_in)),
           "dh": np.zeros((64, k))}
    bd = _ring_depth(max(kp, dpi, dpo) if backward else kp)
    t_idx = (THREADS + 0 * VALUES, hf + 0 * THREADS, m + 0 * THREADS,
             b + 0 * THREADS)
    dh_p = None
    for kind, lo, cw in lowrank_chunks(k, c_in, c_out, rank, backward):
        real = ch < cw // rank
        if kind in "uv":
            acc = _staged(_pad(o["h"], kp), o["w3"], "uv", lo, cw, kp, k,
                          rank, c_in, bd, rp, s0)
            base = lo // rank - (c_in if kind == "v" else 0)  # first channel
            # the chunk's b3 as ChunkCopy copies it beside its w3 columns
            bias = np.zeros(128)
            bias[:cw] = o["b3"][slab_col(lo + np.arange(cw), slab, rank,
                                         rp or rank)]
            uv = acc + bias[np.minimum(ch * rank + q, 127)]
            chan = base + ch
        else:
            a, depth, real_d = ((o["x"], dpi, c_in) if kind == "p"
                                else (o["d"], dpo, c_out))
            acc = _staged(_pad(a, depth), o["w3"], kind, lo, cw, depth,
                          real_d, rank, c_in, bd, rp, s0)
            chan = lo // rank + ch
        if kind == "u":
            xv = o["x"][rows, np.minimum(chan, c_in - 1)]
            np.add.at(tq, t_idx, np.where(real, xv * uv, 0.0))
            if backward:  # dx_src: partials of U dt, summed over the quad
                part = np.where(real, uv * dq[t_idx], 0.0)
                np.add.at(out["dx"], (rows, np.minimum(chan, c_in - 1)), part)
        elif kind == "v":
            if backward:  # dt += dmsg V
                dv = o["d"][rows, np.minimum(chan, c_out - 1)]
                np.add.at(dq, t_idx, np.where(real, dv * uv, 0.0))
            else:  # msg: partials of V t, summed over the quad
                part = np.where(real, uv * tq[t_idx], 0.0)
                np.add.at(out["msg"], (rows, np.minimum(chan, c_out - 1)), part)
        elif kind == "p":  # the P half of dh, held until the Q chunk
            dh_p = np.where(real, acc * dq[t_idx], 0.0)
        else:
            part = dh_p + np.where(real, acc * tq[t_idx], 0.0)
            np.add.at(out["dh"], (rows, np.minimum(chan, k - 1)), part)
    # t and dt as the rows kernel writes them: thread t's (half, m, b) at
    # row r0 + 8 half, q = q_of(4 m + b)
    for name, acc in (("t", tq), ("dt", dq)):
        vec = np.full((64, rank), np.nan)
        for th in range(128):
            for h2 in range(2):
                for mm in range(r8):
                    for bb in range(2):
                        j = 4 * mm + bb + 2 * h2
                        vec[acc_row(th, j), q_of(th, 4 * mm + bb, r8)] = \
                            acc[th, h2, mm, bb]
        out[name] = vec
    return out


# (rank, c_in, c_out, K); past a depth of 128 each chunk in stages of 64:
# 256 everywhere, K alone, c_in alone
WALKS = [(16, 48, 48, 48), (8, 12, 12, 5), (24, 7, 11, 33), (32, 9, 9, 64),
         (16, 5, 5, 1), (40, 7, 11, 100), (48, 9, 5, 70), (56, 5, 12, 33),
         (64, 128, 128, 128), (8, 128, 72, 128), (64, 256, 256, 256),
         (16, 48, 48, 256), (24, 256, 48, 64)]


@pytest.mark.parametrize("rank,c_in,c_out,k", WALKS)
def test_forward_tile_loop_matches_plain_indexing(rank, c_in, c_out, k):
    """B3's tile loop as the kernel runs it (chunks of whole channels, the
    accumulator's (channel, q) per thread, t in registers, msg as quad
    sums) gives the plain version's t and msg."""
    o = _tile(rank, c_in, c_out, k, seed=rank + k)
    got = _emulate(o, rank, c_in, c_out, k, backward=False)
    want = _plain(o, rank, c_in)
    np.testing.assert_allclose(got["t"], want["t"], rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(got["msg"], want["msg"], rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("rank,c_in,c_out,k", WALKS)
def test_backward_tile_loop_matches_plain_indexing(rank, c_in, c_out, k):
    """B4's rows kernel as it runs (dt from the V chunks, t and dx_src from
    the U chunks, dh from the factored P = x_src W3U and Q = dmsg W3V
    products weighted by dt and t) gives the plain version's dt, t, dx_src
    and dh = duv w3^T."""
    o = _tile(rank, c_in, c_out, k, seed=rank + k + 1)
    got = _emulate(o, rank, c_in, c_out, k, backward=True)
    want = _plain(o, rank, c_in)
    for name in ("t", "dt", "dx", "dh"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-12,
                                   atol=1e-9, err_msg=name)


# ---------------------------------------------------------------------------
# ranks that are not a multiple of 8: the padded head


PADDED = [(1, 7, 5, 9), (3, 12, 12, 5), (5, 9, 9, 33), (12, 48, 48, 48),
          (20, 13, 30, 17), (27, 9, 9, 64), (31, 5, 5, 1), (33, 7, 9, 100),
          (36, 48, 48, 48), (57, 127, 127, 128), (63, 5, 3, 65)]


def real_col(c, rp, r):
    """lowrank_wgmma.cuh real_col: the model's column of padded column c
    (channel c // rp, q = c % rp), -1 at q >= r."""
    ch, q = c // rp, c % rp
    return np.where(q < r, ch * r + q, -1)


def _pad_head(w3, b3, rank):
    """pad_head's copy of w3 (thread e writes padded element e of [K,
    rp nch]) and stage_bias's padded b3, from their index maps."""
    k, ncol = w3.shape
    rp = tfc.padded_rank(rank)
    ncolp = rp * ncol // rank
    e = np.arange(k * ncolp)
    kk, rc = e // ncolp, real_col(e % ncolp, rp, rank)
    w3p = np.where(rc >= 0, w3.reshape(-1)[kk * ncol + np.maximum(rc, 0)], 0)
    rcb = real_col(np.arange(ncolp), rp, rank)
    return (w3p.reshape(k, ncolp),
            np.where(rcb >= 0, b3[np.maximum(rcb, 0)], 0.0))


@pytest.mark.parametrize("rank,c_in,c_out,k", PADDED)
def test_padded_head_holds_each_column_once(rank, c_in, c_out, k):
    """pad_head and stage_bias put w3's and b3's column i r + q at i rp + q
    (U and V channels alike) and zeros at q >= r, for every row of w3;
    lowrank_pad_numel sizes the copy."""
    o = _tile(rank, c_in, c_out, k, seed=rank)
    rp = tfc.padded_rank(rank)
    w3p, b3p = _pad_head(o["w3"], o["b3"], rank)
    assert w3p.size == tfc.lowrank_pad_numel(k, c_in, c_out, rank)
    nch = c_in + c_out
    w = w3p.reshape(k, nch, rp)
    assert np.array_equal(w[:, :, :rank], o["w3"].reshape(k, nch, rank))
    assert not w[:, :, rank:].any()
    b = b3p.reshape(nch, rp)
    assert np.array_equal(b[:, :rank], o["b3"].reshape(nch, rank))
    assert not b[:, rank:].any()


@pytest.mark.parametrize("rank,c_in,c_out,k", PADDED)
def test_padded_forward_tile_loop_matches_plain_indexing(rank, c_in, c_out,
                                                         k):
    """B3's tile loop at the padded rank on the padded head gives the plain
    version's t (zeros at q >= r) and msg at rank r."""
    o = _tile(rank, c_in, c_out, k, seed=rank + k)
    w3p, b3p = _pad_head(o["w3"], o["b3"], rank)
    rp = tfc.padded_rank(rank)
    got = _emulate(dict(o, w3=w3p, b3=b3p), rp, c_in, c_out, k,
                   backward=False)
    want = _plain(o, rank, c_in)
    np.testing.assert_allclose(got["t"][:, :rank], want["t"], rtol=1e-12,
                               atol=1e-10)
    assert not got["t"][:, rank:].any()
    np.testing.assert_allclose(got["msg"], want["msg"], rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("rank,c_in,c_out,k", PADDED)
def test_padded_backward_matches_plain_indexing(rank, c_in, c_out, k):
    """B4 at the padded rank: the rows kernel gives the plain version's dt,
    t (zeros at q >= r), dx_src and dh at rank r; the weights kernel's duv
    over the padded columns, formed from that t and dt, is zero at q >= r,
    and its h^T duv and column sums written back to the model's columns
    (promote, db3) are the plain dw3 and db3, each column once."""
    o = _tile(rank, c_in, c_out, k, seed=rank + k + 1)
    w3p, b3p = _pad_head(o["w3"], o["b3"], rank)
    rp = tfc.padded_rank(rank)
    got = _emulate(dict(o, w3=w3p, b3=b3p), rp, c_in, c_out, k, backward=True)
    want = _plain(o, rank, c_in)
    for name in ("t", "dt"):
        np.testing.assert_allclose(got[name][:, :rank], want[name],
                                   rtol=1e-12, atol=1e-9, err_msg=name)
        assert not got[name][:, rank:].any(), name
    for name in ("dx", "dh"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-12,
                                   atol=1e-9, err_msg=name)
    # the weights kernel: U column (i, q) = x_src[:, i] dt[:, q], V column
    # (o, q) = dmsg[:, o] t[:, q] over the padded columns, tile by tile
    duvp = np.concatenate(
        [(o["x"][:, :, None] * got["dt"][:, None, :]).reshape(64, -1),
         (o["d"][:, :, None] * got["t"][:, None, :]).reshape(64, -1)], 1)
    ncolp, ncol = duvp.shape[1], rank * (c_in + c_out)
    sums = np.vstack([o["h"].T @ duvp, duvp.sum(0)])  # [K+1, ncolp]
    out = np.full((k + 1, ncol), np.nan)
    tiles, _ = tfc.lowrank_weight_tiles(k, c_in, c_out, rank)
    for n0 in range(0, tiles * 128, 128):
        cols = np.arange(n0, min(n0 + 128, ncolp))
        rc = real_col(cols, rp, rank)
        assert not duvp[:, cols[rc < 0]].any()
        assert np.isnan(out[:, rc[rc >= 0]]).all()  # each column once
        out[:, rc[rc >= 0]] = sums[:, cols[rc >= 0]]
    np.testing.assert_allclose(out[:k], o["h"].T @ want["duv"], rtol=1e-12,
                               atol=1e-9)
    np.testing.assert_allclose(out[k], want["duv"].sum(0), rtol=1e-12,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# ranks past 64: slabs of 64


def test_slab_column_map_at_every_rank():
    """At every rank 1-256 (the map alone): rp = padded_rank, 8 ceil(r / 8)
    up to 64 and 64 ceil(r / 64) past it, runs as lowrank_slabs slabs of
    lowrank_slab_rank; slab s's column c (channel c // R, q = c % R) is the
    padded head's column slab_col(c, s), which is the plain index of
    (channel, R s + q) in the head reshaped [channels, rp]; the slabs cover
    the padded head once, and real_col sends their columns with q < r to
    every model column once (channel i r + q), the rest to -1."""
    c_in, c_out = 3, 2
    nch = c_in + c_out
    for rank in range(1, 257):
        rp = tfc.padded_rank(rank)
        r, slabs = tfc.lowrank_slab_rank(rank), tfc.lowrank_slabs(rank)
        assert r * slabs == rp and rank <= rp
        assert (rp == tfc._round_up(rank, 8) <= 64 if rank <= 64
                else r == 64 and rp == -(-rank // 64) * 64)
        grid = np.arange(rp * nch).reshape(nch, rp)
        seen = []
        for s in range(slabs):
            c = np.arange(r * nch)
            cols = slab_col(c, s, r, rp)
            assert np.array_equal(cols, grid[c // r, r * s + c % r])
            seen.append(cols)
        seen = np.concatenate(seen)
        assert np.array_equal(np.sort(seen), np.arange(rp * nch))
        rc = real_col(seen, rp, rank)
        ch, q = seen // rp, seen % rp
        assert np.array_equal(rc >= 0, q < rank)
        assert np.array_equal(rc[rc >= 0], (ch * rank + q)[rc >= 0])
        assert np.array_equal(np.sort(rc[rc >= 0]), np.arange(rank * nch))


def _slab_walks(o, rank, c_in, c_out, k, backward):
    """Both kernels' tile loops past rank 64, slab by slab on the head
    padded to rp (pad_head): msg, dx_src and dh summed over the slabs in
    slab order, t and dt [64, rp] slab beside slab."""
    rp = tfc.padded_rank(rank)
    w3p, b3p = _pad_head(o["w3"], o["b3"], rank)
    out, t, dt = {}, [], []
    for s in range(tfc.lowrank_slabs(rank)):
        got = _emulate(dict(o, w3=w3p, b3=b3p), 64, c_in, c_out, k, backward,
                       rp=rp, slab=s)
        for name in ("msg", "dx", "dh"):
            out[name] = out.get(name, 0.0) + got[name]
        t.append(got["t"])
        dt.append(got["dt"])
    return dict(out, t=np.concatenate(t, 1), dt=np.concatenate(dt, 1))


# (rank, c_in, c_out, K): 100 (two slabs, the second 36 real), 130 past
# both widths (three, the last 2 real), 256 past a depth of 128 (four, each
# chunk in stages of 64)
SLAB_WALKS = [(100, 9, 7, 33), (130, 5, 3, 20), (256, 3, 2, 140)]


@pytest.mark.parametrize("rank,c_in,c_out,k", SLAB_WALKS)
def test_slab_walks_match_plain_and_float64(rank, c_in, c_out, k):
    """B3's and B4's rows kernel's loops past rank 64 as the kernels run
    them (each slab the rank-64 walk on its columns, ChunkCopy reading them
    through slab_col, the slabs' msg, dx_src and dh added in turn) give the
    plain version's msg, t, dt, dx_src and dh at rank r (float64, the same
    sums in another order: 1e-12), t and dt zero at q >= r; the weights
    kernel's halves, each staging its slab of dt (U) or t (V) as [64][64],
    give the plain dw3 and db3 in the model's columns, each once."""
    o = _tile(rank, c_in, c_out, k, seed=rank + k)
    want = _plain(o, rank, c_in)
    rp = tfc.padded_rank(rank)
    fwd = _slab_walks(o, rank, c_in, c_out, k, backward=False)
    np.testing.assert_allclose(fwd["msg"], want["msg"], rtol=1e-12, atol=1e-9)
    bwd = _slab_walks(o, rank, c_in, c_out, k, backward=True)
    for name in ("t", "dt"):
        for got in (fwd, bwd) if name == "t" else (bwd,):
            np.testing.assert_allclose(got[name][:, :rank], want[name],
                                       rtol=1e-12, atol=1e-9, err_msg=name)
            assert not got[name][:, rank:].any(), name
    for name in ("dx", "dh"):
        np.testing.assert_allclose(bwd[name], want[name], rtol=1e-12,
                                   atol=1e-9, err_msg=name)
    # the weights kernel: thread t of a 128-column tile at n0 takes column
    # n0 + t; its half (t // 64) stages the 64 columns' slab of dt or t,
    # [64][64] from rows of rp, read at q % 64
    ncolp, ru = rp * (c_in + c_out), rp * c_in
    ncol = rank * (c_in + c_out)
    tiles, _ = tfc.lowrank_weight_tiles(k, c_in, c_out, rank)
    assert (tiles - 1) * 128 < ncolp <= tiles * 128
    out = np.full((k + 1, ncol), np.nan)
    for n0 in range(0, tiles * 128, 128):
        staged = {}
        for hh in range(2):
            c0 = n0 + 64 * hh
            if c0 < ncolp:
                vec = bwd["dt"] if c0 < ru else bwd["t"]
                staged[hh] = vec[:, c0 % rp:c0 % rp + 64]
        for tid in range(128):
            col = n0 + tid
            if col >= ncolp:
                continue
            ch = (col if col < ru else col - ru) // rp
            fac = o["x"][:, ch] if col < ru else o["d"][:, ch]
            duv = fac * staged[tid // 64][:, col % rp % 64]
            rc = real_col(col, rp, rank)
            if rc < 0:
                assert not duv.any()
                continue
            assert np.isnan(out[:, rc]).all()  # each column once
            out[:k, rc], out[k, rc] = o["h"].T @ duv, duv.sum()
    np.testing.assert_allclose(out[:k], o["h"].T @ want["duv"], rtol=1e-12,
                               atol=1e-9)
    np.testing.assert_allclose(out[k], want["duv"].sum(0), rtol=1e-12,
                               atol=1e-9)


@pytest.mark.parametrize("k", [48, 17, 64])
def test_weights_kernel_split_products_give_dw3(k):
    """The weights kernel's three passes h^T d1 + h^T d2 + h^T d3 over duv's
    exact split equal h^T duv (float64: each bf16 x bf16 product is exact),
    and db3 is summed from duv itself."""
    rank, c = 16, 12
    o = _tile(rank, c, c, k, seed=k)
    h = torch.as_tensor(o["h"], dtype=torch.float32).to(torch.bfloat16).double()
    duv = torch.as_tensor(_plain(o, rank, c)["duv"], dtype=torch.float32)
    parts = _split3(duv)
    got = sum(h.t() @ d.double() for d in parts)
    torch.testing.assert_close(got, h.t() @ duv.double(), rtol=1e-13,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# shared memory of every layout


# (K, c_in, c_out): the top corner up to 128, 256 everywhere, each wall
# alone (K; both widths; c_in; c_out), 129 and widths apart past 128
CORNERS = [(128, 128, 128), (256, 256, 256), (256, 48, 48), (48, 256, 256),
           (64, 256, 48), (72, 40, 256), (129, 129, 129), (200, 136, 250),
           (256, 1, 256), (1, 256, 1)]


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,c_in,c_out", CORNERS)
def test_lowrank_layouts_fit_shared_memory(dt, k, c_in, c_out):
    """Every B3/B4 kernel's layout (``lowrank_smem_bytes``: B3, B4's rows
    and weights kernels) fits the 227 KB a block may take at every rank
    1-256 (past 64 the rank-64 layout: one slab at a time), in both types;
    the bfloat16 weights kernel keeps its two sets of staged operands
    wherever they fit."""
    for rank in range(1, 257):
        for kernel in ("fwd", "rows", "weights"):
            got = tfc.lowrank_smem_bytes(dt, k, c_in, c_out, rank, kernel)
            assert 0 < got <= tfc.SMEM_MAX, (kernel, rank, got)
            if rank > 64:
                assert got == tfc.lowrank_smem_bytes(dt, k, c_in, c_out, 64,
                                                     kernel)
        if dt == torch.bfloat16:
            sets = 2 * 3 * 128 * 64
            one = (2 * 64 * 64 + 2 * 64 * (c_in + c_out)
                   + 2 * 4 * 64 * tfc.lowrank_slab_rank(rank))
            two = sets + 2 * one <= tfc.SMEM_MAX
            assert tfc.lowrank_smem_bytes(dt, k, c_in, c_out, rank,
                                          "weights") == sets + (2 if two else 1) * one


def test_lowrank_layouts_up_to_128_are_unchanged():
    """Up to widths and K of 128 the layouts are those the kernels had
    there before the width-256 ones (csrc headers: bfloat16 B3 70 KB at
    width 48, K 48 and 183 KB at 128; B4 rows 65 KB at width 48, rank 16
    and 151 KB at 128, rank 64; the float32 B3 and B4 rows 111 KB and 198
    KB; the float32 weights kernel 102 / 110 / 127 KB at ranks 16 / 32 /
    64; the bfloat16 one with two sets)."""
    bf, f32 = torch.bfloat16, torch.float32
    want = {(bf, 48, 16, "fwd"): 69_888, (bf, 128, 64, "fwd"): 182_528,
            (bf, 48, 16, "rows"): 65_280, (bf, 128, 64, "rows"): 151_296,
            (bf, 128, 64, "weights"): 196_608, (bf, 48, 16, "weights"): 106_496,
            (f32, 48, 16, "fwd"): 111_488, (f32, 128, 64, "fwd"): 197_504,
            (f32, 48, 16, "rows"): 111_488, (f32, 128, 64, "rows"): 197_504,
            (f32, 48, 16, "weights"): 102_912, (f32, 48, 32, "weights"): 111_104,
            (f32, 48, 64, "weights"): 127_488}
    for (dt, c, rank, kernel), b in want.items():
        assert tfc.lowrank_smem_bytes(dt, c, c, c, rank, kernel) == b


# ---------------------------------------------------------------------------
# the wrappers refuse what the kernels do not take, before any launch


def _small(rank=16, c=8, k=6):
    rng = np.random.default_rng(4)
    recv = np.sort(rng.integers(0, 100, 300)).astype(np.int32)
    send = rng.integers(0, 100, 300).astype(np.int32)
    blocks = tfc.build_scatter_blocks(recv, send, 100, quantum=64)
    slots = len(blocks.senders_perm)
    ncol = 2 * rank * c
    bf = lambda a: torch.as_tensor(a, dtype=torch.float32).bfloat16()  # noqa: E731
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    s = blocks.compact_s.to("cpu")
    fwd = (bf(rng.normal(size=(slots, k))), bf(rng.normal(size=(100, c))),
           torch.as_tensor(blocks.senders_perm), bf(rng.normal(size=(k, ncol))),
           f32(rng.normal(size=ncol)), s)
    bwd = (f32(rng.normal(size=(blocks.n_pad, c))), fwd[0],
           bf(rng.normal(size=(slots, c))), fwd[3], fwd[4], s)
    return fwd, bwd, dict(c_in=c, c_out=c, rank=rank, rows_blk=64,
                          blk=blocks.blk)


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("bad,match", [
    ({"rank": 257}, "rank=257"), ({"rank": 0}, "rank=0"),
    ({"c_out": 257}, "c_out=257 outside the kernel's 1..256"),
    ({"c_in": 0}, "c_in=0"),
    ({"rows_blk": 16}, "rows_blk=16"), ({"blk": 32}, "blk=32")])
def test_lowrank_wrappers_refuse_geometry_before_launch(which, bad, match):
    fwd, bwd, kw = _small()
    fn, args = ((tfc.fused_edge_conv_lowrank_cuda, fwd) if which == "fwd"
                else (tfc.fused_edge_conv_lowrank_bwd_cuda, bwd))
    with pytest.raises(ValueError, match=match):
        fn(*args, **{**kw, **bad})


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_lowrank_wrappers_refuse_k_past_64_and_cpu_tensors(which):
    """K past the kernels' 256 (the name is from when they stopped at 64) and
    CPU tensors are refused before any launch."""
    fwd, bwd, kw = _small(k=257)
    fn, args = ((tfc.fused_edge_conv_lowrank_cuda, fwd) if which == "fwd"
                else (tfc.fused_edge_conv_lowrank_bwd_cuda, bwd))
    with pytest.raises(ValueError, match="K=257 outside the kernel's 1..256"):
        fn(*args, **kw)
    fwd, bwd, kw = _small()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fn(*(fwd if which == "fwd" else bwd), **kw)
