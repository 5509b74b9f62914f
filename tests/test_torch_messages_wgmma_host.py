"""Host-side pieces of B5's float32-exact tensor-core design
(csrc/fused_edge_messages_wgmma.cu on csrc/f32_wgmma.cuh and
csrc/messages_wgmma.cuh), on the CPU: the design it reports, the exact
three-part bf16 split of float32 values (``split3``), the stage image the
wrapper builds of w3 and b3 (``stage_image``, in the float32 B1's column
chunks of c_out, past a c_in of 128 in stages of 32 deep) and its inverse,
a numpy emulation of one tile's loop (X's parts as register-A fragments,
or past a c_in of 128 split into shared memory and read a stage of 32 at a
time; a pass over k per column chunk, the six products of the split parts
per k, the per-k float32 weighting by the h tile, the accumulator map of
the stores) against ``fused_edge_messages_plain`` and a float64 reference,
at widths and K up to 256, the kernel's shared memory at every width, and
the wrapper refusing what the kernel does not take."""

import numpy as np
import pytest
import torch

from fast_eng_super_resolution_tpu_torch.ops import fused_conv, pallas_mp

THREADS = np.arange(128)[:, None]   # a warpgroup's threads


def a_row(t, v):
    """messages_wgmma.cuh a_row: the row of A fragment value v of thread t."""
    return 16 * (t // 32) + (t % 32) // 4 + 8 * ((v >> 1) & 1)


def a_col(t, v):
    """messages_wgmma.cuh a_col: its column within the k16 step."""
    return 2 * (t % 4) + (v & 1) + 8 * (v >> 2)


def acc_row(t, j):
    """wgmma_tile.cuh acc_row."""
    return 16 * (t // 32) + (t % 32) // 4 + 8 * ((j >> 1) & 1)


def acc_col(t, j):
    """wgmma_tile.cuh acc_col."""
    return 8 * (j >> 2) + 2 * (t % 4) + (j & 1)


def kmajor(r, d, depth):
    """wgmma_tile.cuh kmajor: offset of (r, d) in a K-major operand."""
    return (r >> 3) * (depth << 3) + (d >> 3) * 64 + (r & 7) * 8 + (d & 7)


def _round_up(v, m):
    return -(-v // m) * m


def test_design_is_wgmma():
    assert pallas_mp.design() == "wgmma"


def _values(kind: str, n: int = 200_000) -> torch.Tensor:
    rng = np.random.default_rng(["normal", "tiny", "huge", "negative"].index(kind))
    lo, hi = {"normal": (-30, 30), "tiny": (-100, -80), "huge": (100, 127),
              "negative": (-60, 60)}[kind]
    # full 24-bit significands, so that all three parts carry bits
    mant = 1.0 + rng.integers(0, 1 << 23, n) / float(1 << 23)
    v = mant * np.exp2(rng.integers(lo, hi, n).astype(np.float64))
    if kind == "huge":
        v = np.minimum(v, 3.38e38)
    sign = -1.0 if kind == "negative" else rng.choice([-1.0, 1.0], n)
    return torch.as_tensor(sign * v, dtype=torch.float32)


@pytest.mark.parametrize("kind", ["normal", "tiny", "huge", "negative"])
def test_split3_is_exact(kind):
    """v1 + v2 + v3 == v exactly (in float64) for values of every scale
    from 2^-100 (about 1e-30) to 3.38e38, of both signs; each part is a
    bf16 value and the third carries bits for most values."""
    v = _values(kind)
    parts = pallas_mp.split3(v)
    for p in parts:
        assert p.dtype == torch.bfloat16 and torch.isfinite(p.float()).all()
    total = sum(p.double() for p in parts)
    assert torch.equal(total, v.double())
    assert (parts[2] != 0).float().mean() > 0.5
    # two parts would not do: 16 of float32's 24 significant bits
    assert (parts[0].double() + parts[1].double() != v.double()).float().mean() > 0.5


def test_split3_loses_bits_only_in_the_subnormal_range():
    """Below float32's smallest normal (1.18e-38) bf16's parts are
    subnormal too and the lowest part loses bits: at 1e-38 the split is off
    by at most 2^-133 (about 9e-41), not exact.  The kernel's operands (edge
    features, weights) never come near that range."""
    v = torch.linspace(0.9e-38, 1.1e-38, 10_001, dtype=torch.float32)
    total = sum(p.double() for p in pallas_mp.split3(v))
    err = (total - v.double()).abs()
    assert err.max() <= 2.0 ** -133
    assert (err > 0).any()


def _weights(k, c_in, c_out, seed):
    rng = np.random.default_rng(seed)
    w3 = torch.as_tensor(rng.normal(size=(k, c_in * c_out)) * 0.2,
                         dtype=torch.float32)
    b3 = torch.as_tensor(rng.normal(size=(c_in * c_out,)) * 0.1,
                         dtype=torch.float32)
    return w3, b3


def _image_parts(image, c_in, c_out, chunk=None):
    """The inverse of stage_image's layout: [K+1, 3, chunks n, dp] float64
    (one chunk's [K+1, 3, n, dp] if ``chunk`` is given), read element by
    element at the K-major offsets the kernel's descriptor reads, stage (c
    (K+1) + k) slices + l holding columns c n .. c n + n - 1 of W~_k at
    depths l sd .. l sd + sd - 1 (one slice up to a c_in of 128)."""
    chunks, n = fused_conv.f32_chunks(c_out, c_in)
    dp, sd = fused_conv.f32_depth(c_in)
    slices = dp // sd
    k1 = image.shape[0] // (chunks * slices)
    flat = image.reshape(chunks, k1, slices, 3, n * sd)
    o, i = np.meshgrid(np.arange(n), np.arange(sd), indexing="ij")
    at = kmajor(o, i, sd)

    def one(c):
        return np.concatenate([flat[c, :, l].double().numpy()[:, :, at]
                               for l in range(slices)], axis=3)
    if chunk is not None:
        return one(chunk)
    return np.concatenate([one(c) for c in range(chunks)], axis=2)


# the widths past 64 take several column chunks (f32_chunks: 4 of 32 at
# c_in 65-128 and c_out past 96, 1 of 8 at c_out 8) or a depth past 64;
# past 128: c_out in chunks of up to 64 (5 of 56 at 250), c_in past 128 in
# stages of 32 deep (dp 160 at 129 and 136, 224 at 200, 256)
@pytest.mark.parametrize("k", [1, 48, 128])
@pytest.mark.parametrize("c_in,c_out", [(1, 1), (5, 7), (24, 24), (48, 48),
                                        (64, 64), (24, 5), (128, 128),
                                        (65, 127), (100, 8), (48, 128),
                                        (256, 256), (129, 129), (200, 72),
                                        (136, 250), (48, 250)])
def test_stage_image_inverse_recovers_w3_and_b3(k, c_in, c_out):
    """Stage (c (K+1) + k) slices + l of the image is column chunk c of
    W~_k = w3[k] (b3 for k = K) as c_in x c_out at depths l sd .., its
    three parts laid out as K-major B operands [n, sd]: reading the image
    back through kmajor and summing the parts gives w3 and b3 bit for bit,
    and the padding (o >= c_out, i >= c_in) is zero.  One chunk (c_out <=
    64 at c_in <= 64) is the image of [np, dp] operands, np = c_out
    rounded up to 8; up to a c_in of 128 one slice, sd = dp."""
    w3, b3 = _weights(k, c_in, c_out, seed=k + c_in)
    image = pallas_mp.stage_image(w3, b3, c_in)
    chunks, n = fused_conv.f32_chunks(c_out, c_in)
    dp, sd = fused_conv.f32_depth(c_in)
    if c_in <= 64 and c_out <= 64:
        assert (chunks, n) == (1, _round_up(c_out, 8))
    if c_in <= 128:
        assert sd == dp == _round_up(c_in, 16)
    else:
        assert sd == 32 and dp == _round_up(c_in, 32) and n <= 64
    assert image.dtype == torch.bfloat16 and image.is_contiguous()
    assert image.shape == (chunks * (k + 1) * (dp // sd), 3, n // 8, sd // 8,
                           8, 8)
    assert image.numel() == fused_conv.image_numel(k, c_out, c_in)
    # one stage is 3 n sd bf16 values: a multiple of 16 bytes (bulk copy),
    # within 24 KB
    assert (3 * n * sd * 2) % 16 == 0 and 3 * n * sd * 2 <= 24 * 1024
    parts = _image_parts(image, c_in, c_out)          # [K+1, 3, o, i]
    assert not parts[:, :, c_out:, :].any() and not parts[:, :, :, c_in:].any()
    got = parts.sum(1)[:, :c_out, :c_in].transpose(0, 2, 1)  # [K+1, i, o]
    want = torch.cat([w3, b3[None]]).reshape(k + 1, c_in, c_out).double()
    assert np.array_equal(got, want.numpy())
    for p, ref in zip(range(3), pallas_mp.split3(torch.cat([w3, b3[None]]))):
        ref = ref.double().reshape(k + 1, c_in, c_out).numpy().transpose(0, 2, 1)
        assert np.array_equal(parts[:, p, :c_out, :c_in], ref)


def test_layout_fits_shared_memory():
    """The kernel's shared memory (``pallas_mp.smem_bytes``, the mirror of
    csrc/fused_edge_messages_wgmma.cu's Layout, held to the library on the
    card by chip_smoke.py) stays within the 227 KB a block may take
    (``fused_conv.SMEM_MAX``) at every c_in and c_out 1..256 at K 128 and
    256, the largest K of the layouts with two h tiles per consumer and
    with one (the bytes grow with K).  Up to widths and K of 128 it is
    the layout of two consumers with two h tiles each and one stage of c_in
    rounded up to 16; the totals are those the source's header gives."""
    for k in (128, 256):
        for c_in in range(1, 257):
            for c_out in range(1, 257):
                b = pallas_mp.smem_bytes(k, c_in, c_out)
                assert b <= fused_conv.SMEM_MAX, (k, c_in, c_out, b)
    for k, c_in, c_out in ((1, 1, 1), (48, 48, 48), (128, 128, 128),
                           (128, 100, 8), (17, 65, 127), (128, 48, 128)):
        _, n = fused_conv.f32_chunks(c_out, c_in)
        dp = _round_up(c_in, 16)
        assert pallas_mp.smem_bytes(k, c_in, c_out) == (
            128 + 4 * 3 * 2 * n * dp + 4 * 2 * 2 * 64 * ((k + 1) | 1))
    # K 256 at c_in 48: 192 KB; at c_in 65..128: 225 KB; K 128 and 256 at
    # c_in = c_out = 256: 209 and 208 KB
    assert pallas_mp.smem_bytes(256, 48, 200) == 196_224
    assert max(pallas_mp.smem_bytes(256, c, 256) for c in range(65, 129)) \
        == 230_016
    assert pallas_mp.smem_bytes(128, 256, 256) == 213_632
    assert pallas_mp.smem_bytes(256, 256, 256) == 213_376


def test_a_fragment_map_covers_each_element_once():
    """The 128 threads' 8 values of an A fragment hold each of the 64 x 16
    elements once, and a thread's rows are its accumulator's rows."""
    v = np.arange(8)[None, :]
    cells = a_row(THREADS, v) * 16 + a_col(THREADS, v)
    assert np.array_equal(np.sort(cells.ravel()), np.arange(64 * 16))
    j = np.arange(24)[None, :]
    assert set(np.unique(acc_row(THREADS, j))) == set(range(64))
    for t in range(128):
        assert set(a_row(t, np.arange(8))) == set(acc_row(t, np.arange(24)))


def _split3_np(a):
    return [p.double().numpy() for p in
            pallas_mp.split3(torch.as_tensor(a, dtype=torch.float32))]


def _emulate_tile(h, x, image, e0, n, k, c_in, c_out):
    """One consumer warpgroup's tile as the kernel runs it, thread by
    thread.  X's parts (rows past n and columns past c_in zero) once per
    tile: up to a c_in of 128 loaded into register fragments, past it split
    eight values at a time into shared memory at the K-major offsets of
    [64, dp] operands (put_split8) and read by a product a stage of 32 deep
    at a time (DeepWalk: the descriptor 32 columns on per slice).  Then per
    column chunk a pass over k: the six products of the parts (the
    smallest first, each exact: float64 sums of bf16 products), weighted
    by h~[row, k] from the h tile in float32 into each thread's accumulator
    values, then stored through the accumulator map at the chunk's
    columns.  Returns the tile's [n, c_out]."""
    chunks, nc = fused_conv.f32_chunks(c_out, c_in)
    dp, sd = fused_conv.f32_depth(c_in)
    half = nc // 2
    v = np.arange(8)[None, :]
    xt = np.zeros((64, dp), np.float32)
    xt[:n, :c_in] = x[e0:e0 + n]
    # the A operand each part stands for, [64, dp]
    a_full = np.zeros((3, 64, dp))
    if c_in <= 128:
        # registers: the kernel loads x[e0 + a_row, 16 s + a_col] per step s
        for s in range(dp // 16):
            rows, cols = a_row(THREADS, v) + 0 * v, 16 * s + a_col(THREADS, v)
            for p, part in enumerate(_split3_np(xt[rows, cols])):
                a_full[p, rows, cols] = part
    else:
        # shared memory: thread q of the warpgroup splits row q // (dp / 8),
        # columns 8 (q % (dp / 8)) .. + 7, into the three parts at kmajor
        a_sm = np.zeros((3, 64 * dp))
        for q in range(64 * dp // 8):
            row, d = divmod(q, dp // 8)
            cols = 8 * d + np.arange(8)
            for p, part in enumerate(_split3_np(xt[row, cols])):
                a_sm[p, kmajor(row, cols, dp)] = part
        # slice l's product reads columns 32 l .. 32 l + 31 through the
        # descriptor at 32 l
        r, c = np.meshgrid(np.arange(64), np.arange(dp), indexing="ij")
        a_full = a_sm[:, kmajor(r, c, dp)]
    # a ragged tile's h rows past n keep what the tile before left there
    # (NaN here; past K 128 the one h tile, refilled after each tile's
    # walk): their X rows are zero and their sums are never stored
    hs = np.full((64, k + 1), np.nan, np.float32)
    hs[:n, :k] = h[e0:e0 + n]
    hs[:, k] = 1.0
    j = np.arange(half)[None, :]
    rows_j, cols_j = acc_row(THREADS, j), acc_col(THREADS, j) + 0 * THREADS
    order = [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]  # (X, W) parts
    out = np.full((64, c_out), np.nan, np.float32)
    for c in range(chunks):
        w = _image_parts(image, c_in, c_out, c)     # [K+1, 3, nc, dp]
        # P_k for every k: the six products over the depth, float64
        p = sum((w[:, wp].reshape(-1, dp) @ a_full[xp].T).reshape(k + 1, nc, 64)
                for xp, wp in order).transpose(0, 2, 1)
        m = np.zeros((128, half), np.float32)
        for kk in range(k + 1):
            acc = p[kk][rows_j, cols_j].astype(np.float32)
            m = (m + hs[rows_j, kk] * acc).astype(np.float32)
        col = c * nc + cols_j
        ok = col < c_out
        out[rows_j[ok], col[ok]] = m[ok]
    assert not np.isnan(out[:n]).any()
    return out[:n]


def _operands(e, k, c_in, c_out, seed):
    rng = np.random.default_rng(seed)
    h = np.maximum(rng.normal(size=(e, k)), 0).astype(np.float32)
    x = rng.normal(size=(e, c_in)).astype(np.float32)
    w3, b3 = _weights(k, c_in, c_out, seed + 1)
    return h, x, w3, b3


@pytest.mark.parametrize("k", [48, 128])
@pytest.mark.parametrize("e", [1, 63, 64, 65, 200])
def test_tile_loop_matches_plain_and_float64(e, k):
    """The kernel's loop over E's 64-edge tiles (the last one ragged), as
    emulated above, against ``fused_edge_messages_plain`` (float32) and a
    float64 reference: within 1e-6 of the max, as float32's own error."""
    c = 48
    h, x, w3, b3 = _operands(e, k, c, c, seed=e + k)
    image = pallas_mp.stage_image(w3, b3, c)
    got = np.concatenate([
        _emulate_tile(h, x, image, e0, min(64, e - e0), k, c, c)
        for e0 in range(0, e, 64)])
    plain = pallas_mp.fused_edge_messages_plain(
        torch.as_tensor(h), torch.as_tensor(x), w3, b3).numpy()
    w = (h.astype(np.float64) @ w3.double().numpy()
         + b3.double().numpy()).reshape(e, c, c)
    ref = np.einsum("ei,eio->eo", x.astype(np.float64), w)
    top = np.abs(ref).max()
    assert got.shape == plain.shape == (e, c)
    assert np.abs(got - ref).max() <= 1e-6 * top
    assert np.abs(got - plain).max() <= 1e-6 * top


# past 128: X's parts in shared memory with two h tiles (200, 72 at K
# 128), with one h tile (256 at K 256), and in registers with one h tile
# (48, 136 at K 256: three column chunks of 48)
@pytest.mark.parametrize("c_in,c_out,k", [(5, 7, 3), (64, 64, 17), (1, 1, 1),
                                          (24, 40, 48), (128, 128, 128),
                                          (65, 127, 128), (100, 8, 48),
                                          (256, 256, 256), (200, 72, 128),
                                          (48, 136, 256)])
def test_tile_loop_at_other_widths(c_in, c_out, k):
    """Widths that are not multiples of 8 or 16 (padded rows and depth of
    the operands), past 64 (four column chunks of 32 at c_in 65-128; one
    chunk of 8 at a depth of 112), past 128 (the layouts of the deep walk
    and of one h tile) and the widest: against the plain version and
    float64, within 1e-6 of the max."""
    e = 70
    h, x, w3, b3 = _operands(e, k, c_in, c_out, seed=c_in + c_out + k)
    image = pallas_mp.stage_image(w3, b3, c_in)
    got = np.concatenate([
        _emulate_tile(h, x, image, e0, min(64, e - e0), k, c_in, c_out)
        for e0 in range(0, e, 64)])
    plain = pallas_mp.fused_edge_messages_plain(
        torch.as_tensor(h), torch.as_tensor(x), w3, b3).numpy()
    w = (h.astype(np.float64) @ w3.double().numpy()
         + b3.double().numpy()).reshape(e, c_in, c_out)
    ref = np.einsum("ei,eio->eo", x.astype(np.float64), w)
    top = np.abs(ref).max()
    assert got.shape == plain.shape == (e, c_out)
    assert np.abs(got - ref).max() <= 1e-6 * top
    assert np.abs(got - plain).max() <= 1e-6 * top


def test_three_products_would_not_be_float32_exact():
    """Why six products: with only X1 W1, X1 W2 and X2 W1 (order >= 2^-8)
    the error grows well past float32's own; the six of order >= 2^-16
    keep it at float32's level (both against float64)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(200, 48)).astype(np.float32)
    w = rng.normal(size=(48, 48)).astype(np.float32)
    xs, ws = _split3_np(x), _split3_np(w)
    ref = x.astype(np.float64) @ w.astype(np.float64)
    six = sum(xs[a] @ ws[b] for a, b in [(2, 0), (1, 1), (0, 2), (1, 0),
                                          (0, 1), (0, 0)])
    three = sum(xs[a] @ ws[b] for a, b in [(1, 0), (0, 1), (0, 0)])
    f32 = (x @ w).astype(np.float64)
    top = np.abs(ref).max()
    err = {name: np.abs(v - ref).max() / top
           for name, v in (("six", six), ("three", three), ("f32", f32))}
    assert err["six"] <= 2 * err["f32"] + 1e-7
    assert err["three"] > 5 * err["f32"]


# ---------------------------------------------------------------------------
# the wrapper refuses what the kernel does not take, before any launch


def _cpu(e=40, k=6, c_in=8, c_out=8):
    h, x, w3, b3 = _operands(e, k, c_in, c_out, seed=3)
    return torch.as_tensor(h), torch.as_tensor(x), w3, b3


# (shape, one launch's refusal, named as the kernel names it): past 256 the
# wrapper runs pieces, so 257 in K, c_in or c_out gets as far as the
# device check, while one launch still refuses it
@pytest.mark.parametrize("shape,match", [
    pytest.param(dict(k=257), "K=257 outside the kernel's 1..256",
                 id="shape0-K=257 outside the kernel's 1..256"),
    pytest.param(dict(c_in=257, c_out=2), "c_in=257 outside 1..256",
                 id="shape1-c_in=257 outside 1..256"),
    pytest.param(dict(c_in=2, c_out=257),
                 "c_out=257 outside the kernel's 1..256",
                 id="shape2-c_out=257 outside the kernel's 1..256")])
def test_wrapper_refuses_geometry(shape, match):
    """One launch refuses K, c_in or c_out past 256, naming the limit, before
    it looks for a card; the wrapper runs such a width as pieces, so it
    gets as far as the device check, before any launch."""
    with pytest.raises(ValueError, match=match):
        pallas_mp._messages_launch(*_cpu(**shape))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pallas_mp.fused_edge_messages_cuda(*_cpu(**shape))


def test_wrapper_refuses_cpu_tensors_and_ragged_w3():
    h, x, w3, b3 = _cpu()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pallas_mp.fused_edge_messages_cuda(h, x, w3, b3)
    with pytest.raises(ValueError, match="not dividing"):
        pallas_mp.fused_edge_messages_cuda(h, x, w3[:, :-1].contiguous(),
                                           b3[:-1].contiguous())
    with pytest.raises(ValueError, match="2-D"):
        pallas_mp.fused_edge_messages_cuda(h[None], x, w3, b3)
