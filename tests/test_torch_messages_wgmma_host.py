"""Host-side pieces of B5's float32-exact tensor-core design
(csrc/fused_edge_messages_wgmma.cu on csrc/f32_wgmma.cuh and
csrc/messages_wgmma.cuh), on the CPU: the design it reports, the exact
three-part bf16 split of float32 values (``split3``), the stage image the
wrapper builds of w3 and b3 (``stage_image``, in the float32 B1's column
chunks of c_out) and its inverse, a numpy emulation of one tile's loop (the
register-A fragment map, a pass over k per column chunk, the six products
of the split parts per k, the per-k float32 weighting by h, the
accumulator map of the stores) against ``fused_edge_messages_plain`` and a
float64 reference, at widths and K up to 128, and the wrapper refusing
what the kernel does not take."""

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


def _image_parts(image, c_in, c_out):
    """The inverse of stage_image's layout: [K+1, 3, chunks n, dp] float64,
    read element by element at the K-major offsets the kernel's descriptor
    reads, stage c (K+1) + k holding columns c n .. c n + n - 1 of W~_k."""
    chunks, n = fused_conv.f32_chunks(c_out, c_in)
    k1 = image.shape[0] // chunks
    dp = _round_up(c_in, 16)
    flat = image.reshape(chunks, k1, 3, n * dp).double().numpy()
    o, i = np.meshgrid(np.arange(n), np.arange(dp), indexing="ij")
    return np.concatenate([flat[c][:, :, kmajor(o, i, dp)]
                           for c in range(chunks)], axis=2)


# the widths past 64 take several column chunks (f32_chunks: 4 of 32 at
# c_in 65-128 and c_out past 96, 1 of 8 at c_out 8) or a depth past 64
@pytest.mark.parametrize("k", [1, 48, 128])
@pytest.mark.parametrize("c_in,c_out", [(1, 1), (5, 7), (24, 24), (48, 48),
                                        (64, 64), (24, 5), (128, 128),
                                        (65, 127), (100, 8), (48, 128)])
def test_stage_image_inverse_recovers_w3_and_b3(k, c_in, c_out):
    """Stage c (K+1) + k of the image is column chunk c of W~_k = w3[k] (b3
    for k = K) as c_in x c_out, its three parts laid out as K-major B
    operands [n, dp]: reading the image back through kmajor and summing the
    parts gives w3 and b3 bit for bit, and the padding (o >= c_out, i >=
    c_in) is zero.  One chunk (c_out <= 64 at c_in <= 64) is the image of
    [np, dp] operands, np = c_out rounded up to 8."""
    w3, b3 = _weights(k, c_in, c_out, seed=k + c_in)
    image = pallas_mp.stage_image(w3, b3, c_in)
    chunks, n = fused_conv.f32_chunks(c_out, c_in)
    dp = _round_up(c_in, 16)
    if c_in <= 64 and c_out <= 64:
        assert (chunks, n) == (1, _round_up(c_out, 8))
    assert image.dtype == torch.bfloat16 and image.is_contiguous()
    assert image.shape == (chunks * (k + 1), 3, n // 8, dp // 8, 8, 8)
    assert image.numel() == fused_conv.image_numel(k, c_out, c_in)
    # one stage is 3 n dp bf16 values: a multiple of 16 bytes (bulk copy),
    # within 24 KB
    assert (3 * n * dp * 2) % 16 == 0 and 3 * n * dp * 2 <= 24 * 1024
    parts = _image_parts(image, c_in, c_out)          # [K+1, 3, o, i]
    assert not parts[:, :, c_out:, :].any() and not parts[:, :, :, c_in:].any()
    got = parts.sum(1)[:, :c_out, :c_in].transpose(0, 2, 1)  # [K+1, i, o]
    want = torch.cat([w3, b3[None]]).reshape(k + 1, c_in, c_out).double()
    assert np.array_equal(got, want.numpy())
    for p, ref in zip(range(3), pallas_mp.split3(torch.cat([w3, b3[None]]))):
        ref = ref.double().reshape(k + 1, c_in, c_out).numpy().transpose(0, 2, 1)
        assert np.array_equal(parts[:, p, :c_out, :c_in], ref)


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
    thread: X's parts loaded into register fragments (rows past n and
    columns past c_in zero) once, then per column chunk a pass over k: the
    six products of the parts (the smallest first, each exact: float64
    sums of bf16 products), weighted by h~[row, k] in float32 into each
    thread's accumulator values, then stored through the accumulator map
    at the chunk's columns.  Returns the tile's [n, c_out]."""
    chunks, nc = fused_conv.f32_chunks(c_out, c_in)
    dp = _round_up(c_in, 16)
    steps = dp // 16
    half = nc // 2
    v = np.arange(8)[None, :]
    # registers: the kernel loads x[e0 + a_row, 16 s + a_col] per step s
    xa = np.zeros((3, steps, 128, 8))
    for s in range(steps):
        rows, cols = a_row(THREADS, v) + 0 * v, 16 * s + a_col(THREADS, v)
        ok = (rows < n) & (cols < c_in)
        vals = np.where(ok, x[np.minimum(e0 + rows, len(x) - 1),
                              np.minimum(cols, c_in - 1)], 0.0)
        for p, part in enumerate(_split3_np(vals)):
            xa[p, s] = part
    # the A operand each fragment set stands for, [64, 16] per (part, step)
    a_full = np.zeros((3, steps, 64, 16))
    a_full[:, :, a_row(THREADS, v) + 0 * v, a_col(THREADS, v) + 0 * THREADS] = xa
    # a ragged tile's h rows past n keep what the tile before left there
    # (NaN here): their X rows are zero and their sums are never stored
    hs = np.full((64, k + 1), np.nan, np.float32)
    hs[:n, :k] = h[e0:e0 + n]
    hs[:, k] = 1.0
    parts = _image_parts(image, c_in, c_out)   # [K+1, 3, chunks nc, dp]
    j = np.arange(half)[None, :]
    rows_j, cols_j = acc_row(THREADS, j), acc_col(THREADS, j) + 0 * THREADS
    order = [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]  # (X, W) parts
    out = np.full((64, c_out), np.nan, np.float32)
    for c in range(chunks):
        w = parts[:, :, c * nc:(c + 1) * nc]      # the chunk's stages
        m = np.zeros((128, half), np.float32)
        for kk in range(k + 1):
            p = np.zeros((64, nc))
            for xp, wp in order:
                for s in range(steps):
                    p += a_full[xp, s] @ w[kk, wp, :, 16 * s:16 * s + 16].T
            acc = p[rows_j, cols_j].astype(np.float32)
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


@pytest.mark.parametrize("c_in,c_out,k", [(5, 7, 3), (64, 64, 17), (1, 1, 1),
                                          (24, 40, 48), (128, 128, 128),
                                          (65, 127, 128), (100, 8, 48)])
def test_tile_loop_at_other_widths(c_in, c_out, k):
    """Widths that are not multiples of 8 or 16 (padded rows and depth of
    the operands), past 64 (four column chunks of 32 at c_in 65-128; one
    chunk of 8 at a depth of 112) and the widest: the same agreement."""
    e = 70
    h, x, w3, b3 = _operands(e, k, c_in, c_out, seed=c_in + c_out + k)
    image = pallas_mp.stage_image(w3, b3, c_in)
    got = np.concatenate([
        _emulate_tile(h, x, image, e0, min(64, e - e0), k, c_in, c_out)
        for e0 in range(0, e, 64)])
    w = (h.astype(np.float64) @ w3.double().numpy()
         + b3.double().numpy()).reshape(e, c_in, c_out)
    ref = np.einsum("ei,eio->eo", x.astype(np.float64), w)
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


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


@pytest.mark.parametrize("shape,match", [
    (dict(k=129), "K=129 outside the kernel's 1..128"),
    (dict(c_in=129, c_out=2), "c_in=129 outside 1..128"),
    (dict(c_in=2, c_out=129), "c_out=129 outside the kernel's 1..128")])
def test_wrapper_refuses_geometry(shape, match):
    """Past 128 (K, c_in or c_out) the wrapper raises before any launch,
    naming the limit."""
    with pytest.raises(ValueError, match=match):
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
