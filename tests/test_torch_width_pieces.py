"""B1, B2 and B5 past 256 as pieces (ops/fused_conv.py ``width_pieces``,
``weight_pieces``, ``fused_edge_conv_pieces``, ``fused_edge_conv_bwd_pieces``;
ops/pallas_mp.py ``fused_edge_messages_pieces``).

The piece plan covers each width once with pieces a launch takes; the
compositions, driven here with the plain versions as their pieces at a
small ``most``, give the plain whole; up to the piece size they make the
one call they are given, on the operands as they are; the plain versions
agree with the JAX package's Pallas kernels in interpret mode past 256;
and a width-320 KernelNN carried over from JAX gives JAX's fused forward.
The kernels themselves are held against their plain versions past 256 on
the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from conftest import make_random_graph
from fast_eng_super_resolution_tpu.core.graph import pad_graph
from fast_eng_super_resolution_tpu.models.kernelnn import KernelNN as JKernelNN
from fast_eng_super_resolution_tpu.ops import fused_conv as jfc
from fast_eng_super_resolution_tpu.ops.pallas_mp import (
    fused_edge_messages as jfem)
from fast_eng_super_resolution_tpu_torch.models.common import load_jax_tree
from fast_eng_super_resolution_tpu_torch.models.kernelnn import KernelNN
from fast_eng_super_resolution_tpu_torch.ops import fused_conv as tfc
from fast_eng_super_resolution_tpu_torch.ops import pallas_mp

# the compositions against the plain whole: the same float32 products,
# summed in other orders -> 1e-5 of each output's max
TOL = 1e-5
# the plain versions against the Pallas kernels: float32 sums in other
# orders; in bfloat16 JAX's 'repeat' layout also rounds each product to
# bf16 (tests/test_torch_fused_conv.py)
JAX_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SHAPES = [(40, 36, 20), (17, 50, 33)]  # (K, c_in, c_out), pieces of 16


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / np.abs(ref).max()


# ---------------------------------------------------------------------------
# the plan


@pytest.mark.parametrize("most", [16, 256])
def test_pieces_cover_each_width_once(most):
    """Each d up to 1 024 (16: up to 300) is covered by ceil(d / most)
    pieces in order, none overlapping, each at most ``most`` and a
    multiple of 8 but the last; up to ``most`` one piece of all of it."""
    for d in range(1, (1025 if most == 256 else 301)):
        pieces = tfc.width_pieces(d, most)
        if d <= most:
            assert pieces == [(0, d)]
        assert len(pieces) == -(-d // most)
        assert pieces[0][0] == 0 and pieces[-1][1] == d
        assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
        assert all(0 < e - s <= most for s, e in pieces)
        assert all((e - s) % 8 == 0 for s, e in pieces[:-1])
    assert tfc.width_pieces(320) == [(0, 160), (160, 320)]
    with pytest.raises(ValueError, match="multiple of 8"):
        tfc.width_pieces(40, 12)


def test_every_piece_up_to_1024_fits_a_block():
    """Every piece of every K, c_in and c_out up to 1 024 is a width that
    fits a block of each B1/B2 kernel (``conv_smem_bytes``) and of B5
    (``pallas_mp.smem_bytes``): each piece's width against the narrowest
    and the widest of the others, and every width past 256 reports its
    widest piece's instance."""
    widths = sorted({e - s for d in range(1, 1025)
                     for s, e in tfc.width_pieces(d)})
    assert max(widths) == 256
    kinds = [(torch.bfloat16, False), (torch.bfloat16, True),
             (torch.float32, False), (torch.float32, True)]
    for w in widths:
        for shape in ((w, w, w), (1, w, 256), (256, w, 1), (w, 256, 256),
                      (256, 256, w)):
            for dt, backward in kinds:
                assert tfc.conv_smem_bytes(dt, *shape, backward) \
                    <= tfc.SMEM_MAX, (shape, dt, backward)
            assert pallas_mp.smem_bytes(*shape) <= tfc.SMEM_MAX, shape
    for d in (257, 320, 512, 600, 1024):
        w = tfc.piece_width(d)
        for dt, backward in kinds:
            assert tfc.conv_smem_bytes(dt, d, d, d, backward) == \
                tfc.conv_smem_bytes(dt, w, w, w, backward)
        assert pallas_mp.smem_bytes(d, d, d) == pallas_mp.smem_bytes(w, w, w)
        assert tfc.wgmma_fwd_chunks(d, d, d) == tfc.wgmma_fwd_chunks(w, w, w)
        assert tfc.wgmma_rows_chunks(d, d, d) == tfc.wgmma_rows_chunks(w, w, w)
        assert tfc.f32_chunks(d, d) == tfc.f32_chunks(w, w)


def test_weight_pieces_rebuild_w3_with_b3_once():
    """The weight pieces of a 40 x 36 x 20 layer at pieces of 16 tile w3
    exactly, and b3 once (the first K piece's; zeros in the others)."""
    rng = np.random.default_rng(0)
    k, c_in, c_out = 40, 36, 20
    w3 = torch.as_tensor(rng.normal(size=(k, c_in * c_out)).astype(np.float32))
    b3 = torch.as_tensor(rng.normal(size=(c_in * c_out,)).astype(np.float32))
    w = torch.zeros(k, c_in, c_out)
    b = torch.zeros(c_in, c_out)
    seen = []
    for kp, ip, op, wp, bp in tfc.weight_pieces(w3, b3, c_in, c_out, 16):
        assert wp.is_contiguous() and bp.is_contiguous()
        w[kp[0]:kp[1], ip[0]:ip[1], op[0]:op[1]] += wp.reshape(
            kp[1] - kp[0], ip[1] - ip[0], op[1] - op[0])
        b[ip[0]:ip[1], op[0]:op[1]] += bp.reshape(ip[1] - ip[0], op[1] - op[0])
        seen.append((kp, ip, op))
    assert len(seen) == len(set(seen)) == 3 * 3 * 2
    assert seen == sorted(seen)  # K outermost, then c_in, then c_out
    torch.testing.assert_close(w.reshape(k, -1), w3, rtol=0, atol=0)
    torch.testing.assert_close(b.reshape(-1), b3, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the compositions with the plain versions as pieces


def _layer(k, c_in, c_out, seed, n=150, e=900):
    rng = np.random.default_rng(seed)
    recv = np.sort(rng.integers(0, n, e)).astype(np.int32)
    send = rng.integers(0, n, e).astype(np.int32)
    blocks = tfc.build_scatter_blocks(recv, send, n, quantum=64)
    slots = len(blocks.senders_perm)
    t = lambda *s, scale=1.0: torch.as_tensor(  # noqa: E731
        (rng.normal(size=s) * scale).astype(np.float32))
    return blocks, dict(h=torch.relu(t(slots, k)), x=t(n, c_in),
                        w3=t(k, c_in * c_out, scale=0.2),
                        b3=t(c_in * c_out, scale=0.1),
                        g=t(blocks.n_pad, c_out), x_src=t(slots, c_in))


def _s(blocks, compact):
    return (blocks.compact_s.to("cpu") if compact
            else torch.as_tensor(blocks.s_matrix))


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "dense"])
@pytest.mark.parametrize("gemm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,c_in,c_out", SHAPES)
def test_b1_pieces_give_the_plain_whole(k, c_in, c_out, gemm_dtype, compact):
    blocks, o = _layer(k, c_in, c_out, seed=k + c_in)
    kw = dict(c_in=c_in, c_out=c_out, rows_blk=64, blk=blocks.blk)
    args = (o["h"], o["x"], torch.as_tensor(blocks.senders_perm), o["w3"],
            o["b3"], _s(blocks, compact))
    ref = tfc.fused_edge_conv_plain(*args, gemm_dtype=gemm_dtype, **kw)
    got = tfc.fused_edge_conv_pieces(
        functools.partial(tfc.fused_edge_conv_plain, gemm_dtype=gemm_dtype),
        *args, most=16, **kw)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert _rel(got, ref) < TOL


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "dense"])
@pytest.mark.parametrize("gemm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,c_in,c_out", SHAPES)
def test_b2_pieces_give_the_plain_whole(k, c_in, c_out, gemm_dtype, compact):
    blocks, o = _layer(k, c_in, c_out, seed=k + c_out)
    kw = dict(c_in=c_in, c_out=c_out, rows_blk=64, blk=blocks.blk)
    args = (o["g"], o["h"], o["x_src"], o["w3"], o["b3"], _s(blocks, compact))
    ref = tfc.fused_edge_conv_bwd_plain(*args, gemm_dtype=gemm_dtype, **kw)
    got = tfc.fused_edge_conv_bwd_pieces(
        functools.partial(tfc.fused_edge_conv_bwd_plain,
                          gemm_dtype=gemm_dtype), *args, most=16, **kw)
    for name, a, r in zip(("dh", "dx_src", "dw3", "db3"), got, ref):
        assert a.shape == r.shape and a.dtype == torch.float32, name
        assert _rel(a, r) < TOL, name


@pytest.mark.parametrize("k,c_in,c_out", SHAPES)
def test_b5_pieces_give_the_plain_whole(k, c_in, c_out):
    rng = np.random.default_rng(k)
    e = 300
    ops = [torch.as_tensor(a.astype(np.float32)) for a in (
        np.maximum(rng.normal(size=(e, k)), 0), rng.normal(size=(e, c_in)),
        rng.normal(size=(k, c_in * c_out)) * 0.2,
        rng.normal(size=(c_in * c_out,)) * 0.1)]
    ref = pallas_mp.fused_edge_messages_plain(*ops)
    got = pallas_mp.fused_edge_messages_pieces(
        pallas_mp.fused_edge_messages_plain, *ops, most=16)
    assert got.shape == (e, c_out) and _rel(got, ref) < TOL
    # each piece's stage image, in the order the pieces run
    images = pallas_mp.piece_images(pallas_mp.stage_image, ops[2], ops[3],
                                    c_in, most=16)
    want = torch.cat([pallas_mp.stage_image(wp, bp, ip[1] - ip[0]).reshape(-1)
                      for _, ip, _, wp, bp in tfc.weight_pieces(
                          ops[2], ops[3], c_in, c_out, 16)])
    assert torch.equal(images, want)


def _recording(fn, calls):
    def launch(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)
    return launch


def test_one_piece_is_the_one_call_on_the_operands(monkeypatch):
    """Up to 256 each ``_cuda`` wrapper makes exactly one launch, on the
    very tensors it was handed (the parent's one launch); past it each
    composition makes one call per piece."""
    blocks, o = _layer(48, 40, 24, seed=1)
    sp, s = torch.as_tensor(blocks.senders_perm), _s(blocks, True)
    kw = dict(c_in=40, c_out=24, rows_blk=64, blk=blocks.blk)
    fwd = (o["h"], o["x"], sp, o["w3"], o["b3"], s)
    bwd = (o["g"], o["h"], o["x_src"], o["w3"], o["b3"], s)
    e = 100
    msg = (o["h"][:e], o["x_src"][:e], o["w3"], o["b3"])
    cases = ((tfc, "_fused_edge_conv_launch", tfc.fused_edge_conv_cuda,
              tfc.fused_edge_conv_pieces, tfc.fused_edge_conv_plain, fwd, kw),
             (tfc, "_fused_edge_conv_bwd_launch", tfc.fused_edge_conv_bwd_cuda,
              tfc.fused_edge_conv_bwd_pieces, tfc.fused_edge_conv_bwd_plain,
              bwd, kw),
             (pallas_mp, "_messages_launch", pallas_mp.fused_edge_messages_cuda,
              pallas_mp.fused_edge_messages_pieces,
              pallas_mp.fused_edge_messages_plain, msg, {}))
    for module, launch, wrapper, compose, plain, args, kwargs in cases:
        calls = []
        monkeypatch.setattr(module, launch, _recording(plain, calls))
        wrapper(*args, **kwargs)
        assert len(calls) == 1
        assert all(a is b for a, b in zip(calls[0][0], args))
        assert calls[0][1] == kwargs
        calls = []
        compose(_recording(plain, calls), *args, most=16, **kwargs)
        assert len(calls) == 3 * 3 * 2  # K 48, c_in 40, c_out 24 at 16


def test_cuda_wrappers_take_any_width_and_stop_at_cpu_tensors():
    """Past 256 the wrappers' geometry takes every width (as pieces); on
    CPU tensors they stop at the device check, before any launch."""
    tfc._check_geometry(torch.float32, 128, 64, 64, K=1024, c_in=600,
                        c_out=520)
    for dims in (dict(K=0, c_in=8, c_out=8), dict(K=8, c_in=8, c_out=0)):
        with pytest.raises(ValueError, match="=0 outside"):
            tfc._check_geometry(torch.float32, 128, 64, 64, **dims)
    blocks, o = _layer(264, 8, 8, seed=2)
    kw = dict(c_in=8, c_out=8, rows_blk=64, blk=blocks.blk)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tfc.fused_edge_conv_cuda(o["h"], o["x"],
                                 torch.as_tensor(blocks.senders_perm),
                                 o["w3"], o["b3"], _s(blocks, True), **kw)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pallas_mp.fused_edge_messages_cuda(o["h"][:64], o["x_src"][:64],
                                           o["w3"], o["b3"])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pallas_mp.stage_image_cuda(o["w3"], o["b3"], 8)


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels past 256


def _one_block_layer(k, c_in, c_out, seed):
    """A layer of one receiver block (64 nodes, 60 edges: one 64-slot
    block) at K x c_in x c_out."""
    rng = np.random.default_rng(seed)
    n, e = 64, 60
    recv = np.sort(rng.integers(0, n, e)).astype(np.int32)
    send = rng.integers(0, n, e).astype(np.int32)
    blocks = tfc.build_scatter_blocks(recv, send, n, quantum=64)
    assert blocks.num_blocks == 1 and blocks.blk == 64
    slots = len(blocks.senders_perm)
    x = rng.normal(size=(n, c_in)).astype(np.float32)
    return blocks, dict(
        h=(np.maximum(rng.normal(size=(slots, k)), 0) * .5).astype(np.float32),
        x=x, x_src=x[blocks.senders_perm],
        w3=(rng.normal(size=(k, c_in * c_out)) * .05).astype(np.float32),
        b3=(rng.normal(size=(c_in * c_out,)) * .1).astype(np.float32),
        g=rng.normal(size=(blocks.n_pad, c_out)).astype(np.float32))


PAST = (264, 272, 260)  # (K, c_in, c_out): two pieces of each


@pytest.mark.parametrize("gemm_dtype", ["float32", "bfloat16"])
def test_b1_past_256_matches_pallas(gemm_dtype):
    """B1's plain version, and its composition of plain pieces of 256,
    against the JAX package's Pallas kernel in interpret mode."""
    k, c_in, c_out = PAST
    blocks, o = _one_block_layer(k, c_in, c_out, seed=11)
    kw = dict(c_in=c_in, c_out=c_out, rows_blk=64, blk=blocks.blk)
    ref = np.asarray(jfc.fused_edge_conv(
        *(jnp.asarray(a) for a in (o["h"], o["x"], blocks.senders_perm,
                                   o["w3"], o["b3"], blocks.s_matrix)),
        gemm_dtype=gemm_dtype, interpret=True, **kw))
    t = torch.as_tensor
    args = (t(o["h"]), t(o["x"]), t(blocks.senders_perm), t(o["w3"]),
            t(o["b3"]), blocks.compact_s.to("cpu"))
    plain = functools.partial(tfc.fused_edge_conv_plain, gemm_dtype=gemm_dtype)
    assert _rel(plain(*args, **kw), ref) < JAX_TOL[gemm_dtype]
    assert _rel(tfc.fused_edge_conv_pieces(plain, *args, **kw), ref) \
        < JAX_TOL[gemm_dtype]


@pytest.mark.parametrize("gemm_dtype", ["float32", "bfloat16"])
def test_b2_past_256_matches_pallas(gemm_dtype):
    """B2's plain version, and its composition of plain pieces of 256,
    against the JAX package's Pallas backward in interpret mode, each
    gradient relative to its max."""
    k, c_in, c_out = PAST
    blocks, o = _one_block_layer(k, c_in, c_out, seed=12)
    kw = dict(c_in=c_in, c_out=c_out, rows_blk=64, blk=blocks.blk)
    ref = jfc.fused_edge_conv_bwd(
        *(jnp.asarray(a) for a in (o["g"], o["h"], o["x_src"], o["w3"],
                                   o["b3"], blocks.s_matrix)),
        gemm_dtype=gemm_dtype, interpret=True, **kw)
    t = torch.as_tensor
    args = (t(o["g"]), t(o["h"]), t(o["x_src"]), t(o["w3"]), t(o["b3"]),
            blocks.compact_s.to("cpu"))
    plain = functools.partial(tfc.fused_edge_conv_bwd_plain,
                              gemm_dtype=gemm_dtype)
    for got in (plain(*args, **kw),
                tfc.fused_edge_conv_bwd_pieces(plain, *args, **kw)):
        for name, a, r in zip(("dh", "dx_src", "dw3", "db3"), got, ref):
            assert tuple(a.shape) == r.shape, name
            assert _rel(a, r) < JAX_TOL[gemm_dtype], name


def test_b5_past_256_matches_pallas():
    """B5's plain version, and its composition of plain pieces of 256, at
    (K, c_in, c_out) = (264, 300, 260) against the JAX package's Pallas
    kernel in interpret mode, float32."""
    rng = np.random.default_rng(13)
    e, k, c_in, c_out = 40, 264, 300, 260
    ops = ((np.maximum(rng.normal(size=(e, k)), 0)).astype(np.float32),
           rng.normal(size=(e, c_in)).astype(np.float32),
           (rng.normal(size=(k, c_in * c_out)) * .05).astype(np.float32),
           (rng.normal(size=(c_in * c_out,)) * .1).astype(np.float32))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfem(*(jnp.asarray(a) for a in ops)))
    t = [torch.as_tensor(a) for a in ops]
    plain = pallas_mp.fused_edge_messages_plain
    assert _rel(plain(*t), ref) < JAX_TOL["float32"]
    assert _rel(pallas_mp.fused_edge_messages_pieces(plain, *t), ref) \
        < JAX_TOL["float32"]


def test_apply_fused_width_320_matches_jax():
    """Width 320 (K 320, depth 1, about 100 nodes), where the card's B1
    runs two pieces of 160 in each of K, c_in and c_out: the port's fused
    form (plain version on the CPU), its weights carried over from the JAX
    parameter tree by ``load_jax_tree``, against JAX's ``apply_fused`` with
    the Pallas kernel in interpret mode, float32, within 1e-5 of the
    max."""
    cfg = dict(width=320, ker_width=320, depth=1, in_width=4, out_width=4)
    model = JKernelNN(mode="edge3d", **cfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    model.init(jax.random.PRNGKey(7)))
    g = make_random_graph(np.random.default_rng(7), n=100, e=400)
    g = pad_graph(g["x"], g["y"], g["pos"], g["senders"], g["receivers"],
                  g["edge_attr"], 128, 512)
    ea_b, sp, s, rows_blk, blk = model.prepare_fused(
        g.senders, g.receivers, g.edge_attr, 128, g.edge_mask)
    ref = model.apply_fused(params, jnp.asarray(g.x), jnp.asarray(ea_b),
                            jnp.asarray(sp), jnp.asarray(s), rows_blk=rows_blk,
                            blk=blk, gemm_dtype="float32", interpret=True)
    port = KernelNN(**cfg)
    load_jax_tree(port, params)
    ea_t, sp_t, s_t, rb, bk = port.prepare_fused(
        g.senders, g.receivers, g.edge_attr, 128, g.edge_mask, compact=True)
    with torch.no_grad():
        got = port.apply_fused(torch.as_tensor(g.x), torch.as_tensor(ea_t),
                               torch.as_tensor(sp_t), s_t.to("cpu"),
                               rows_blk=rb, blk=bk, gemm_dtype="float32")
    assert got.shape == (128, 4)
    assert _rel(got.numpy(), ref) < TOL
