"""Fused edge-conditioned conv layer: message + scatter-mean in one kernel.

The hot op (reference NNConv_old message+aggregate, models/model.py:521-536)
is, per edge e with scalar attr a_e:

    W_e  = EdgeMLP(a_e).reshape(c_in, c_out)      # [E, w^2] matrices
    m_e  = x[sender(e)] @ W_e                     # per-edge bmm
    out_i = mean_{e: recv(e)=i} m_e               # scatter-mean

``fused_edge_conv`` computes one layer of it without ever storing W_e.  Its
operands come from a host-side (numpy) grouping of the receiver-sorted edges
into row blocks (``build_scatter_blocks``, identical to the JAX package's):
``rows_blk`` = 64 consecutive receiver nodes per block, each block padded to
a fixed ``blk`` slots, and the scatter-mean given as S (dense
[num_blocks*rows_blk, blk], or its ``CompactS`` generators).

On a CUDA tensor the layer launches a hand-written kernel on Hopper's
tensor cores (built with nvcc at first use, loaded with ctypes):
``csrc/fused_edge_conv_wgmma.cu`` for bfloat16, and for float32
``csrc/fused_edge_conv_f32_wgmma.cu``, exact to float32 through three-part
bf16 splits.  On a CPU tensor it runs the plain PyTorch version below, which
is the same function and the reference the kernels are checked against.
Nothing falls back from one to the other.  Training goes through
``FusedEdgeConv``, whose backward is ``csrc/fused_edge_conv_bwd_wgmma.cu``
or ``csrc/fused_edge_conv_bwd_f32_wgmma.cu`` (or its plain version,
``fused_edge_conv_bwd_plain``, on the CPU).  Models with rank-r factorized
edge kernels (``kernel_rank``) run ``fused_edge_conv_lowrank``, on the
tensor cores at every rank 1-256 (``csrc/fused_edge_conv_lowrank_wgmma.cu``
for bfloat16, ``csrc/fused_edge_conv_lowrank_f32_wgmma.cu`` for float32;
every rank runs at ``padded_rank``, its head padded with zeros, past 64 as
slabs of 64), and train through ``FusedEdgeConvLowrank``, whose backward is
``csrc/fused_edge_conv_lowrank_bwd_wgmma.cu`` or
``csrc/fused_edge_conv_lowrank_bwd_f32_wgmma.cu`` the same way.
``design`` names the design every launch runs.  One launch of B1-B5
(``ops/pallas_mp.py``) takes K, c_in and c_out up to 256 (B3 and B4 ranks up
to 256 too).  B1, B2 and B5 take any K, c_in and c_out: past 256 the
wrappers run pieces of at most 256 of each on the same instances
(``width_pieces``, ``weight_pieces``), their results added in a fixed order;
B3 and B4 refuse 257.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class CompactS:
    """Generator data for the dense S scatter blocks — 1/64th their bytes.

    S[b, r, c] = (slot_rows[b*blk+c] == r) * row_weight[b*rows_blk+r]; padding
    slots carry -1 and never match.  The CUDA kernel reads these generators
    directly and never builds S; ``expand_s`` gives the dense form.  Fields
    are numpy on the host and torch tensors after ``to``."""

    slot_rows: np.ndarray       # [num_blocks*blk] int32 row-in-block, -1 pad
    row_weight: np.ndarray      # [num_blocks*rows_blk] f32, 1/deg or 1

    def to(self, device) -> "CompactS":
        """The generators as torch tensors on ``device``."""
        return CompactS(torch.as_tensor(np.asarray(self.slot_rows), device=device),
                        torch.as_tensor(np.asarray(self.row_weight), device=device))


@dataclasses.dataclass(frozen=True)
class ScatterBlocks:
    """Host-precomputed, graph-static block structure (hashable aux: shapes
    only; arrays are numpy and passed as jit operands)."""

    edge_perm: np.ndarray       # [num_blocks*blk] int32 into original edges
    s_matrix: np.ndarray | None  # [num_blocks*rows_blk, blk] f32 (dense=True)
    senders_perm: np.ndarray    # [num_blocks*blk] int32 into nodes
    slot_mask: np.ndarray       # [num_blocks*blk] bool, False on padding
    compact_s: CompactS         # always built (tiny)
    rows_blk: int
    blk: int
    num_blocks: int
    n_nodes: int                # real node count (<= num_blocks*rows_blk)

    @property
    def n_pad(self) -> int:
        return self.num_blocks * self.rows_blk

    def train_aux(self) -> dict:
        """int32 operand dict for the differentiable fused layer (training).

        ``senders_dump``: sender id per slot, with padding slots redirected
        to a dump row at index n_nodes — the dx scatter-add runs as ONE
        unsorted segment sum over n_nodes+1 segments and the dump row is
        sliced off, so padding slots (senders_perm 0) cannot corrupt node
        0's gradient."""
        dump = np.where(self.slot_mask, self.senders_perm,
                        np.int32(self.n_nodes)).astype(np.int32)
        return {"senders_perm": self.senders_perm,
                "senders_dump": dump}


def build_scatter_blocks(receivers: np.ndarray, senders: np.ndarray,
                         n_nodes: int, edge_mask: np.ndarray | None = None,
                         rows_blk: int = 64, quantum: int = 256,
                         aggr: str = "mean",
                         max_s_bytes: int = 2 << 30,
                         dense: bool = True) -> ScatterBlocks:
    """Groups receiver-sorted edges into fixed-size row-block buckets.

    receivers MUST be ascending over real edges (pad_graph emits them so;
    asserted).  Padded/masked edges may appear anywhere — they are dropped
    here and re-padded per block with S-column zeros.
    """
    receivers = np.asarray(receivers, np.int64)
    senders = np.asarray(senders, np.int64)
    if edge_mask is not None:
        keep = np.asarray(edge_mask, bool)
        receivers, senders = receivers[keep], senders[keep]
        real_idx = np.flatnonzero(keep)
    else:
        real_idx = np.arange(receivers.shape[0])
    order = None
    if receivers.size and np.any(np.diff(receivers) < 0):
        order = np.argsort(receivers, kind="stable")
        receivers, senders, real_idx = (receivers[order], senders[order],
                                        real_idx[order])

    num_blocks = max(1, _round_up(n_nodes, rows_blk) // rows_blk)
    # edges per row-block via boundary search on the sorted receivers
    bounds = np.searchsorted(receivers,
                             np.arange(num_blocks + 1) * rows_blk)
    counts = np.diff(bounds)
    blk = int(_round_up(max(int(counts.max() if counts.size else 0), 1),
                        quantum))
    s_bytes = num_blocks * rows_blk * blk * 4
    if s_bytes > max_s_bytes:
        raise ValueError(
            f"scatter blocks would need {s_bytes/1e9:.1f} GB (N={n_nodes}, "
            f"blk={blk}); chunk the graph (FESR_PREDICT_EDGE_BUDGET) or use "
            "an XLA conv mode")

    deg = np.bincount(receivers, minlength=n_nodes).astype(np.float32)
    weight = (1.0 / np.maximum(deg, 1.0)) if aggr == "mean" else \
        np.ones_like(deg)

    # vectorized block fill: edge j (global sorted order) lands in block
    # b(j) = receivers[j] // rows_blk at column j - bounds[b(j)]
    e_real = receivers.shape[0]
    edge_perm = np.zeros(num_blocks * blk, np.int32)
    senders_perm = np.zeros(num_blocks * blk, np.int32)
    slot_mask = np.zeros(num_blocks * blk, bool)
    slot_rows = np.full(num_blocks * blk, -1, np.int32)
    row_weight = np.zeros(num_blocks * rows_blk, np.float32)
    row_weight[:n_nodes] = weight[:n_nodes]
    s = np.zeros((num_blocks * rows_blk, blk), np.float32) if dense else None
    if e_real:
        block_of = (receivers // rows_blk).astype(np.int64)
        col = np.arange(e_real) - bounds[block_of]
        slot = block_of * blk + col
        edge_perm[slot] = real_idx
        senders_perm[slot] = senders
        slot_mask[slot] = True
        slot_rows[slot] = receivers % rows_blk
        if dense:
            s[receivers, col] = weight[receivers]
    return ScatterBlocks(edge_perm=edge_perm, s_matrix=s,
                         senders_perm=senders_perm, slot_mask=slot_mask,
                         compact_s=CompactS(slot_rows, row_weight),
                         rows_blk=rows_blk, blk=blk, num_blocks=num_blocks,
                         n_nodes=int(n_nodes))


def expand_s(slot_rows: torch.Tensor, row_weight: torch.Tensor, *,
             rows_blk: int, blk: int) -> torch.Tensor:
    """Dense S [nb*rows_blk, blk] from its generators — one blockwise
    compare-multiply (parity with the dense host S is exact)."""
    nb = slot_rows.shape[0] // blk
    rib = slot_rows.reshape(nb, 1, blk)
    rows = torch.arange(rows_blk, dtype=slot_rows.dtype,
                        device=slot_rows.device).reshape(1, rows_blk, 1)
    w = row_weight.reshape(nb, rows_blk, 1)
    return torch.where(rib == rows, w, torch.zeros_like(w)).reshape(
        nb * rows_blk, blk)


def prepare_fused(senders, receivers, edge_attr, n_nodes, edge_mask=None,
                  rows_blk: int = 64, quantum: int = 256,
                  compact: bool = False):
    """Host-side (numpy) fused-path operands for a static graph.

    Returns (edge_attr_blocked, senders_perm, s, rows_blk, blk) where s is
    the dense host S matrix, or (compact=True) a ``CompactS``.
    """
    blocks = build_scatter_blocks(receivers, senders, n_nodes, edge_mask,
                                  rows_blk=rows_blk, quantum=quantum,
                                  dense=not compact)
    ea = np.asarray(edge_attr)[blocks.edge_perm]
    s = blocks.compact_s if compact else blocks.s_matrix
    return (ea, blocks.senders_perm, s, blocks.rows_blk, blocks.blk)


def prepare_fused_train(senders, receivers, edge_attr, n_nodes,
                        edge_mask=None, rows_blk: int = 64,
                        quantum: int = 256, compact: bool = False):
    """Host-side operands for the differentiable fused path:
    (edge_attr_blocked, fused_aux, s, rows_blk, blk); s as in
    ``prepare_fused``."""
    blocks = build_scatter_blocks(receivers, senders, n_nodes, edge_mask,
                                  rows_blk=rows_blk, quantum=quantum,
                                  dense=not compact)
    ea = np.asarray(edge_attr)[blocks.edge_perm]
    s = blocks.compact_s if compact else blocks.s_matrix
    return (ea, blocks.train_aux(), s, blocks.rows_blk, blocks.blk)


# ---------------------------------------------------------------------------
# the CUDA kernels: build at first use, bind with ctypes

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# library -> its source: B1 (forward) and B2 (backward) as a bfloat16
# and a float32 tensor-core (wgmma) instance, the float32 one exact through
# split bf16 operands; their rank-r counterparts B3 and B4 the same way at
# every rank; and B5, the per-edge messages of ops/pallas_mp.py (float32,
# on the tensor cores through split bf16 operands)
_SOURCES = {"fused_edge_conv_f32_wgmma": "fused_edge_conv_f32_wgmma.cu",
            "fused_edge_conv_wgmma": "fused_edge_conv_wgmma.cu",
            "fused_edge_conv_bwd_f32_wgmma": "fused_edge_conv_bwd_f32_wgmma.cu",
            "fused_edge_conv_bwd_wgmma": "fused_edge_conv_bwd_wgmma.cu",
            "fused_edge_conv_lowrank_wgmma": "fused_edge_conv_lowrank_wgmma.cu",
            "fused_edge_conv_lowrank_f32_wgmma":
                "fused_edge_conv_lowrank_f32_wgmma.cu",
            "fused_edge_conv_lowrank_bwd_wgmma":
                "fused_edge_conv_lowrank_bwd_wgmma.cu",
            "fused_edge_conv_lowrank_bwd_f32_wgmma":
                "fused_edge_conv_lowrank_bwd_f32_wgmma.cu",
            "fused_edge_messages_wgmma": "fused_edge_messages_wgmma.cu"}
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_libs: dict = {}
_lib_lock = threading.Lock()


def _nvcc() -> str:
    """nvcc from CUDA_HOME, else from PATH, else the toolkit's default
    install location."""
    if os.environ.get("CUDA_HOME"):
        return os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _lib_path(name: str) -> str:
    return os.path.join(_BUILD_DIR, f"lib{name}.so")


def ptxas_report(name: str) -> str:
    """What ptxas said of library ``name``'s kernels when it was last built
    (registers, shared memory and spills per kernel)."""
    with open(os.path.join(_BUILD_DIR, f"lib{name}.ptxas.txt")) as f:
        return f.read()


def build_kernel(force: bool = False) -> list[str]:
    """Compiles each ``csrc/*.cu`` source into its own library under
    ``_build/``, one nvcc per source, all started together; returns the
    library paths.  A library is rebuilt when it is missing or older than
    any file under ``csrc/``.  Each compile goes to a temporary file renamed
    into place, so concurrent builds never load a half-written library;
    nvcc's report (``-Xptxas -v``) is kept beside it (``ptxas_report``).
    Raises on a failed build."""
    newest = max(os.path.getmtime(os.path.join(_SRC_DIR, f))
                 for f in os.listdir(_SRC_DIR))
    stale = [name for name in _SOURCES
             if force or not os.path.exists(_lib_path(name))
             or os.path.getmtime(_lib_path(name)) < newest]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    jobs, temps = [], []
    try:
        for name in stale:
            fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, suffix=".so")
            os.close(fd)
            temps.append(tmp)
            src = os.path.join(_SRC_DIR, _SOURCES[name])
            jobs.append((name, src, tmp, subprocess.Popen(
                [_nvcc(), *_NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for name, src, tmp, proc in jobs:
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                failed.append(f"nvcc failed building {src}:\n{err}")
            else:
                with open(os.path.join(_BUILD_DIR, f"lib{name}.ptxas.txt"),
                          "w") as f:
                    f.write(err)
                os.replace(tmp, _lib_path(name))
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for *_, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for tmp in temps:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return [_lib_path(name) for name in _SOURCES]


# library -> (function, number of pointer arguments, number of int
# arguments), then the size query's int arguments; every launcher takes the
# stream as its last argument and returns the cudaError_t
_BINDINGS = {
    "fused_edge_conv_f32_wgmma": (("fused_edge_conv_f32_wgmma_forward", 10,
                                   7), 3),
    "fused_edge_conv_wgmma": (("fused_edge_conv_wgmma_forward", 9, 7), 3),
    "fused_edge_conv_bwd_f32_wgmma": ((
        "fused_edge_conv_bwd_f32_wgmma_backward", 13, 6), 3),
    "fused_edge_conv_bwd_wgmma": (("fused_edge_conv_bwd_wgmma_backward", 12,
                                   6), 3),
    "fused_edge_conv_lowrank_wgmma": (("fused_edge_conv_lowrank_wgmma_forward",
                                       10, 8), 4),
    "fused_edge_conv_lowrank_f32_wgmma": ((
        "fused_edge_conv_lowrank_f32_wgmma_forward", 10, 8), 4),
    "fused_edge_conv_lowrank_bwd_wgmma": ((
        "fused_edge_conv_lowrank_bwd_wgmma_backward", 15, 7), 4),
    "fused_edge_conv_lowrank_bwd_f32_wgmma": ((
        "fused_edge_conv_lowrank_bwd_f32_wgmma_backward", 15, 7), 4),
    "fused_edge_messages_wgmma": (("fused_edge_messages_wgmma_forward", 6, 4),
                                  3),
}


def _load_kernel(name: str):
    """The library ``name`` (a key of ``_SOURCES``), building every library
    first if one is stale."""
    with _lib_lock:
        if not _libs:
            build_kernel()
            p, i = ctypes.c_void_p, ctypes.c_int
            for lib_name, ((fn, n_ptr, n_int), n_size) in _BINDINGS.items():
                lib = ctypes.CDLL(_lib_path(lib_name))
                launch = getattr(lib, fn)
                launch.argtypes = [p] * n_ptr + [i] * n_int + [p]
                launch.restype = i
                size = getattr(lib, f"{lib_name}_smem_bytes")
                size.argtypes = [i] * n_size
                size.restype = ctypes.c_long
                _libs[lib_name] = lib
    return _libs[name]


# ---------------------------------------------------------------------------
# the layer


def _gemm_dtype(gemm_dtype: str) -> torch.dtype:
    if gemm_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"gemm_dtype {gemm_dtype!r} (expected float32 | bfloat16)")
    return torch.float32 if gemm_dtype == "float32" else torch.bfloat16


def fused_edge_conv_plain(h_blocked, x, senders_perm, w3, b3, s, *,
                          c_in: int, c_out: int, rows_blk: int, blk: int,
                          gemm_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version of ``fused_edge_conv`` (same operands, same
    result): h, x and w3 are rounded to ``gemm_dtype``, everything after in
    float32.  Materializes the per-slot [slots, c_in*c_out] matrices."""
    dt = _gemm_dtype(gemm_dtype)
    x_src = x[senders_perm.long()].to(dt).float()
    w = h_blocked.to(dt).float() @ w3.to(dt).float() + b3.float()
    msg = torch.einsum("ei,eio->eo", x_src, w.reshape(-1, c_in, c_out))
    return _scatter_mean_plain(msg, s, rows_blk=rows_blk, blk=blk)


def _scatter_mean_plain(msg, s, *, rows_blk: int, blk: int) -> torch.Tensor:
    """out [nb*rows_blk, c_out] = S msg, block by block (dense S, or expanded
    from its generators)."""
    nb, c_out = msg.shape[0] // blk, msg.shape[1]
    if isinstance(s, CompactS):
        s = expand_s(s.slot_rows, s.row_weight, rows_blk=rows_blk, blk=blk)
    out = torch.bmm(s.reshape(nb, rows_blk, blk).float(),
                    msg.reshape(nb, blk, c_out))
    return out.reshape(nb * rows_blk, c_out)


def _dmsg_plain(g, s, dt, *, rows_blk: int, blk: int) -> torch.Tensor:
    """dmsg [slots, c_out] = S^T g block by block, rounded to ``dt``: the
    gradient of ``_scatter_mean_plain`` with respect to msg."""
    nb = g.shape[0] // rows_blk
    if isinstance(s, CompactS):
        s = expand_s(s.slot_rows, s.row_weight, rows_blk=rows_blk, blk=blk)
    dmsg = torch.bmm(s.reshape(nb, rows_blk, blk).float().transpose(1, 2),
                     g.float().reshape(nb, rows_blk, -1))
    return dmsg.reshape(nb * blk, -1).to(dt).float()


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}; the kernel needs CUDA tensors")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# The largest K, c_in and c_out one launch of B1-B5 takes (csrc/ kMaxDim,
# kMaxK, kMaxC, kMaxWide), and B3's and B4's largest rank.  Past it B1, B2
# and B5 run pieces of at most this width on the same instances
# (``width_pieces``); B3 and B4 refuse it
_MAX_WIDTH = 256


# Why B3 and B4 refuse what B1 and B2 run as pieces
_LOWRANK_PAST = (" (B3/B4 past 256: ROADMAP.md queue B (c4); msg = V_e "
                 "(U_e^T x) is bilinear in the head, so pieces of K would "
                 "leave cross terms)")


def _check_geometry(dt, slots: int, rows_blk: int, blk: int,
                    most: int | None = None, why: str = "", **dims) -> None:
    """Raises on what the kernels do not take: a GEMM type other than
    float32 or bfloat16, blocks of other than 64 rows, a blk that is not a
    positive multiple of 64 dividing the slots, or a width ``dims`` (name=
    value) below 1 or, with ``most``, past it (``why`` ends the message).
    B1 and B2 take any K, c_in and c_out (past 256 as pieces,
    ``width_pieces``), one launch up to 256; B3 and B4 take K, c_in, c_out
    and ranks up to 256 (``_LOWRANK_PAST``)."""
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"h_blocked dtype {dt} (expected float32 | bfloat16)")
    if rows_blk != 64:
        raise ValueError(f"rows_blk={rows_blk}: the kernel takes 64-row blocks")
    if blk % 64 or blk <= 0:
        raise ValueError(f"blk={blk} must be a positive multiple of 64")
    for name, v in dims.items():
        if v < 1:
            raise ValueError(f"{name}={v} outside the kernel's 1.."
                             f"{most or 'any'}")
        if most is not None and v > most:
            raise ValueError(f"{name}={v} outside the kernel's 1..{most}{why}")
    if slots % blk:
        raise ValueError(f"{slots} slots is not a multiple of blk={blk}")


def width_pieces(d: int, most: int = _MAX_WIDTH) -> list:
    """[(start, end)] of the pieces B1, B2 and B5 cut a K, c_in or c_out of
    ``d`` into: [(0, d)] up to ``most``, past it ceil(d / most) pieces
    evened out, each a multiple of 8 wide but the last (two of 160 at
    320).  ``most`` is a multiple of 8."""
    if most < 8 or most % 8:
        raise ValueError(f"most={most} must be a positive multiple of 8")
    if d <= most:
        return [(0, d)]
    n = -(-d // most)
    size = _round_up(-(-d // n), 8)
    return [(a, min(a + size, d)) for a in range(0, d, size)]


def piece_width(d: int) -> int:
    """The width of the widest piece (``width_pieces``) of a K, c_in or
    c_out of ``d``: ``d`` up to 256, the instance a piece runs past it."""
    return width_pieces(d)[0][1]


def weight_pieces(w3: torch.Tensor, b3: torch.Tensor, c_in: int, c_out: int,
                  most: int = _MAX_WIDTH):
    """Yields each piece of the weights of a layer of K x c_in x c_out
    (``width_pieces`` of each, K outermost, then c_in, then c_out): (its
    (k0, k1), (i0, i1) and (o0, o1), w3's block [k0:k1, i0:i1, o0:o1] as
    [k1 - k0, (i1 - i0) (o1 - o0)], b3's block [i0:i1, o0:o1] in the first
    K piece and zeros in the others), each contiguous.  W_e = [h_e, 1]
    [W3; b3] is linear in h, x and the weights, so the pieces' messages
    summed over K and c_in give each c_out piece's columns exactly."""
    k = w3.shape[0]
    w, b = w3.reshape(k, c_in, c_out), b3.reshape(c_in, c_out)
    for a, (k0, k1) in enumerate(width_pieces(k, most)):
        for i0, i1 in width_pieces(c_in, most):
            for o0, o1 in width_pieces(c_out, most):
                wp = w[k0:k1, i0:i1, o0:o1].reshape(k1 - k0, -1)
                bp = b[i0:i1, o0:o1].reshape(-1)
                yield ((k0, k1), (i0, i1), (o0, o1), wp.contiguous(),
                       (bp if a == 0 else torch.zeros_like(bp)).contiguous())


def piece_count(k: int, c_in: int, c_out: int,
                most: int = _MAX_WIDTH) -> int:
    """How many pieces (launches of B1, B2 or B5) a layer of K x c_in x
    c_out runs in: 1 up to ``most``."""
    return (len(width_pieces(k, most)) * len(width_pieces(c_in, most))
            * len(width_pieces(c_out, most)))


def _add(acc, part):
    """``acc`` + ``part`` (``part`` when ``acc`` is None), in place on a
    partial sum the pieces already made."""
    return part if acc is None else acc.add_(part)


def forward_pieces(call, h, x, w3, b3, c_in: int, c_out: int,
                   most: int = _MAX_WIDTH) -> torch.Tensor:
    """The output columns of B1 or B5 from pieces of at most ``most`` of K,
    c_in and c_out: ``call(h, x, w3, b3, c_in, c_out)`` on each piece (h's
    and x's columns of it, ``weight_pieces``: b3 in the first K piece only),
    K pieces outermost, each result added into its c_out piece's columns in
    this fixed order, never with atomics, so repeats keep their bits.  The
    messages (and the S-mean) are linear in h, x and [w3; b3], so the sums
    are exact."""
    xs = {p: x[:, p[0]:p[1]].contiguous() for p in width_pieces(c_in, most)}
    cols, hp, at = {}, None, None
    for kp, ip, op, wp, bp in weight_pieces(w3, b3, c_in, c_out, most):
        if kp != at:
            hp, at = h[:, kp[0]:kp[1]].contiguous(), kp
        cols[op] = _add(cols.get(op), call(hp, xs[ip], wp, bp, ip[1] - ip[0],
                                           op[1] - op[0]))
    return torch.cat([cols[op] for op in width_pieces(c_out, most)], dim=1)


def _s_pointers(s, slots: int, nb: int, rows_blk: int, blk: int) -> tuple:
    """(slot_rows, row_weight, dense S) pointers for a launch: S checked as
    ``CompactS`` generators or as the dense matrix, the other pointers
    null."""
    if isinstance(s, CompactS):
        _check("slot_rows", s.slot_rows, torch.int32, (slots,))
        _check("row_weight", s.row_weight, torch.float32, (nb * rows_blk,))
        return s.slot_rows.data_ptr(), s.row_weight.data_ptr(), None
    _check("s", s, torch.float32, (nb * rows_blk, blk))
    return None, None, s.data_ptr()


def design(dt: torch.dtype, rank: int | None = None) -> str:
    """The design a kernel launches for GEMM type ``dt``: 'wgmma', on the
    tensor cores (csrc/*_wgmma.cu), for every kernel in both types, as
    bfloat16 products or float32 ones exact through three-part bf16 splits
    (csrc/f32_wgmma.cuh), at K, c_in and c_out up to 256 (B1 and B2 past
    it as pieces, ``width_pieces``).  B1 and B2 take ``rank`` None; B3 and
    B4 any rank 1-256, run at ``padded_rank`` (csrc/lowrank_wgmma.cuh),
    past rank 64 as ``lowrank_slabs`` slabs of 64 in turn inside each
    kernel (the rank-64 walk on each slab's columns, csrc/lowrank_wgmma.cuh
    slab_col), past a depth of 128 the bfloat16 ones with each chunk in
    stages of 64, the float32 ones in their wide layout
    (``lowrank_smem_bytes``)."""
    return "wgmma"


# A slab's rank: past it B3 and B4 run slabs of this rank in turn
_SLAB_RANK = 64


def padded_rank(rank: int) -> int:
    """The rank B3 and B4 run at: ``rank`` rounded up to a multiple of 8 up
    to 64, past it to a multiple of 64 (``lowrank_slabs`` slabs of 64).
    The head's channels are padded to it with zero columns (w3 and b3 alike),
    so t, dt and duv are zero there and the result is the rank-``rank``
    one; dw3 and db3 come back in the model's columns only."""
    if rank <= _SLAB_RANK:
        return _round_up(rank, 8)
    return _round_up(rank, _SLAB_RANK)


def lowrank_slab_rank(rank: int) -> int:
    """The rank of the kernel instance that runs ``rank``: ``padded_rank``
    up to 64, a slab's 64 past it (csrc/lowrank_wgmma.cuh slab_rank)."""
    return min(padded_rank(rank), _SLAB_RANK)


def lowrank_slabs(rank: int) -> int:
    """How many slabs of ``lowrank_slab_rank`` B3 and B4 walk in turn per
    tile: 1 up to rank 64, ``padded_rank`` / 64 past it (2 at ranks 65-128,
    4 at 193-256)."""
    return padded_rank(rank) // lowrank_slab_rank(rank)


def _conv_library(dt: torch.dtype, backward: bool = False) -> str:
    """The library of B1 (B2 if ``backward``) for GEMM type ``dt``."""
    name = "fused_edge_conv_bwd" if backward else "fused_edge_conv"
    return name + ("_f32" if dt == torch.float32 else "") + "_wgmma"


def _lowrank_library(dt: torch.dtype, backward: bool = False) -> str:
    """The library of B3 (B4 if ``backward``) for GEMM type ``dt``."""
    name = "fused_edge_conv_lowrank" + ("_bwd" if backward else "")
    return name + ("_f32" if dt == torch.float32 else "") + "_wgmma"


def f32_chunks(rows: int, depth: int) -> tuple:
    """(chunks, n): the column chunks the float32 B1 and B5 (B2's rows
    kernel) cut their product's ``rows`` into, c_out (c_in) over a depth of
    c_in (c_out), as csrc/f32_wgmma.cuh's Chunks does: the rows rounded up
    to 8 as one chunk up to 64, else as chunks of at most 64, or 32 where
    the depth is 65..128, each n (a multiple of 8) wide; past a depth of
    128 (A in shared memory, ``f32_depth``) chunks of at most 64.  Each
    chunk is one pass over the K+1 stages.  Past 256 the chunks of the
    widest piece (``piece_width``), the instance a piece runs."""
    rows, depth = piece_width(rows), piece_width(depth)
    r8 = _round_up(rows, 8)
    d16 = _round_up(depth, 16)
    most = 64 if d16 <= 64 or depth > 128 else 32
    chunks = -(-r8 // most)
    return chunks, _round_up(-(-r8 // chunks), 8)


def f32_depth(depth: int) -> tuple:
    """(dp, sd): the float32 B1's and B2's padded depth of A and of the
    stage image, and one stage's depth (csrc/f32_wgmma.cuh Chunks): up to
    128 ``depth`` rounded up to 16, one stage; past it rounded up to 32, in
    dp / 32 stages of 32 (DeepWalk)."""
    if depth > 128:
        return _round_up(depth, 32), 32
    d16 = _round_up(depth, 16)
    return d16, d16


def image_numel(k: int, rows: int, depth: int) -> int:
    """bf16 elements of the float32 B1's and B5's (B2's) stage image of
    [w3; b3]: chunks x (K+1) stages of three [n, dp] operands
    (``f32_chunks``, ``f32_depth``; past a depth of 128 each in dp / 32
    stages of 32; csrc/f32_wgmma.cuh); B1's and B5's rows are c_out and
    their depth c_in, B2's the other way round."""
    chunks, n = f32_chunks(rows, depth)
    return chunks * (k + 1) * 3 * n * f32_depth(depth)[0]


# Bytes of dynamic shared memory one block may take on sm_90 (227 KB):
# csrc/wgmma_tile.cuh kSmemMax
SMEM_MAX = 232_448


def _h_stride(k: int) -> int:
    return k + (6 - k % 4) % 4


def wgmma_fwd_smem(k: int, c_in: int, cols: int, n: int) -> int:
    """Bytes of shared memory the bfloat16 B1 takes for a chunk of n
    columns (``cols`` real at most): csrc/fused_edge_conv_wgmma.cu
    Layout."""
    dp = _round_up(c_in, 16)
    xh = 2 * 64 * dp + 2 * 64 * _h_stride(k)
    first = max(xh, 4 * 64 * (n + 1))
    return first + 2 * 3 * n * dp + 4 * c_in * n + 4 * 64 * cols + 4 * 64


def wgmma_rows_smem(k: int, c_out: int, n: int) -> int:
    """Bytes of shared memory the bfloat16 B2 rows kernel takes for chunks
    of n channels of c_in: csrc/fused_edge_conv_bwd_wgmma.cu RowsLayout."""
    dq = _round_up(c_out, 16)
    return (2 * 64 * dq + 2 * 3 * n * dq + 2 * 64 * _h_stride(k)
            + 4 * c_out * n + 2 * 64 * n + 4 * 64)


def _widest_chunks(width: int, fits) -> tuple:
    """(chunks, n): ``width`` rounded up to 8 as one chunk where ``fits(n)``
    holds for it and it is at most 128 wide, else chunks of the widest n
    (a multiple of 8) that fits, evened out."""
    r8 = _round_up(width, 8)
    most = min(r8, 128)
    while most > 8 and not fits(most):
        most -= 8
    chunks = -(-r8 // most)
    return chunks, _round_up(-(-r8 // chunks), 8)


def wgmma_fwd_chunks(k: int, c_in: int, c_out: int) -> tuple:
    """(chunks, n): the bfloat16 B1's column chunks of c_out, each a block
    of its own (csrc/fused_edge_conv_wgmma.cu FwdChunks): one chunk of all
    of c_out rounded up to 8 where its shared memory fits a block (every
    width up to 128 at K up to 128), else chunks of the widest n that fits,
    evened out.  Past 256 the chunks of the widest piece (``piece_width``)."""
    k, c_in, c_out = (piece_width(v) for v in (k, c_in, c_out))
    return _widest_chunks(c_out, lambda n: wgmma_fwd_smem(
        k, c_in, min(n, c_out), n) <= SMEM_MAX)


def wgmma_rows_chunks(k: int, c_in: int, c_out: int) -> tuple:
    """(chunks, n): the chunks of c_in the bfloat16 B2 rows kernel walks in
    turn (csrc/fused_edge_conv_bwd_wgmma.cu RowsChunks), the same rule."""
    k, c_in, c_out = (piece_width(v) for v in (k, c_in, c_out))
    return _widest_chunks(c_in, lambda n: wgmma_rows_smem(
        k, c_out, n) <= SMEM_MAX)


def f32_fwd_smem(k: int, c_in: int, c_out: int) -> int:
    """Bytes of shared memory the float32 B1 takes
    (csrc/fused_edge_conv_f32_wgmma.cu Layout): up to widths of 128 one
    block walks every column chunk, past them a block takes one; past a
    c_in of 128 X's parts sit in shared memory in place of the h tile."""
    chunks, n = f32_chunks(c_out, c_in)
    dp, sd = f32_depth(c_in)
    np_ = n if c_in > 128 or c_out > 128 else chunks * n
    a = 3 * 2 * 64 * dp if c_in > 128 else 4 * 64 * ((k + 1) | 1)
    return (128 + 4 * 3 * 2 * n * sd + a + 4 * 64 * (np_ + 1)
            + 4 * 64 * min(np_, c_out) + 4 * 64)


def f32_rows_smem(k: int, c_in: int, c_out: int) -> int:
    """Bytes of shared memory the float32 B2 rows kernel takes
    (csrc/fused_edge_conv_bwd_f32_wgmma.cu RowsLayout): the ring, then the
    h and dmsg tiles, or past a c_out of 128 D's parts."""
    _, n = f32_chunks(c_in, c_out)
    dq, sd = f32_depth(c_out)
    ring = 128 + 4 * 3 * 2 * n * sd
    if c_out > 128:
        return ring + 3 * 2 * 64 * dq
    return ring + 4 * 64 * ((k + 1) | 1) + 4 * 64 * c_out


def conv_smem_bytes(dt: torch.dtype, k: int, c_in: int, c_out: int,
                    backward: bool = False) -> int:
    """Bytes of dynamic shared memory one block of B1 (B2's rows kernel if
    ``backward``) takes in GEMM type ``dt``, as the library's
    ``*_smem_bytes`` query says; past 256 the widest piece's
    (``piece_width``), the instance a piece runs."""
    k, c_in, c_out = (piece_width(v) for v in (k, c_in, c_out))
    if dt == torch.float32:
        return (f32_rows_smem if backward else f32_fwd_smem)(k, c_in, c_out)
    if backward:
        return wgmma_rows_smem(k, c_out, wgmma_rows_chunks(k, c_in, c_out)[1])
    n = wgmma_fwd_chunks(k, c_in, c_out)[1]
    return wgmma_fwd_smem(k, c_in, min(n, c_out), n)


def lowrank_chunk_cols(rank: int) -> int:
    """Columns of one product of the float32 B3/B4 at rank ``rank``: the
    whole channels of a slab's head that fit in 64 (64 at a slab rank of 8,
    16, 32 or 64, and so past rank 64; 48 at 24, one channel of 40, 48 or
    56 past 32; csrc/lowrank_f32_wgmma.cuh)."""
    r = lowrank_slab_rank(rank)
    return 64 // r * r


def lowrank_image_depth(depth: int) -> int:
    """The float32 B3's (B4's) padded depth of its A operands and of its
    stage image's chunks: ``depth`` rounded up to 16, past 64 to 32 (each
    chunk then in stages of 32; csrc/lowrank_f32_wgmma.cuh image_depth)."""
    d16 = _round_up(depth, 16)
    return d16 if d16 <= 64 else _round_up(depth, 32)


def lowrank_image_numel(k: int, c_in: int, c_out: int, rank: int,
                        backward: bool = False) -> int:
    """bf16 elements of the float32 B3's (B4's) stage image of w3 and b3:
    each chunk of its walk over the head padded to ``padded_rank`` (B3: the
    U and V chunks of uv; B4: those and the P and Q chunks over k), every
    slab's walk in turn (``lowrank_slabs``: the image grows linearly with
    them), as three [N, depth] operands, N ``lowrank_chunk_cols`` and depth
    K (B4: the largest of K, c_in and c_out) padded as
    ``lowrank_image_depth`` (past 64 in stages of 32); then b3 padded,
    float32 (csrc/lowrank_f32_wgmma.cuh)."""
    n = lowrank_chunk_cols(rank)
    g = n // lowrank_slab_rank(rank)
    chunks = -(-c_in // g) + -(-c_out // g)
    depth = k
    if backward:
        chunks += 2 * -(-k // g)
        depth = max(k, c_in, c_out)
    return (lowrank_slabs(rank) * chunks * 3 * n * lowrank_image_depth(depth)
            + 2 * padded_rank(rank) * (c_in + c_out))


def lowrank_smem_bytes(dt: torch.dtype, k: int, c_in: int, c_out: int,
                       rank: int, kernel: str = "fwd") -> int:
    """Bytes of dynamic shared memory one block of B3 (``kernel`` 'fwd'),
    of B4's rows kernel ('rows') or of B4's weights kernel ('weights')
    takes in GEMM type ``dt``: each kernel's Layout (the libraries'
    ``*_smem_bytes`` queries say 'fwd' and 'rows').  bfloat16: up to a
    depth of 128 a ring of three whole chunks [128][depth], past it three
    stages [128][64] (csrc/lowrank_wgmma.cuh staged); the weights
    kernel with one set of staged operands where two do not fit.  float32:
    past a K, c_in or c_out of 128 the wide layout (B3's x and message
    tiles shared, its part sums in device memory; B4 rows without the x_src
    and dh tiles; csrc/lowrank_f32_wgmma.cuh wide_dims).  Past rank 64 every
    layout is the rank-64 one (``lowrank_slab_rank``): the slabs run in
    turn, and the weights kernels stage one slab of t or dt per 64
    columns."""
    rp = lowrank_slab_rank(rank)
    if dt == torch.bfloat16:
        if kernel == "weights":
            sets = 2 * 3 * 128 * 64
            one = 2 * 64 * 64 + 2 * 64 * (c_in + c_out) + 2 * 4 * 64 * rp
            return sets + (2 if sets + 2 * one <= SMEM_MAX else 1) * one
        kp, dpi, dpo = (_round_up(v, 16) for v in (k, c_in, c_out))
        dmax = kp if kernel == "fwd" else max(kp, dpi, dpo)
        ring = 3 * (2 * 128 * (dmax if dmax <= 128 else 64) + 4 * 128)
        if kernel == "fwd":
            return (2 * 64 * kp + ring + 4 * 64 * max(c_in | 1, c_out | 1)
                    + 4 * 64 * c_out + 4 * 2 * 64)
        return (2 * 64 * (kp + dpi + dpo) + ring + 4 * 2 * (128 // rp) * 128
                + 4 * 64)
    if kernel == "weights":
        return 3 * 2 * 64 * 64 + 3 * 2 * 128 * 64 + 4 * 64 * 64 + 4 * 64 * 18 \
            + 2 * 4 * 64 * rp
    n = lowrank_chunk_cols(rank)
    wide = max(k, c_in, c_out) > 128
    dp = lowrank_image_depth(k if kernel == "fwd" else max(k, c_in, c_out))
    sd = dp if dp <= 64 else 32
    a = 128 + 4 * 3 * 2 * n * sd + (3 * 2 * 64 * dp if dp > 64 else 0)
    if kernel == "fwd":
        if wide:
            return a + 4 * 64 * (max(c_in, c_out) | 1) + 4 * 64
        return (a + 4 * 64 * ((c_in | 1) + (c_out | 1)) + 4 * 64 * c_out
                + 4 * 64)
    return a + 4 * 64 * (c_out | 1) + (0 if wide else 4 * 64 * (
        (c_in | 1) + (k | 1)))


def lowrank_pad_numel(k: int, c_in: int, c_out: int, rank: int) -> int:
    """bf16 elements of the bfloat16 B3's (B4's) scratch for w3 padded to
    ``padded_rank`` [K, rp*(c_in+c_out)], laid out by the library's first
    launch at a rank other than rp (not a multiple of 8 up to 64, of 64
    past it); 0 at the others (csrc/lowrank_wgmma.cuh pad_head)."""
    rp = padded_rank(rank)
    return 0 if rp == rank else k * rp * (c_in + c_out)


# The bfloat16 B1's (and B3's) tensor-core blocks resident per SM (shared
# memory allows 3-4 at width 48) and the waves of them a launch should fill
_FWD_BLOCKS_PER_SM = 3
_FWD_WAVES = 2


def conv_parts(num_blocks: int, tiles_per_block: int, sms: int) -> int:
    """Parts each receiver block's slot walk is split into for B1 and the
    tensor-core B3: enough blocks for ``_FWD_WAVES`` waves of ``_FWD_BLOCKS_PER_SM``
    per SM, at most one part per 64-slot tile, at least one part."""
    target = sms * _FWD_BLOCKS_PER_SM * _FWD_WAVES
    return max(1, min(tiles_per_block, -(-target // num_blocks)))


def part_bounds(tiles_per_block: int, parts: int) -> list:
    """[(first tile, end tile)] of each part, in order, as the kernel cuts
    a receiver block's tiles: part p walks tiles p*T//P .. (p+1)*T//P."""
    return [(p * tiles_per_block // parts, (p + 1) * tiles_per_block // parts)
            for p in range(parts)]


def weight_tiles(k: int, c_in: int, c_out: int) -> tuple:
    """(column tiles, row tiles) of the B2 weights kernel's output [K,
    c_in*c_out] (both types): 128 columns by 64 rows of K each."""
    return -(-c_in * c_out // 128), -(-k // 64)


def lowrank_weight_tiles(k: int, c_in: int, c_out: int, rank: int) -> tuple:
    """(column tiles, row tiles) of the B4 weights kernel (both types) over
    the padded duv [K+1, rp*(c_in+c_out)], rp ``padded_rank``: 128 columns
    by 64 rows of K each (dw3 on the tensor cores; db3, row K, summed by the
    thread that forms its column, in the first row tile's blocks only).
    Each tile writes its columns with q < r into the [K+1, r*(c_in+c_out)]
    result."""
    return -(-padded_rank(rank) * (c_in + c_out) // 128), -(-k // 64)


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def occupancy(k: int, c_in: int, c_out: int,
              rank: int | None = None) -> dict:
    """Thread blocks of each tensor-core kernel that one SM of the current
    card holds at once at these widths (the CUDA runtime's occupancy query,
    with each kernel's shared memory): B1's and B2's (past 256 the widest
    piece's, ``piece_width``), or at a ``rank`` B3's and B4's tensor-core
    kernels, in bfloat16 and (keys ending ``_f32``) in float32."""
    out = {}
    for dt, suffix in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        if rank is None:
            fwd, bwd = _conv_library(dt), _conv_library(dt, backward=True)
            dims = tuple(piece_width(v) for v in (k, c_in, c_out))
        else:
            fwd, bwd = _lowrank_library(dt), _lowrank_library(dt, True)
            dims = (k, c_in, c_out, rank)
        query = getattr(_load_kernel(bwd), f"{bwd}_blocks_per_sm")
        out.update({
            "fwd" + suffix: getattr(_load_kernel(fwd),
                                    f"{fwd}_blocks_per_sm")(*dims),
            "bwd_rows" + suffix: query(*dims, 0),
            "bwd_weights" + suffix: query(*dims, 1)})
    return out


def _fwd_operands(h_blocked, x, senders_perm, w3, b3, s, *, c_in: int,
                  c_out: int, rows_blk: int, blk: int, most=None) -> tuple:
    """Checks B1's operands (widths up to ``most``, if given) and raises on
    what the kernel does not take; returns (the S pointers, the blocks,
    the nodes)."""
    dt = h_blocked.dtype
    slots, k = h_blocked.shape
    _check_geometry(dt, slots, rows_blk, blk, most, K=k, c_in=c_in,
                    c_out=c_out)
    nb = slots // blk
    n = x.shape[0]
    _check("h_blocked", h_blocked, dt, (slots, k))
    _check("x", x, dt, (n, c_in))
    _check("senders_perm", senders_perm, torch.int32, (slots,))
    _check("w3", w3, dt, (k, c_in * c_out))
    _check("b3", b3, torch.float32, (c_in * c_out,))
    ptrs = _s_pointers(s, slots, nb, rows_blk, blk)
    dev = h_blocked.device
    for name, t in (("x", x), ("senders_perm", senders_perm), ("w3", w3),
                    ("b3", b3)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, h_blocked on {dev}")
    return ptrs, nb, n


def _fused_edge_conv_launch(h_blocked, x, senders_perm, w3, b3, s, *,
                            c_in: int, c_out: int, rows_blk: int,
                            blk: int) -> torch.Tensor:
    """One launch of B1 (K, c_in and c_out up to 256) on the current
    stream; see ``fused_edge_conv_cuda``."""
    ptrs, nb, n = _fwd_operands(h_blocked, x, senders_perm, w3, b3, s,
                                c_in=c_in, c_out=c_out, rows_blk=rows_blk,
                                blk=blk, most=_MAX_WIDTH)
    dt, dev, k = h_blocked.dtype, h_blocked.device, h_blocked.shape[1]
    name = _conv_library(dt)
    lib = _load_kernel(name)
    parts = conv_parts(nb, blk // 64, _sms(dev))
    out = torch.empty((parts, nb * rows_blk, c_out), dtype=torch.float32,
                      device=dev)
    if dt == torch.float32:  # scratch: the stage image of w3 and b3
        image = torch.empty(image_numel(k, c_out, c_in), dtype=torch.bfloat16,
                            device=dev)
        ptrs = (*ptrs, image.data_ptr())
    with torch.cuda.device(dev):
        err = getattr(lib, _BINDINGS[name][0][0])(
            h_blocked.data_ptr(), x.data_ptr(), senders_perm.data_ptr(),
            w3.data_ptr(), b3.data_ptr(), *ptrs, out.data_ptr(), nb, blk, k,
            c_in, c_out, n, parts, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        smem = getattr(lib, f"{name}_smem_bytes")(k, c_in, c_out)
        raise RuntimeError(
            f"{name} kernel launch failed: cudaError {err} "
            f"(K={k}, c_in={c_in}, c_out={c_out}: {smem} B of shared memory "
            "per block)")
    fused_edge_conv.launches += 1
    return out[0] if parts == 1 else out.sum(0)


def fused_edge_conv_pieces(launch, h_blocked, x, senders_perm, w3, b3, s, *,
                           c_in: int, c_out: int, most: int = _MAX_WIDTH,
                           **kw) -> torch.Tensor:
    """B1 as ``launch`` (one launch, or the plain version) on pieces of at
    most ``most`` of K, c_in and c_out (``forward_pieces``); ``kw`` goes to
    each call."""
    return forward_pieces(
        lambda h, xp, wp, bp, ci, co: launch(h, xp, senders_perm, wp, bp, s,
                                             c_in=ci, c_out=co, **kw),
        h_blocked, x, w3, b3, c_in, c_out, most)


def fused_edge_conv_cuda(h_blocked, x, senders_perm, w3, b3, s, *,
                         c_in: int, c_out: int, rows_blk: int,
                         blk: int) -> torch.Tensor:
    """Launches the CUDA kernel on the current stream, on the tensor cores
    for both types (``design``): csrc/fused_edge_conv_wgmma.cu for
    bfloat16, csrc/fused_edge_conv_f32_wgmma.cu for float32 (after its
    first launch, the stage image of w3 and b3, into scratch).  h_blocked,
    x and w3 share one dtype (the GEMM input type); b3 and S are float32,
    index arrays int32.  Checks every operand and raises on what the kernel
    does not take; raises if a launch fails.  Any K, c_in and c_out: up to
    256 one launch, past it one launch per piece (``fused_edge_conv_pieces``;
    ``fused_edge_conv.launches`` counts each).  The kernel splits each
    receiver block's slot walk into ``conv_parts`` parts whose partial sums
    are added here in a fixed order."""
    kw = dict(c_in=c_in, c_out=c_out, rows_blk=rows_blk, blk=blk)
    if max(h_blocked.shape[-1], c_in, c_out) <= _MAX_WIDTH:
        # one launch, its own checks only: no wrapper cost on the card
        return _fused_edge_conv_launch(h_blocked, x, senders_perm, w3, b3,
                                       s, **kw)
    _fwd_operands(h_blocked, x, senders_perm, w3, b3, s, **kw)
    return fused_edge_conv_pieces(_fused_edge_conv_launch, h_blocked, x,
                                  senders_perm, w3, b3, s, **kw)


def fused_edge_conv(h_blocked, x, senders_perm, w3, b3, s, *,
                    c_in: int, c_out: int, rows_blk: int, blk: int,
                    gemm_dtype: str = "float32") -> torch.Tensor:
    """One conv layer's message+aggregate: returns [num_blocks*rows_blk, c_out]
    float32.

    Args:
      h_blocked: [num_blocks*blk, K] edge-MLP hidden feats in block order.
      x: [N, c_in] node features entering this layer.
      senders_perm: [num_blocks*blk] int32 sender ids in block order.
      w3/b3: final edge-MLP layer ([K, c_in*c_out], [c_in*c_out]).
      s: dense [num_blocks*rows_blk, blk] scatter weights, or ``CompactS``.
      gemm_dtype: 'float32' or 'bfloat16' — the type h, x and w3 are rounded
        to; accumulation is float32 either way.

    CUDA operands launch the kernel (``fused_edge_conv.launches`` counts the
    launches); CPU operands run ``fused_edge_conv_plain``.
    """
    if h_blocked.device.type == "cpu":
        return fused_edge_conv_plain(h_blocked, x, senders_perm, w3, b3, s,
                                     c_in=c_in, c_out=c_out,
                                     rows_blk=rows_blk, blk=blk,
                                     gemm_dtype=gemm_dtype)
    dt = _gemm_dtype(gemm_dtype)
    return fused_edge_conv_cuda(h_blocked.to(dt).contiguous(),
                                x.to(dt).contiguous(), senders_perm,
                                w3.to(dt).contiguous(), b3.float().contiguous(),
                                s, c_in=c_in, c_out=c_out, rows_blk=rows_blk,
                                blk=blk)


fused_edge_conv.launches = 0


# ---------------------------------------------------------------------------
# the layer's backward (B2) and the differentiable layer


def fused_edge_conv_bwd_plain(g, h_blocked, x_src, w3, b3, s, *,
                              c_in: int, c_out: int, rows_blk: int, blk: int,
                              gemm_dtype: str = "float32"):
    """Plain PyTorch version of ``fused_edge_conv_bwd``: the gradients of
    ``fused_edge_conv`` with respect to (h_blocked, x_src, w3, b3), written
    out.  dmsg = S^T g per block is rounded to ``gemm_dtype`` like h, x_src
    and w3; everything after is float32.  Materializes the per-slot
    [slots, c_in*c_out] outer products and matrices."""
    dt = _gemm_dtype(gemm_dtype)
    slots = h_blocked.shape[0]
    dmsg = _dmsg_plain(g, s, dt, rows_blk=rows_blk, blk=blk)
    h = h_blocked.to(dt).float()
    xs = x_src.to(dt).float()
    w3f = w3.to(dt).float()
    # z[e, i*c_out + o] = x_src[e, i] dmsg[e, o]: left operand of dh and dw3
    z = (xs[:, :, None] * dmsg[:, None, :]).reshape(slots, c_in * c_out)
    dh = z @ w3f.t()
    dw3 = h.t() @ z
    db3 = z.sum(0)
    w = (h @ w3f + b3.float()).reshape(slots, c_in, c_out)
    dx_src = torch.einsum("eio,eo->ei", w, dmsg)
    return dh, dx_src, dw3, db3


def weight_splits(slots: int, tiles: int, sms: int) -> int:
    """Slot splits of a backward's weights kernel: about six thread blocks
    per SM over its ``tiles`` output tiles, at least one 64-slot chunk per
    split."""
    return max(1, min(slots // 64, -(-6 * sms // tiles)))


def _weight_splits(slots: int, tiles: int, device) -> int:
    return weight_splits(slots, tiles, _sms(device))


def _bwd_operands(g, h_blocked, x_src, w3, b3, s, *, c_in: int, c_out: int,
                  rows_blk: int, blk: int, most=None) -> tuple:
    """Checks B2's operands (widths up to ``most``, if given) and raises on
    what the kernel does not take; returns (the S pointers, the blocks)."""
    dt = h_blocked.dtype
    slots, k = h_blocked.shape
    _check_geometry(dt, slots, rows_blk, blk, most, K=k, c_in=c_in,
                    c_out=c_out)
    nb, c2 = slots // blk, c_in * c_out
    _check("g", g, torch.float32, (nb * rows_blk, c_out))
    _check("h_blocked", h_blocked, dt, (slots, k))
    _check("x_src", x_src, dt, (slots, c_in))
    _check("w3", w3, dt, (k, c2))
    _check("b3", b3, torch.float32, (c2,))
    ptrs = _s_pointers(s, slots, nb, rows_blk, blk)
    dev = h_blocked.device
    for name, t in (("g", g), ("x_src", x_src), ("w3", w3), ("b3", b3)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, h_blocked on {dev}")
    return ptrs, nb


def _fused_edge_conv_bwd_launch(g, h_blocked, x_src, w3, b3, s, *,
                                c_in: int, c_out: int, rows_blk: int,
                                blk: int):
    """One call of B2's kernels (K, c_in and c_out up to 256) on the
    current stream; see ``fused_edge_conv_bwd_cuda``."""
    ptrs, nb = _bwd_operands(g, h_blocked, x_src, w3, b3, s, c_in=c_in,
                             c_out=c_out, rows_blk=rows_blk, blk=blk,
                             most=_MAX_WIDTH)
    dt, dev = h_blocked.dtype, h_blocked.device
    slots, k = h_blocked.shape
    c2 = c_in * c_out
    name = _conv_library(dt, backward=True)
    lib = _load_kernel(name)
    f32 = dict(dtype=torch.float32, device=dev)
    dh = torch.empty((slots, k), **f32)
    dx_src = torch.empty((slots, c_in), **f32)
    # scratch between the launches: dmsg, already rounded to the GEMM type
    dmsg = torch.empty((slots, c_out), dtype=dt, device=dev)
    col_tiles, row_tiles = weight_tiles(k, c_in, c_out)
    splits = _weight_splits(slots, col_tiles * row_tiles, dev)
    partial = torch.empty((splits, k + 1, c2), **f32)
    if dt == torch.float32:  # scratch: the stage image of w3 and b3
        image = torch.empty(image_numel(k, c_in, c_out), dtype=torch.bfloat16,
                            device=dev)
        ptrs = (*ptrs, image.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _BINDINGS[name][0][0])(
            g.data_ptr(), h_blocked.data_ptr(), x_src.data_ptr(),
            w3.data_ptr(), b3.data_ptr(), *ptrs, dh.data_ptr(),
            dx_src.data_ptr(), dmsg.data_ptr(), partial.data_ptr(), nb, blk,
            k, c_in, c_out, splits, stream)
    if err != 0:
        smem = getattr(lib, f"{name}_smem_bytes")(k, c_in, c_out)
        raise RuntimeError(
            f"{name} kernel launch failed: cudaError {err} "
            f"(K={k}, c_in={c_in}, c_out={c_out}: {smem} B of shared memory "
            "per block)")
    fused_edge_conv_bwd.launches += 1
    total = partial.sum(0)
    return dh, dx_src, total[:k], total[k]


def fused_edge_conv_bwd_pieces(launch, g, h_blocked, x_src, w3, b3, s, *,
                               c_in: int, c_out: int, most: int = _MAX_WIDTH,
                               **kw):
    """B2 as ``launch`` (one call of its kernels, or the plain version) on
    pieces of at most ``most`` of K, c_in and c_out, in
    ``fused_edge_conv_pieces``' order: each piece takes g's columns of its
    c_out piece.  dh's columns of a K piece are its pieces' sums over c_in and
    c_out, dx_src's of a c_in piece those over K and c_out, added in this
    fixed order; dw3 falls in disjoint blocks; db3 (z summed over the
    slots, free of K) comes from the first K piece.  Each piece allocates
    its own scratch (B2's [splits, K+1, c_in c_out] partials at the
    piece's size)."""
    k = h_blocked.shape[1]
    f32 = dict(dtype=torch.float32, device=h_blocked.device)
    dw3 = torch.empty((k, c_in, c_out), **f32)
    db3 = torch.empty((c_in, c_out), **f32)
    gs = {p: g[:, p[0]:p[1]].contiguous() for p in width_pieces(c_out, most)}
    xs = {p: x_src[:, p[0]:p[1]].contiguous()
          for p in width_pieces(c_in, most)}
    dh, dx, h, at = {}, {}, None, None
    for kp, ip, op, wp, bp in weight_pieces(w3, b3, c_in, c_out, most):
        if kp != at:
            h, at = h_blocked[:, kp[0]:kp[1]].contiguous(), kp
        dh_p, dx_p, dw_p, db_p = launch(gs[op], h, xs[ip], wp, bp, s,
                                        c_in=ip[1] - ip[0],
                                        c_out=op[1] - op[0], **kw)
        dh[kp] = _add(dh.get(kp), dh_p)
        dx[ip] = _add(dx.get(ip), dx_p)
        dw3[kp[0]:kp[1], ip[0]:ip[1], op[0]:op[1]] = dw_p.reshape(
            kp[1] - kp[0], ip[1] - ip[0], op[1] - op[0])
        if kp[0] == 0:
            db3[ip[0]:ip[1], op[0]:op[1]] = db_p.reshape(ip[1] - ip[0],
                                                         op[1] - op[0])
    return (torch.cat([dh[p] for p in width_pieces(k, most)], dim=1),
            torch.cat([dx[p] for p in width_pieces(c_in, most)], dim=1),
            dw3.reshape(k, c_in * c_out), db3.reshape(c_in * c_out))


def fused_edge_conv_bwd_cuda(g, h_blocked, x_src, w3, b3, s, *, c_in: int,
                             c_out: int, rows_blk: int, blk: int):
    """Launches the backward kernels on the current stream, on the tensor
    cores for both types (``design``): csrc/fused_edge_conv_bwd_wgmma.cu
    for bfloat16, csrc/fused_edge_conv_bwd_f32_wgmma.cu for float32 (after
    the stage image of w3 and b3, into scratch).  h_blocked, x_src and w3
    share one dtype (the GEMM input type); g, b3 and S are float32,
    slot_rows int32.  Checks every operand and raises on what the kernel
    does not take; raises if a launch fails.  Any K, c_in and c_out: up to
    256 one call, past it one per piece (``fused_edge_conv_bwd_pieces``;
    ``fused_edge_conv_bwd.launches`` counts each).  Returns (dh, dx_src,
    dw3, db3), float32; dw3/db3 are the kernel's per-split partials summed
    in a fixed order."""
    kw = dict(c_in=c_in, c_out=c_out, rows_blk=rows_blk, blk=blk)
    if max(h_blocked.shape[-1], c_in, c_out) <= _MAX_WIDTH:
        return _fused_edge_conv_bwd_launch(g, h_blocked, x_src, w3, b3, s,
                                           **kw)
    _bwd_operands(g, h_blocked, x_src, w3, b3, s, **kw)
    return fused_edge_conv_bwd_pieces(_fused_edge_conv_bwd_launch, g,
                                      h_blocked, x_src, w3, b3, s, **kw)


def fused_edge_conv_bwd(g, h_blocked, x_src, w3, b3, s, *, c_in: int,
                        c_out: int, rows_blk: int, blk: int,
                        gemm_dtype: str = "float32"):
    """Backward of ``fused_edge_conv`` with respect to (h_blocked, x_src, w3,
    b3), given g [num_blocks*rows_blk, c_out], the gradient of its output,
    and x_src = x[senders_perm].  Returns (dh [slots, K], dx_src
    [slots, c_in], dw3 [K, c_in*c_out], db3 [c_in*c_out]), all float32.

    CUDA operands launch the kernel (``fused_edge_conv_bwd.launches`` counts
    the launches); CPU operands run ``fused_edge_conv_bwd_plain``.
    """
    if h_blocked.device.type == "cpu":
        return fused_edge_conv_bwd_plain(g, h_blocked, x_src, w3, b3, s,
                                         c_in=c_in, c_out=c_out,
                                         rows_blk=rows_blk, blk=blk,
                                         gemm_dtype=gemm_dtype)
    dt = _gemm_dtype(gemm_dtype)
    return fused_edge_conv_bwd_cuda(
        g.float().contiguous(), h_blocked.to(dt).contiguous(),
        x_src.to(dt).contiguous(), w3.to(dt).contiguous(),
        b3.float().contiguous(), s, c_in=c_in, c_out=c_out,
        rows_blk=rows_blk, blk=blk)


fused_edge_conv_bwd.launches = 0


def scatter_dx(dx_src: torch.Tensor, senders_dump: torch.Tensor,
               n_nodes: int) -> torch.Tensor:
    """dx [n_nodes, c_in] from per-slot dx_src: one ``index_add_`` over
    n_nodes+1 rows, the last of which (the dump row, where ``train_aux``
    points padding slots) is dropped, so padding never reaches node 0."""
    out = dx_src.new_zeros((n_nodes + 1, dx_src.shape[1]))
    return out.index_add_(0, senders_dump.long(), dx_src)[:n_nodes]


class FusedEdgeConv(torch.autograd.Function):
    """The differentiable fused layer: forward through ``fused_edge_conv``
    (B1), backward through ``fused_edge_conv_bwd`` (B2).  It saves only its
    inputs, never the per-slot [slots, c_in*c_out] matrices: the backward
    recomputes them tile by tile.  Gradients flow to h_blocked, x, w3 and
    b3, in their own dtypes; S and the aux get none."""

    @staticmethod
    def forward(ctx, h_blocked, x, w3, b3, s, fused_aux, c_in, c_out,
                rows_blk, blk, gemm_dtype):
        ctx.save_for_backward(h_blocked, x, w3, b3)
        ctx.s, ctx.aux = s, fused_aux
        ctx.kw = dict(c_in=c_in, c_out=c_out, rows_blk=rows_blk, blk=blk,
                      gemm_dtype=gemm_dtype)
        return fused_edge_conv(h_blocked, x, fused_aux["senders_perm"], w3,
                               b3, s, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        h_blocked, x, w3, b3 = ctx.saved_tensors
        x_src = x[ctx.aux["senders_perm"].long()]
        dh, dx_src, dw3, db3 = fused_edge_conv_bwd(g, h_blocked, x_src, w3,
                                                   b3, ctx.s, **ctx.kw)
        dx = scatter_dx(dx_src, ctx.aux["senders_dump"], x.shape[0])
        return (dh.to(h_blocked.dtype), dx.to(x.dtype), dw3.to(w3.dtype),
                db3.to(b3.dtype)) + (None,) * 7


def fused_edge_conv_ad(h_blocked, x, w3, b3, s, fused_aux, *, c_in: int,
                       c_out: int, rows_blk: int, blk: int,
                       gemm_dtype: str = "float32") -> torch.Tensor:
    """Differentiable fused conv layer (training path), the counterpart of
    the JAX package's custom-VJP ``fused_edge_conv_ad``.

    ``fused_aux``: {'senders_perm', 'senders_dump'} int32 tensors from
    ``prepare_fused_train``; ``s`` dense S or ``CompactS``.  Returns
    [num_blocks*rows_blk, c_out] float32.
    """
    return FusedEdgeConv.apply(h_blocked, x, w3, b3, s, fused_aux, c_in,
                               c_out, rows_blk, blk, gemm_dtype)


# ---------------------------------------------------------------------------
# the rank-r layer (B3), its backward (B4) and the differentiable rank-r layer
#
# Per slot the edge MLP's head gives uv [r*(c_in+c_out)] in the model's column
# layout: U[i, q] = uv[i*r + q], V[o, q] = uv[r*c_in + o*r + q].  The rounding
# points, the same in the kernels and their plain versions: h, x (x_src), w3
# and (backward) dmsg to the GEMM type; uv, t, msg and every gradient stay
# float32.


def _lowrank_parts(uv, c_in: int, c_out: int, rank: int):
    """(U [slots, c_in, r], V [slots, c_out, r]) views of uv."""
    ru = c_in * rank
    return (uv[:, :ru].reshape(-1, c_in, rank),
            uv[:, ru:].reshape(-1, c_out, rank))


def fused_edge_conv_lowrank_plain(h_blocked, x, senders_perm, w3, b3, s, *,
                                  c_in: int, c_out: int, rank: int,
                                  rows_blk: int, blk: int,
                                  gemm_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version of ``fused_edge_conv_lowrank`` (same operands,
    same result).  Materializes the per-slot [slots, r*(c_in+c_out)] uv."""
    dt = _gemm_dtype(gemm_dtype)
    x_src = x[senders_perm.long()].to(dt).float()
    uv = h_blocked.to(dt).float() @ w3.to(dt).float() + b3.float()
    u, v = _lowrank_parts(uv, c_in, c_out, rank)
    t = torch.einsum("ei,eiq->eq", x_src, u)
    msg = torch.einsum("eq,eoq->eo", t, v)
    return _scatter_mean_plain(msg, s, rows_blk=rows_blk, blk=blk)


def _lowrank_scratch(dt: torch.dtype, k: int, c_in: int, c_out: int,
                     rank: int, backward: bool, device) -> torch.Tensor:
    """A B3 (B4 if ``backward``) launch's bf16 scratch: the float32
    instance's stage image of w3 and b3 (``lowrank_image_numel``), or the
    bfloat16 instance's w3 padded to ``padded_rank`` (``lowrank_pad_numel``;
    empty, a null pointer, at a rank that is its own padded rank)."""
    numel = (lowrank_image_numel(k, c_in, c_out, rank, backward)
             if dt == torch.float32 else lowrank_pad_numel(k, c_in, c_out, rank))
    return torch.empty(numel, dtype=torch.bfloat16, device=device)


def fused_edge_conv_lowrank_cuda(h_blocked, x, senders_perm, w3, b3, s, *,
                                 c_in: int, c_out: int, rank: int,
                                 rows_blk: int, blk: int) -> torch.Tensor:
    """Launches the rank-r forward kernel on the current stream, on the
    tensor cores for both types at every rank (``design``):
    csrc/fused_edge_conv_lowrank_wgmma.cu for bfloat16 (at a rank other than
    its ``padded_rank``, after its first launch, w3 padded to it, into
    scratch), csrc/fused_edge_conv_lowrank_f32_wgmma.cu
    for float32 (after its first launch, the stage image of w3 and b3, into
    scratch).  h_blocked, x and w3 share one dtype (float32 or bfloat16, the
    GEMM input type); b3 and S are float32, index arrays int32.  Checks
    every operand and raises on what the kernel does not take; raises if
    the launch fails.  The kernel splits each receiver block's slot walk
    into ``conv_parts`` parts whose partial sums are added here in a fixed
    order."""
    dt = h_blocked.dtype
    slots, k = h_blocked.shape
    _check_geometry(dt, slots, rows_blk, blk, _MAX_WIDTH, _LOWRANK_PAST, K=k,
                    c_in=c_in, c_out=c_out, rank=rank)
    nb, ncol = slots // blk, rank * (c_in + c_out)
    n = x.shape[0]
    _check("h_blocked", h_blocked, dt, (slots, k))
    _check("x", x, dt, (n, c_in))
    _check("senders_perm", senders_perm, torch.int32, (slots,))
    _check("w3", w3, dt, (k, ncol))
    _check("b3", b3, torch.float32, (ncol,))
    ptrs = _s_pointers(s, slots, nb, rows_blk, blk)
    dev = h_blocked.device
    for name, t in (("x", x), ("senders_perm", senders_perm), ("w3", w3),
                    ("b3", b3)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, h_blocked on {dev}")
    name = _lowrank_library(dt)
    lib = _load_kernel(name)
    parts = conv_parts(nb, blk // 64, _sms(dev))
    out = torch.empty((parts, nb * rows_blk, c_out), dtype=torch.float32,
                      device=dev)
    scratch = _lowrank_scratch(dt, k, c_in, c_out, rank, False, dev)
    with torch.cuda.device(dev):
        err = getattr(lib, _BINDINGS[name][0][0])(
            h_blocked.data_ptr(), x.data_ptr(), senders_perm.data_ptr(),
            w3.data_ptr(), b3.data_ptr(), *ptrs, scratch.data_ptr(),
            out.data_ptr(), nb, blk, k, c_in, c_out, rank, n, parts,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        smem = getattr(lib, f"{name}_smem_bytes")(k, c_in, c_out, rank)
        raise RuntimeError(
            f"{name} kernel launch failed: cudaError {err} "
            f"(K={k}, c_in={c_in}, c_out={c_out}, rank={rank}: {smem} B of "
            "shared memory per block)")
    fused_edge_conv_lowrank.launches += 1
    return out[0] if parts == 1 else out.sum(0)


def fused_edge_conv_lowrank(h_blocked, x, senders_perm, w3, b3, s, *,
                            c_in: int, c_out: int, rank: int, rows_blk: int,
                            blk: int,
                            gemm_dtype: str = "bfloat16") -> torch.Tensor:
    """One rank-r conv layer's message+aggregate, the counterpart of the JAX
    package's ``fused_edge_conv_lowrank``: returns [num_blocks*rows_blk,
    c_out] float32.  Operands as ``fused_edge_conv``'s, with w3 [K,
    r*(c_in+c_out)] and b3 [r*(c_in+c_out)] the edge MLP's head in the
    model's column layout; ``gemm_dtype`` defaults to bfloat16, as the JAX
    function's does.

    CUDA operands launch the kernel (``fused_edge_conv_lowrank.launches``
    counts the launches); CPU operands run ``fused_edge_conv_lowrank_plain``.
    """
    kw = dict(c_in=c_in, c_out=c_out, rank=rank, rows_blk=rows_blk, blk=blk)
    if h_blocked.device.type == "cpu":
        return fused_edge_conv_lowrank_plain(h_blocked, x, senders_perm, w3,
                                             b3, s, gemm_dtype=gemm_dtype,
                                             **kw)
    dt = _gemm_dtype(gemm_dtype)
    return fused_edge_conv_lowrank_cuda(
        h_blocked.to(dt).contiguous(), x.to(dt).contiguous(), senders_perm,
        w3.to(dt).contiguous(), b3.float().contiguous(), s, **kw)


fused_edge_conv_lowrank.launches = 0


def fused_edge_conv_lowrank_bwd_plain(g, h_blocked, x_src, w3, b3, s, *,
                                      c_in: int, c_out: int, rank: int,
                                      rows_blk: int, blk: int,
                                      gemm_dtype: str = "float32"):
    """Plain PyTorch version of ``fused_edge_conv_lowrank_bwd``: the
    gradients of ``fused_edge_conv_lowrank`` with respect to (h_blocked,
    x_src, w3, b3), written out, w3's and b3's in the model's column layout.
    Materializes the per-slot uv and duv [slots, r*(c_in+c_out)]."""
    dt = _gemm_dtype(gemm_dtype)
    slots = h_blocked.shape[0]
    dmsg = _dmsg_plain(g, s, dt, rows_blk=rows_blk, blk=blk)
    h = h_blocked.to(dt).float()
    xs = x_src.to(dt).float()
    w3f = w3.to(dt).float()
    u, v = _lowrank_parts(h @ w3f + b3.float(), c_in, c_out, rank)
    t = torch.einsum("ei,eiq->eq", xs, u)
    d_t = torch.einsum("eo,eoq->eq", dmsg, v)
    dx_src = torch.einsum("eiq,eq->ei", u, d_t)
    duv = torch.cat([(xs[:, :, None] * d_t[:, None, :]).reshape(slots, -1),
                     (dmsg[:, :, None] * t[:, None, :]).reshape(slots, -1)],
                    dim=1)
    return duv @ w3f.t(), dx_src, h.t() @ duv, duv.sum(0)


def fused_edge_conv_lowrank_bwd_cuda(g, h_blocked, x_src, w3, b3, s, *,
                                     c_in: int, c_out: int, rank: int,
                                     rows_blk: int, blk: int):
    """Launches the rank-r backward kernels on the current stream, on the
    tensor cores for both types at every rank (``design``):
    csrc/fused_edge_conv_lowrank_bwd_wgmma.cu for bfloat16 (at a rank other
    than its ``padded_rank``, after w3 padded to it, into scratch), csrc/fused_edge_conv_lowrank_bwd_f32_wgmma.cu for float32
    (after the stage image of w3 and b3, into scratch).  h_blocked, x_src
    and w3 share one dtype (float32 or bfloat16, the GEMM input type); g, b3
    and S are float32, slot_rows int32.  Checks every operand and raises on
    what the kernel does not take; raises if the launch fails.  Returns (dh,
    dx_src, dw3, db3), float32, dw3/db3 in the model's columns: the kernel's
    per-split partials summed in a fixed order."""
    dt = h_blocked.dtype
    slots, k = h_blocked.shape
    _check_geometry(dt, slots, rows_blk, blk, _MAX_WIDTH, _LOWRANK_PAST, K=k,
                    c_in=c_in, c_out=c_out, rank=rank)
    nb, ncol = slots // blk, rank * (c_in + c_out)
    _check("g", g, torch.float32, (nb * rows_blk, c_out))
    _check("h_blocked", h_blocked, dt, (slots, k))
    _check("x_src", x_src, dt, (slots, c_in))
    _check("w3", w3, dt, (k, ncol))
    _check("b3", b3, torch.float32, (ncol,))
    ptrs = _s_pointers(s, slots, nb, rows_blk, blk)
    dev = h_blocked.device
    for name, t in (("g", g), ("x_src", x_src), ("w3", w3), ("b3", b3)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, h_blocked on {dev}")
    name = _lowrank_library(dt, backward=True)
    lib = _load_kernel(name)
    f32 = dict(dtype=torch.float32, device=dev)
    dh = torch.empty((slots, k), **f32)
    dx_src = torch.empty((slots, c_in), **f32)
    # scratch between the launches: per-slot dmsg (already rounded to the
    # GEMM type), t and dt at the padded rank
    dmsg = torch.empty((slots, c_out), dtype=dt, device=dev)
    t_vec = torch.empty((slots, padded_rank(rank)), **f32)
    dt_vec = torch.empty((slots, padded_rank(rank)), **f32)
    col_tiles, row_tiles = lowrank_weight_tiles(k, c_in, c_out, rank)
    splits = _weight_splits(slots, col_tiles * row_tiles, dev)
    partial = torch.empty((splits, k + 1, ncol), **f32)
    scratch = _lowrank_scratch(dt, k, c_in, c_out, rank, True, dev)
    with torch.cuda.device(dev):
        err = getattr(lib, _BINDINGS[name][0][0])(
            g.data_ptr(), h_blocked.data_ptr(), x_src.data_ptr(),
            w3.data_ptr(), b3.data_ptr(), *ptrs, scratch.data_ptr(),
            dh.data_ptr(), dx_src.data_ptr(), dmsg.data_ptr(),
            t_vec.data_ptr(), dt_vec.data_ptr(), partial.data_ptr(), nb, blk,
            k, c_in, c_out, rank, splits,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        smem = getattr(lib, f"{name}_smem_bytes")(k, c_in, c_out, rank)
        raise RuntimeError(
            f"{name} kernel launch failed: cudaError {err} (K={k}, "
            f"c_in={c_in}, c_out={c_out}, rank={rank}: {smem} B of shared "
            "memory per block)")
    fused_edge_conv_lowrank_bwd.launches += 1
    total = partial.sum(0)
    return dh, dx_src, total[:k], total[k]


def fused_edge_conv_lowrank_bwd(g, h_blocked, x_src, w3, b3, s, *, c_in: int,
                                c_out: int, rank: int, rows_blk: int, blk: int,
                                gemm_dtype: str = "float32"):
    """Backward of ``fused_edge_conv_lowrank`` with respect to (h_blocked,
    x_src, w3, b3), given g [num_blocks*rows_blk, c_out] and x_src =
    x[senders_perm]: what the JAX package's ``_fused_lowrank_bwd_jit``
    returns after its unpermute.  Returns (dh [slots, K], dx_src
    [slots, c_in], dw3 [K, r*(c_in+c_out)], db3 [r*(c_in+c_out)]), float32.

    CUDA operands launch the kernel (``fused_edge_conv_lowrank_bwd.launches``
    counts the launches); CPU operands run
    ``fused_edge_conv_lowrank_bwd_plain``.
    """
    kw = dict(c_in=c_in, c_out=c_out, rank=rank, rows_blk=rows_blk, blk=blk)
    if h_blocked.device.type == "cpu":
        return fused_edge_conv_lowrank_bwd_plain(g, h_blocked, x_src, w3, b3,
                                                 s, gemm_dtype=gemm_dtype,
                                                 **kw)
    dt = _gemm_dtype(gemm_dtype)
    return fused_edge_conv_lowrank_bwd_cuda(
        g.float().contiguous(), h_blocked.to(dt).contiguous(),
        x_src.to(dt).contiguous(), w3.to(dt).contiguous(),
        b3.float().contiguous(), s, **kw)


fused_edge_conv_lowrank_bwd.launches = 0


class FusedEdgeConvLowrank(torch.autograd.Function):
    """The differentiable rank-r fused layer: forward through
    ``fused_edge_conv_lowrank`` (B3), backward through
    ``fused_edge_conv_lowrank_bwd`` (B4) and ``scatter_dx`` over the dump
    row.  It saves only its inputs, never the per-slot uv: the backward
    recomputes it tile by tile.  Gradients flow to h_blocked, x, w3 and b3,
    in their own dtypes; S and the aux get none."""

    @staticmethod
    def forward(ctx, h_blocked, x, w3, b3, s, fused_aux, c_in, c_out, rank,
                rows_blk, blk, gemm_dtype):
        ctx.save_for_backward(h_blocked, x, w3, b3)
        ctx.s, ctx.aux = s, fused_aux
        ctx.kw = dict(c_in=c_in, c_out=c_out, rank=rank, rows_blk=rows_blk,
                      blk=blk, gemm_dtype=gemm_dtype)
        return fused_edge_conv_lowrank(h_blocked, x, fused_aux["senders_perm"],
                                       w3, b3, s, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        h_blocked, x, w3, b3 = ctx.saved_tensors
        x_src = x[ctx.aux["senders_perm"].long()]
        dh, dx_src, dw3, db3 = fused_edge_conv_lowrank_bwd(
            g, h_blocked, x_src, w3, b3, ctx.s, **ctx.kw)
        dx = scatter_dx(dx_src, ctx.aux["senders_dump"], x.shape[0])
        return (dh.to(h_blocked.dtype), dx.to(x.dtype), dw3.to(w3.dtype),
                db3.to(b3.dtype)) + (None,) * 8


def fused_edge_conv_lowrank_ad(h_blocked, x, w3, b3, s, fused_aux, *,
                               c_in: int, c_out: int, rank: int,
                               rows_blk: int, blk: int,
                               gemm_dtype: str = "float32") -> torch.Tensor:
    """Differentiable rank-r fused conv layer (training path), the
    counterpart of the JAX package's custom-VJP
    ``fused_edge_conv_lowrank_ad``; operands as ``fused_edge_conv_ad``'s."""
    return FusedEdgeConvLowrank.apply(h_blocked, x, w3, b3, s, fused_aux,
                                      c_in, c_out, rank, rows_blk, blk,
                                      gemm_dtype)
