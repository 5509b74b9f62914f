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

On a CUDA tensor the layer launches the hand-written kernel in
``csrc/fused_edge_conv.cu`` (built with nvcc at first use, loaded with
ctypes); on a CPU tensor it runs the plain PyTorch version below, which is
the same function and the reference the kernel is checked against.  Nothing
falls back from one to the other.  Training goes through ``FusedEdgeConv``,
whose backward is the kernel in ``csrc/fused_edge_conv_bwd.cu`` (or its plain
version, ``fused_edge_conv_bwd_plain``, on the CPU).  Models with rank-r
factorized edge kernels (``kernel_rank``) run ``fused_edge_conv_lowrank``
(``csrc/fused_edge_conv_lowrank.cu``) and train through
``FusedEdgeConvLowrank``, whose backward is
``csrc/fused_edge_conv_lowrank_bwd.cu``.
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
# library -> its source: B1 (forward), B2 (backward), and their rank-r
# counterparts B3 and B4
_SOURCES = {"fused_edge_conv": "fused_edge_conv.cu",
            "fused_edge_conv_bwd": "fused_edge_conv_bwd.cu",
            "fused_edge_conv_lowrank": "fused_edge_conv_lowrank.cu",
            "fused_edge_conv_lowrank_bwd": "fused_edge_conv_lowrank_bwd.cu"}
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
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


def build_kernel(force: bool = False) -> list[str]:
    """Compiles each ``csrc/*.cu`` source into its own library under
    ``_build/``, one nvcc per source, all started together; returns the
    library paths.  A library is rebuilt when it is missing or older than
    any file under ``csrc/``.  Each compile goes to a temporary file renamed
    into place, so concurrent builds never load a half-written library.
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
    "fused_edge_conv": (("fused_edge_conv_forward", 9, 7), 3),
    "fused_edge_conv_bwd": (("fused_edge_conv_backward", 12, 7), 3),
    "fused_edge_conv_lowrank": (("fused_edge_conv_lowrank_forward", 9, 8), 4),
    "fused_edge_conv_lowrank_bwd": (("fused_edge_conv_lowrank_backward", 14, 8),
                                    4),
}


def _load_kernel(name: str = "fused_edge_conv"):
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


def _check_geometry(dt, slots: int, rows_blk: int, blk: int, **dims) -> None:
    """Raises on what the kernels do not take: a GEMM type other than
    float32 or bfloat16, blocks of other than 64 rows, a blk that is not a
    positive multiple of 64 dividing the slots, or a width ``dims`` (name=
    value) outside 1..64 (``rank``: 1..32)."""
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"h_blocked dtype {dt} (expected float32 | bfloat16)")
    if rows_blk != 64:
        raise ValueError(f"rows_blk={rows_blk}: the kernel takes 64-row blocks")
    if blk % 64 or blk <= 0:
        raise ValueError(f"blk={blk} must be a positive multiple of 64")
    for name, v in dims.items():
        top = 32 if name == "rank" else 64
        if not 1 <= v <= top:
            raise ValueError(f"{name}={v} outside the kernel's 1..{top}")
    if slots % blk:
        raise ValueError(f"{slots} slots is not a multiple of blk={blk}")


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


def fused_edge_conv_cuda(h_blocked, x, senders_perm, w3, b3, s, *,
                         c_in: int, c_out: int, rows_blk: int,
                         blk: int) -> torch.Tensor:
    """Launches the CUDA kernel on the current stream.  h_blocked, x and w3
    share one dtype (float32 or bfloat16, the GEMM input type); b3 and S are
    float32, index arrays int32.  Checks every operand and raises on what the
    kernel does not take; raises if the launch fails."""
    dt = h_blocked.dtype
    slots, k = h_blocked.shape
    _check_geometry(dt, slots, rows_blk, blk, c_out=c_out)
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
    lib = _load_kernel()
    out = torch.empty((nb * rows_blk, c_out), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_edge_conv_forward(
            h_blocked.data_ptr(), x.data_ptr(), senders_perm.data_ptr(),
            w3.data_ptr(), b3.data_ptr(), *ptrs, out.data_ptr(), nb, blk, k,
            c_in, c_out, n, int(dt == torch.bfloat16), stream)
    if err != 0:
        smem = lib.fused_edge_conv_smem_bytes(k, c_in, c_out)
        raise RuntimeError(
            f"fused_edge_conv kernel launch failed: cudaError {err} "
            f"(K={k}, c_in={c_in}, c_out={c_out}: {smem} B of shared memory "
            "per block)")
    fused_edge_conv.launches += 1
    return out


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


def _weight_splits(slots: int, tiles: int, device) -> int:
    """Slot splits of a backward's weights kernel: about six thread blocks
    per SM over its ``tiles`` output tiles, at least one 64-slot chunk per
    split."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(slots // 64, -(-6 * sms // tiles)))


def fused_edge_conv_bwd_cuda(g, h_blocked, x_src, w3, b3, s, *, c_in: int,
                             c_out: int, rows_blk: int, blk: int):
    """Launches the backward kernel (csrc/fused_edge_conv_bwd.cu) on the
    current stream.  h_blocked, x_src and w3 share one dtype (float32 or
    bfloat16, the GEMM input type); g, b3 and S are float32, slot_rows
    int32.  Checks every operand and raises on what the kernel does not
    take; raises if the launch fails.  Returns (dh, dx_src, dw3, db3),
    float32; dw3/db3 are the kernel's per-split partials summed in a fixed
    order."""
    dt = h_blocked.dtype
    slots, k = h_blocked.shape
    _check_geometry(dt, slots, rows_blk, blk, K=k, c_in=c_in, c_out=c_out)
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
    lib = _load_kernel("fused_edge_conv_bwd")
    f32 = dict(dtype=torch.float32, device=dev)
    dh = torch.empty((slots, k), **f32)
    dx_src = torch.empty((slots, c_in), **f32)
    dmsg = torch.empty((slots, c_out), **f32)  # scratch between the launches
    splits = _weight_splits(slots, -(-c_in // 4), dev)  # 4-channel tiles
    partial = torch.empty((splits, k + 1, c2), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_edge_conv_backward(
            g.data_ptr(), h_blocked.data_ptr(), x_src.data_ptr(),
            w3.data_ptr(), b3.data_ptr(), *ptrs, dh.data_ptr(),
            dx_src.data_ptr(), dmsg.data_ptr(), partial.data_ptr(), nb, blk,
            k, c_in, c_out, splits, int(dt == torch.bfloat16), stream)
    if err != 0:
        smem = lib.fused_edge_conv_bwd_smem_bytes(k, c_in, c_out)
        raise RuntimeError(
            f"fused_edge_conv_bwd kernel launch failed: cudaError {err} "
            f"(K={k}, c_in={c_in}, c_out={c_out}: {smem} B of shared memory "
            "per block)")
    fused_edge_conv_bwd.launches += 1
    total = partial.sum(0)
    return dh, dx_src, total[:k], total[k]


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


def fused_edge_conv_lowrank_cuda(h_blocked, x, senders_perm, w3, b3, s, *,
                                 c_in: int, c_out: int, rank: int,
                                 rows_blk: int, blk: int) -> torch.Tensor:
    """Launches the rank-r forward kernel (csrc/fused_edge_conv_lowrank.cu)
    on the current stream.  h_blocked, x and w3 share one dtype (float32 or
    bfloat16, the GEMM input type); b3 and S are float32, index arrays
    int32.  Checks every operand and raises on what the kernel does not
    take; raises if the launch fails."""
    dt = h_blocked.dtype
    slots, k = h_blocked.shape
    _check_geometry(dt, slots, rows_blk, blk, K=k, c_in=c_in, c_out=c_out,
                    rank=rank)
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
    lib = _load_kernel("fused_edge_conv_lowrank")
    out = torch.empty((nb * rows_blk, c_out), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_edge_conv_lowrank_forward(
            h_blocked.data_ptr(), x.data_ptr(), senders_perm.data_ptr(),
            w3.data_ptr(), b3.data_ptr(), *ptrs, out.data_ptr(), nb, blk, k,
            c_in, c_out, rank, n, int(dt == torch.bfloat16), stream)
    if err != 0:
        smem = lib.fused_edge_conv_lowrank_smem_bytes(k, c_in, c_out, rank)
        raise RuntimeError(
            f"fused_edge_conv_lowrank kernel launch failed: cudaError {err} "
            f"(K={k}, c_in={c_in}, c_out={c_out}, rank={rank}: {smem} B of "
            "shared memory per block)")
    fused_edge_conv_lowrank.launches += 1
    return out


def fused_edge_conv_lowrank(h_blocked, x, senders_perm, w3, b3, s, *,
                            c_in: int, c_out: int, rank: int, rows_blk: int,
                            blk: int,
                            gemm_dtype: str = "float32") -> torch.Tensor:
    """One rank-r conv layer's message+aggregate, the counterpart of the JAX
    package's ``fused_edge_conv_lowrank``: returns [num_blocks*rows_blk,
    c_out] float32.  Operands as ``fused_edge_conv``'s, with w3 [K,
    r*(c_in+c_out)] and b3 [r*(c_in+c_out)] the edge MLP's head in the
    model's column layout.

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
    """Launches the rank-r backward kernel
    (csrc/fused_edge_conv_lowrank_bwd.cu) on the current stream.  h_blocked,
    x_src and w3 share one dtype (float32 or bfloat16, the GEMM input type);
    g, b3 and S are float32, slot_rows int32.  Checks every operand and
    raises on what the kernel does not take; raises if the launch fails.
    Returns (dh, dx_src, dw3, db3), float32; dw3/db3 are the kernel's
    per-split partials summed in a fixed order."""
    dt = h_blocked.dtype
    slots, k = h_blocked.shape
    _check_geometry(dt, slots, rows_blk, blk, K=k, c_in=c_in, c_out=c_out,
                    rank=rank)
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
    lib = _load_kernel("fused_edge_conv_lowrank_bwd")
    f32 = dict(dtype=torch.float32, device=dev)
    dh = torch.empty((slots, k), **f32)
    dx_src = torch.empty((slots, c_in), **f32)
    # scratch between the launches: per-slot dmsg, t and dt
    dmsg = torch.empty((slots, c_out), **f32)
    t_vec = torch.empty((slots, rank), **f32)
    dt_vec = torch.empty((slots, rank), **f32)
    # 8-channel column tiles of the U and the V half
    splits = _weight_splits(slots, -(-c_in // 8) + -(-c_out // 8), dev)
    partial = torch.empty((splits, k + 1, ncol), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_edge_conv_lowrank_backward(
            g.data_ptr(), h_blocked.data_ptr(), x_src.data_ptr(),
            w3.data_ptr(), b3.data_ptr(), *ptrs, dh.data_ptr(),
            dx_src.data_ptr(), dmsg.data_ptr(), t_vec.data_ptr(),
            dt_vec.data_ptr(), partial.data_ptr(), nb, blk, k, c_in, c_out,
            rank, splits, int(dt == torch.bfloat16), stream)
    if err != 0:
        smem = lib.fused_edge_conv_lowrank_bwd_smem_bytes(k, c_in, c_out, rank)
        raise RuntimeError(
            f"fused_edge_conv_lowrank_bwd kernel launch failed: cudaError "
            f"{err} (K={k}, c_in={c_in}, c_out={c_out}, rank={rank}: {smem} B "
            "of shared memory per block)")
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
