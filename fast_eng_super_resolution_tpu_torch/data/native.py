"""ctypes bindings for the native host tensorizer (runtime/libtensorizer.so).

Auto-builds on first use if a compiler is available; every entry point has a
pure-Python/numpy fallback (data/tensorize.py, data/partition.py), so the
framework runs anywhere — the native path is a throughput optimization for
>1M-node mesh ETL (SURVEY §7 P3).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_RUNTIME_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "runtime")
_LIB_PATH = os.path.join(_RUNTIME_DIR, "libtensorizer.so")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    src = os.path.join(_RUNTIME_DIR, "tensorizer.cpp")
    stale = (not os.path.exists(_LIB_PATH)
             or (os.path.exists(src)
                 and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)))
    if stale:
        # always rebuild when the source is newer: a stale (or foreign-host,
        # -march=native) binary would silently shadow edits or SIGILL
        try:
            subprocess.run(["make", "-C", _RUNTIME_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            if not os.path.exists(_LIB_PATH):
                return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    try:
        _bind(lib)
    except AttributeError:
        # stale prebuilt .so missing a later-added symbol: honor the module
        # contract (every entry point falls back to numpy) instead of
        # crashing every wrapper
        return None
    _lib = lib
    return _lib


def _bind(lib) -> None:
    lib.cells_to_edges.restype = ctypes.c_int64
    lib.cells_to_edges.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
    lib.rcb_assign.restype = None
    lib.rcb_assign.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double)]
    lib.extract_subdomain.restype = ctypes.c_int64
    lib.extract_subdomain.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.extract_all.restype = ctypes.c_int64
    lib.extract_all.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64)]
    lib.rcb_overlap_assign.restype = ctypes.c_int64
    lib.rcb_overlap_assign.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double)]
    lib.box_intersect_assign.restype = None
    lib.box_intersect_assign.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]


def available() -> bool:
    return _load() is not None


def cells_to_edges_native(cells: np.ndarray) -> np.ndarray | None:
    """Native clique edge extraction for uniform [C, k] cells; None if no lib."""
    lib = _load()
    if lib is None or cells.ndim != 2:
        return None
    cells64 = np.ascontiguousarray(cells, np.int64)
    c, k = cells64.shape
    cap = c * k * (k - 1)
    out = np.empty((cap, 2), np.int32)
    n = lib.cells_to_edges(
        cells64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), c, k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
    if n < 0:
        return None
    return out[:n].copy()


def rcb_assign_native(points: np.ndarray, num_parts: int):
    """Native RCB: returns (assignment [N] int32, boxes [P, 2, 3]); None if no lib."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float64)
    n = len(pts)
    assign = np.empty(n, np.int32)
    boxes = np.empty((num_parts, 6), np.float64)
    lib.rcb_assign(pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
                   num_parts, assign.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                   boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return assign, [(boxes[p, :3].copy(), boxes[p, 3:].copy())
                    for p in range(num_parts)]


def extract_subdomain_native(cells64: np.ndarray, cell_ids: np.ndarray):
    """Full one-pass subdomain extraction (unique nodes + reindexed edges,
    receiver-major).  Returns (gids int64, edges [E,2] int32) or None.

    The GIL is released for the duration of the C call, so calling this from
    a thread pool parallelizes across partitions.
    """
    lib = _load()
    if lib is None or cells64.ndim != 2 or cells64.shape[1] > 16:
        return None
    cell_ids = np.ascontiguousarray(cell_ids, np.int64)
    k = cells64.shape[1]
    n_cells = len(cell_ids)
    gid_cap = n_cells * k + 1
    edge_cap = n_cells * k * (k - 1) + 1
    gids = np.empty(gid_cap, np.int64)
    edges = np.empty((edge_cap, 2), np.int32)
    counts = np.zeros(2, np.int64)
    rc = lib.extract_subdomain(
        cells64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), k,
        cell_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n_cells,
        gids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), gid_cap,
        edges.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), edge_cap,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        return None
    return gids[: counts[0]].copy(), edges[: counts[1]].copy()


def extract_all_native(cells64: np.ndarray, n_points: int,
                       cell_lists: list[np.ndarray]):
    """One-call extraction of EVERY partition's (gids, edges) — the
    round-1 profile showed per-partition extract_subdomain calls (global
    pair-key sort + binary searches) dominating >500k-node ETL.  The C++
    side reuses an O(n_points) local-id map per worker and dedups edges in
    per-receiver buckets.  Returns a list of (gids int64, edges [E,2] int32)
    in ``cell_lists`` order, or None if the native lib is unavailable.
    """
    lib = _load()
    if lib is None or cells64.ndim != 2 or cells64.shape[1] > 16:
        return None
    k = cells64.shape[1]
    ppc = k * (k - 1)
    offsets = np.zeros(len(cell_lists) + 1, np.int64)
    np.cumsum([len(c) for c in cell_lists], out=offsets[1:])
    csr_ids = (np.concatenate([np.ascontiguousarray(c, np.int64)
                               for c in cell_lists])
               if offsets[-1] else np.empty(0, np.int64))
    total_cells = int(offsets[-1])
    gids_buf = np.empty(total_cells * k, np.int64)
    edges_buf = np.empty((total_cells * ppc, 2), np.int32)
    counts = np.zeros(2 * len(cell_lists), np.int64)
    rc = lib.extract_all(
        cells64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), k,
        int(n_points),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        csr_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(cell_lists),
        gids_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        edges_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        return None
    out = []
    for p in range(len(cell_lists)):
        g0, e0 = offsets[p] * k, offsets[p] * ppc
        out.append((gids_buf[g0:g0 + counts[2 * p]].copy(),
                    edges_buf[e0:e0 + counts[2 * p + 1]].copy()))
    return out


def rcb_overlap_assign_native(points: np.ndarray, cells: np.ndarray,
                              num_parts: int, overlap: bool):
    """Whole cell->partition assignment in one threaded C++ call.

    Returns (cell_id_lists, boxes) or None.  Covers centroid/AABB computation,
    RCB, and (overlap mode) box-intersection membership — the host stages that
    dominated >500k-node ETL in numpy.
    """
    lib = _load()
    if lib is None or not (isinstance(cells, np.ndarray) and cells.ndim == 2):
        return None
    pts = np.ascontiguousarray(points, np.float32)
    cells64 = np.ascontiguousarray(cells, np.int64)
    n_cells, k = cells64.shape
    offsets = np.zeros(num_parts + 1, np.int64)
    cap = n_cells * (4 if overlap else 1) + 1
    while True:
        ids = np.empty(cap, np.int64)
        boxes = np.empty((num_parts, 6), np.float64)
        total = lib.rcb_overlap_assign(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            cells64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_cells, k, num_parts, 1 if overlap else 0,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
            boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if total >= 0:
            break
        cap *= 4  # rare: extreme overlap
    lists = [ids[offsets[p]:offsets[p + 1]].copy() for p in range(num_parts)]
    box_list = [(boxes[p, :3].copy(), boxes[p, 3:].copy()) for p in range(num_parts)]
    return lists, box_list


def box_intersect_native(cell_lo: np.ndarray, cell_hi: np.ndarray,
                         boxes: list) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    lo = np.ascontiguousarray(cell_lo, np.float64)
    hi = np.ascontiguousarray(cell_hi, np.float64)
    p = len(boxes)
    flat = np.ascontiguousarray(
        np.concatenate([np.concatenate([b[0], b[1]]) for b in boxes]), np.float64)
    out = np.empty((len(lo), p), np.uint8)
    lib.box_intersect_assign(
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(lo),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), p,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.view(bool)  # uint8 0/1 reinterpreted in place (no copy)
