"""Spatial domain decomposition (the framework's "context parallelism").

Replaces vtkRedistributeDataSetFilter (METIS-backed kd-tree cuts,
reference dataset/GraphDataset.py:554-576, 1208-1230) with a
load-balanced recursive-coordinate-bisection (RCB) partitioner over cell
centroids.  Supports both reference boundary modes:

- 'one_region'  (SetBoundaryModeToAssignToOneRegion, :565 — duct path): each
  cell goes to the region containing its centroid; nodes on cut planes are
  still duplicated across the partitions that share them.
- 'all_intersecting' (SetBoundaryModeToAssignToAllIntersectingRegions, :1219 —
  ansys path): each cell goes to every region its bounding box intersects,
  producing overlapping subdomains reconciled by overlap averaging at
  reconstruction (reconstruct.py).

Also provides the legacy uniform box-grid partitioner
(GenericGraphDataset._get_partiton_domain, GraphDataset.py:101-163).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .tensorize import cells_to_edges, edge_lengths


@dataclasses.dataclass
class Subdomain:
    """One extracted subdomain with local connectivity + global node ids."""

    x: np.ndarray
    y: np.ndarray
    pos: np.ndarray
    senders: np.ndarray
    receivers: np.ndarray
    edge_attr: np.ndarray
    global_node_ids: np.ndarray
    cell_ids: np.ndarray  # indices into the full-mesh cell array


def rcb_regions(centroids: np.ndarray, num_parts: int,
                bounds: tuple[np.ndarray, np.ndarray] | None = None):
    """Recursive coordinate bisection: returns (assignment [C], boxes list).

    Splits are weighted medians along the longest axis of the current point
    population, so leaf regions have near-equal cell counts (the load-balance
    property the reference gets from vtkRedistributeDataSetFilter).
    """
    n = centroids.shape[0]
    assignment = np.zeros(n, np.int32)
    lo = centroids.min(axis=0) if bounds is None else np.asarray(bounds[0], float)
    hi = centroids.max(axis=0) if bounds is None else np.asarray(bounds[1], float)
    boxes: list[tuple[np.ndarray, np.ndarray]] = [None] * num_parts
    next_label = [0]

    def split(idx: np.ndarray, box_lo: np.ndarray, box_hi: np.ndarray, parts: int):
        if parts == 1:
            label = next_label[0]
            next_label[0] += 1
            assignment[idx] = label
            boxes[label] = (box_lo.copy(), box_hi.copy())
            return
        n_left = parts // 2
        frac = n_left / parts
        pts = centroids[idx]
        axis = int(np.argmax(pts.max(axis=0) - pts.min(axis=0))) if len(idx) else 0
        cut = np.quantile(pts[:, axis], frac) if len(idx) else 0.5 * (box_lo[axis] + box_hi[axis])
        left = idx[pts[:, axis] <= cut]
        right = idx[pts[:, axis] > cut]
        # guard degenerate quantile (many equal coords): rebalance by argsort.
        # An EMPTY idx (num_parts > cell count) skips this — both branches
        # recurse empty and the leaves become empty labeled regions instead
        # of order[-1] indexing an empty array
        if (len(left) == 0 or len(right) == 0) and len(idx) > 0:
            order = idx[np.argsort(pts[:, axis], kind="stable")]
            k = max(1, int(round(frac * len(idx))))
            left, right = order[:k], order[k:]
            cut = centroids[order[min(k, len(idx) - 1)], axis]
        lo_l, hi_l = box_lo.copy(), box_hi.copy()
        hi_l[axis] = cut
        lo_r, hi_r = box_lo.copy(), box_hi.copy()
        lo_r[axis] = cut
        split(left, lo_l, hi_l, n_left)
        split(right, lo_r, hi_r, parts - n_left)

    split(np.arange(n), lo.astype(float), hi.astype(float), num_parts)
    return assignment, boxes


def assign_cells(points: np.ndarray, cells: np.ndarray, num_parts: int,
                 mode: str = "one_region"):
    """Returns per-partition cell-index lists under the requested boundary mode."""
    from .native import rcb_assign_native, rcb_overlap_assign_native

    if mode not in ("one_region", "all_intersecting"):
        raise ValueError(f"unknown boundary mode: {mode}")
    full = rcb_overlap_assign_native(points, cells, num_parts,
                                     overlap=(mode == "all_intersecting"))
    if full is not None:
        return full

    if isinstance(cells, np.ndarray) and cells.ndim == 2:
        pts_at_cells = points[cells]  # one gather reused for centroid + bbox
        centroids = pts_at_cells.mean(axis=1)
        cell_lo = pts_at_cells.min(axis=1)
        cell_hi = pts_at_cells.max(axis=1)
    else:
        # ragged cells (mixed element types, dataset.py builds an object
        # array): per-cell loop — the pure-Python fallback like extract()'s
        per_cell = [points[np.asarray(c, np.int64)] for c in cells]
        centroids = np.stack([p.mean(axis=0) for p in per_cell])
        cell_lo = np.stack([p.min(axis=0) for p in per_cell])
        cell_hi = np.stack([p.max(axis=0) for p in per_cell])
    native = rcb_assign_native(centroids, num_parts)
    if native is not None:
        assignment, boxes = native
    else:
        assignment, boxes = rcb_regions(centroids, num_parts)
    if mode == "one_region":
        return [np.where(assignment == p)[0] for p in range(num_parts)], boxes
    from .native import box_intersect_native

    member = box_intersect_native(cell_lo, cell_hi, boxes)  # threaded C++
    if member is not None:
        return [np.nonzero(member[:, p])[0] for p in range(num_parts)], boxes
    out = []
    for p in range(num_parts):
        blo, bhi = boxes[p]
        hit = np.all(cell_hi >= blo[None, :], axis=1) & np.all(cell_lo <= bhi[None, :], axis=1)
        out.append(np.where(hit)[0])
    return out, boxes


def extract_subdomains(points: np.ndarray, cells: np.ndarray, x: np.ndarray,
                       y: np.ndarray, num_parts: int,
                       mode: str = "all_intersecting",
                       num_workers: int | None = None) -> list[Subdomain]:
    """Full decomposition: RCB assign -> per-partition local graphs.

    Mirrors the reference's per-partition h5 payload (GraphDataset.py:1276-1284):
    x, y, pos, edge_index, edge_attr, global_node_ids.  Per-partition
    extraction is threaded: the hot part (edge extraction) runs in the native
    library, which releases the GIL across the ctypes call.
    """
    cell_lists, _ = assign_cells(points, cells, num_parts, mode)
    cell_lists = [c for c in cell_lists if len(c)]

    from .native import extract_all_native, extract_subdomain_native

    cells64 = (np.ascontiguousarray(cells, np.int64)
               if isinstance(cells, np.ndarray) and cells.ndim == 2 else None)

    # fast path: every partition in ONE native call (shared local-id map,
    # per-receiver bucket dedup) — ~4x over per-partition calls at 500k nodes
    all_native = (extract_all_native(cells64, points.shape[0], cell_lists)
                  if cells64 is not None else None)

    def extract(cell_ids, precomputed=None):
        native = (precomputed if precomputed is not None else
                  (extract_subdomain_native(cells64, cell_ids)
                   if cells64 is not None else None))
        if native is not None:
            gids, edges = native  # one-pass C++: unique+reindex+edges
        elif isinstance(cells, np.ndarray) and cells.ndim == 2:
            sub_cells = cells[cell_ids]
            gids = np.unique(sub_cells)
            local = np.full(points.shape[0], -1, np.int64)
            local[gids] = np.arange(len(gids))
            edges = cells_to_edges(local[sub_cells])
        else:  # ragged cells (mixed element types): pure-Python fallback
            sub_cells = [np.asarray(cells[int(i)], np.int64) for i in cell_ids]
            gids = np.unique(np.concatenate(sub_cells)) if sub_cells \
                else np.empty(0, np.int64)
            local = np.full(points.shape[0], -1, np.int64)
            local[gids] = np.arange(len(gids))
            edges = cells_to_edges([local[c] for c in sub_cells])
        pos = points[gids]
        return Subdomain(
            x=x[gids].astype(np.float32), y=y[gids].astype(np.float32),
            pos=pos.astype(np.float32),
            senders=edges[:, 0], receivers=edges[:, 1],
            edge_attr=edge_lengths(pos, edges),
            global_node_ids=gids.astype(np.int64),
            cell_ids=np.asarray(cell_ids, np.int64),
        )

    if all_native is not None:
        return [extract(c, precomputed=pre)
                for c, pre in zip(cell_lists, all_native)]

    if num_workers == 1 or len(cell_lists) <= 1:
        return [extract(c) for c in cell_lists]
    from concurrent.futures import ThreadPoolExecutor

    workers = num_workers or min(8, len(cell_lists))
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(extract, cell_lists))


def uniform_box_subdomains(points: np.ndarray, cells: np.ndarray, x: np.ndarray,
                           y: np.ndarray, sub_size: float) -> list[Subdomain]:
    """Legacy uniform-grid partitioner (GraphDataset.py:121-161): axis-aligned
    cubes of edge ``sub_size``; cells binned by centroid."""
    centroids = points[cells].mean(axis=1)
    lo = points.min(axis=0)
    bins = np.floor((centroids - lo) / sub_size).astype(np.int64)
    # row-wise unique (NOT a scalar hash: XOR spatial hashes collide within
    # realistic bin ranges and would silently merge disjoint boxes)
    _, inverse = np.unique(bins, axis=0, return_inverse=True)
    subs = []
    for key in range(int(inverse.max()) + 1 if len(inverse) else 0):
        cell_ids = np.where(inverse == key)[0]
        sub_cells = cells[cell_ids]
        gids = np.unique(sub_cells)
        local = np.full(points.shape[0], -1, np.int64)
        local[gids] = np.arange(len(gids))
        edges = cells_to_edges(local[sub_cells])
        pos = points[gids]
        subs.append(Subdomain(
            x=x[gids].astype(np.float32), y=y[gids].astype(np.float32),
            pos=pos.astype(np.float32), senders=edges[:, 0], receivers=edges[:, 1],
            edge_attr=edge_lengths(pos, edges), global_node_ids=gids.astype(np.int64),
            cell_ids=cell_ids.astype(np.int64),
        ))
    return subs
