"""Mesh -> graph tensorization (vectorized host-side ETL).

Replaces the reference's pure-Python hot loops (SURVEY.md §3.4):
``vtk_to_pyg``'s O(cells * k^2) Python set inserts
(reference dataset/GraphDataset.py:853-865), per-point VTK accessor
loops (:845), and KDTree physics mapping (:871-890) — with numpy-vectorized
equivalents: cell-clique edge extraction via a single unique() over sorted
pair arrays, and scipy cKDTree with parallel queries.  These run once per mesh
(ETL), so host numpy is the right tool; the device path starts at the padded
graph batches.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

# VTK-compatible cell type ids (used by our VTU writer and the partitioner).
VTK_TETRA = 10
VTK_HEXAHEDRON = 12
VTK_WEDGE = 13
VTK_PYRAMID = 14
VTK_TRIANGLE = 5
VTK_QUAD = 9

CELL_NUM_POINTS = {VTK_TETRA: 4, VTK_HEXAHEDRON: 8, VTK_WEDGE: 6, VTK_PYRAMID: 5,
                   VTK_TRIANGLE: 3, VTK_QUAD: 4}

# point-count -> VTK type, resolved per mesh dimension (4 points is a tetra in
# a volume mesh but a quad in a surface mesh)
_NPOINTS_TO_TYPE_3D = {4: VTK_TETRA, 5: VTK_PYRAMID, 6: VTK_WEDGE,
                       8: VTK_HEXAHEDRON}
_NPOINTS_TO_TYPE_2D = {3: VTK_TRIANGLE, 4: VTK_QUAD}


def infer_cell_types(cells, dim: int = 3) -> np.ndarray:
    """[C] uint8 VTK cell type ids from per-cell point counts.

    The Fluent readers support mixed hex/wedge/pyramid/tet meshes
    (fluent_msh.py zone element types; reference vtkFLUENTReader handles the
    same set), so exported VTUs must not hardcode VTK_TETRA.

    Args:
      cells: [C, K] uniform int connectivity, or list/object-array of
        variable-length cells.
      dim: 3 for volume meshes, 2 for surface meshes.
    """
    table = _NPOINTS_TO_TYPE_3D if dim == 3 else _NPOINTS_TO_TYPE_2D
    # Unknown point counts (polyhedra, quadratic cells) degrade to VTK's
    # arbitrary-point-count cell types instead of crashing the export after
    # a completed prediction: VTK_CONVEX_POINT_SET (41) in 3-D, VTK_POLYGON
    # (7) in 2-D — ParaView renders both.
    fallback = np.uint8(41 if dim == 3 else 7)
    warned: set = set()

    def lookup(n: int) -> np.uint8:
        t = table.get(n)
        if t is None:
            if n not in warned:
                warned.add(n)
                print(f"infer_cell_types: unknown {dim}-D cell with {n} "
                      f"points; writing type {int(fallback)}")
            return fallback
        return t

    if isinstance(cells, np.ndarray) and cells.ndim == 2:
        return np.full(len(cells), lookup(cells.shape[1]), np.uint8)
    return np.array([lookup(len(c)) for c in cells], np.uint8)


def cells_to_edges(cells: np.ndarray) -> np.ndarray:
    """Directed edge list from cell cliques (both directions, deduplicated).

    Equivalent to the reference's per-cell j<k double loop over point pairs
    (GraphDataset.py:858-863) but vectorized: for uniform cell arrays
    [num_cells, k] we materialize all ordered pairs and unique() them.

    Args:
      cells: [num_cells, k] int array of node indices (one cell type), or an
        object array / list of variable-length cells.

    Returns:
      edges: [E, 2] int32 (sender, receiver), deduplicated, no self-loops.
    """
    if isinstance(cells, np.ndarray) and cells.ndim == 2:
        from .native import cells_to_edges_native

        native = cells_to_edges_native(cells)
        if native is not None:
            return native
        k = cells.shape[1]
        iu, ju = np.triu_indices(k, 1)
        a = cells[:, iu].reshape(-1)
        b = cells[:, ju].reshape(-1)
    else:
        aa, bb = [], []
        for cell in cells:
            cell = np.asarray(cell)
            k = len(cell)
            iu, ju = np.triu_indices(k, 1)
            aa.append(cell[iu])
            bb.append(cell[ju])
        a = np.concatenate(aa) if aa else np.zeros(0, np.int64)
        b = np.concatenate(bb) if bb else np.zeros(0, np.int64)

    both = np.concatenate([np.stack([a, b], 1), np.stack([b, a], 1)], axis=0)
    both = both[both[:, 0] != both[:, 1]]
    edges = np.unique(both, axis=0)
    return edges.astype(np.int32)


def edge_lengths(pos: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Edge length attribute [E, 1] (GraphDataset.py:866-867)."""
    d = np.linalg.norm(pos[edges[:, 0]] - pos[edges[:, 1]], axis=1)
    return d.astype(np.float32)[:, None]


def map_physics_to_mesh(mesh_points: np.ndarray, physics_points: np.ndarray,
                        workers: int = -1) -> np.ndarray:
    """Nearest-neighbor map from solver output rows to mesh nodes.

    Reference: _map_physics_data_to_mesh (GraphDataset.py:871-890), KDTree
    with 16 workers.  Returns int64 indices into ``physics_points`` rows.
    """
    tree = cKDTree(physics_points)
    _, nearest = tree.query(mesh_points, workers=workers)
    return nearest.astype(np.int64)


def normalize_fields(velocity: np.ndarray, pressure: np.ndarray,
                     style: str = "ansys") -> tuple[np.ndarray, np.ndarray]:
    """Per-mesh normalization.

    'ansys' (GraphDataset.py:960-976): v /= max|v|; p -> (p-min)/max(p-min).
    'duct'  (GraphDataset.py:366-381): v /= max|v|; p /= max(p).

    Degenerate fields (constant pressure -> 0/0 NaN, zero velocity,
    non-positive duct pressure max flipping the sign) skip the divide with
    a warning instead of silently poisoning downstream caches.
    """
    vmax = float(np.max(np.abs(velocity))) if velocity.size else 0.0
    if np.isfinite(vmax) and vmax > 0:
        v = velocity / vmax
    else:
        print(f"Warning: degenerate velocity normalization (max |v| = "
              f"{vmax}); leaving unscaled")
        v = velocity
    if style == "ansys":
        p = pressure - np.min(pressure)
    else:
        p = pressure
    pmax = float(np.max(p)) if p.size else 0.0
    if np.isfinite(pmax) and pmax > 0:
        p = p / pmax
    else:
        print(f"Warning: degenerate pressure normalization (max = {pmax}); "
              "leaving unscaled")
    return v.astype(np.float32), p.astype(np.float32)


def get_graph_boundary_edges(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    """Nodes with a single incident edge (GenericGraphDataset.get_graph_boundary_edges,
    GraphDataset.py:165-178: ``where(adj.sum(dim=0) == 1)``).

    The reference's "boundary edges" are really degree-1 *column* indices of
    the dense adjacency; reproduced as stated (its only caller is the
    commented-out BC block at :130-158).  For geometric boundary extraction
    use physics/wss.extract_boundary_faces instead.
    """
    deg = np.bincount(edges[:, 1], minlength=num_nodes)
    return np.where(deg == 1)[0]


def wall_node_indices(wall_cells) -> np.ndarray:
    """Unique node ids appearing in wall surface cells (GraphDataset.py:931-940)."""
    if isinstance(wall_cells, np.ndarray) and wall_cells.ndim == 2:
        return np.unique(wall_cells).astype(np.int64)
    if len(wall_cells) == 0:
        return np.zeros(0, np.int64)
    return np.unique(np.concatenate([np.asarray(c).ravel() for c in wall_cells])).astype(np.int64)
