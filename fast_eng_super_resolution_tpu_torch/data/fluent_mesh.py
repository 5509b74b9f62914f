"""Shared face-based mesh structures for Fluent readers.

Fluent meshes (both legacy .msh and CFF .cas.h5) are *face-based*: the file
stores nodes, faces (node lists), and each face's left/right cell ids — cells
are implicit.  The reference leaned on vtkFLUENTReader/vtkFLUENTCFFReader
(reference dataset/GraphDataset.py:323-330, 914-924) to reconstruct
cells; this module does that reconstruction in vectorized numpy:
cell points = union of the points of the faces touching the cell, which is
exactly the node set VTK's reconstructed cells expose to ``vtk_to_pyg``'s
clique loop (GraphDataset.py:853-865).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Fluent BC types (subset)
BC_INTERIOR = 2
BC_WALL = 3
BC_PRESSURE_INLET = 4
BC_PRESSURE_OUTLET = 5
BC_VELOCITY_INLET = 10


@dataclasses.dataclass
class FaceZone:
    zone_id: int
    bc_type: int
    name: str
    face_nodes: list[np.ndarray] | np.ndarray  # per-face node ids (0-based)
    c0: np.ndarray  # left cell ids, 0-based, -1 = boundary
    c1: np.ndarray


@dataclasses.dataclass
class FluentMesh:
    """Face-based unstructured mesh with zone metadata."""

    points: np.ndarray              # [N, 3] float
    face_zones: list[FaceZone]
    num_cells: int
    cell_zone_name: str = "interior-fluid"

    def cell_point_sets(self) -> list[np.ndarray]:
        """Reconstructs per-cell node sets from face incidence (vectorized)."""
        pairs_cell = []
        pairs_node = []
        for zone in self.face_zones:
            fn = zone.face_nodes
            if isinstance(fn, np.ndarray) and fn.ndim == 2:
                counts = np.full(fn.shape[0], fn.shape[1])
                flat = fn.reshape(-1)
            else:
                counts = np.array([len(f) for f in fn])
                flat = np.concatenate(fn) if len(fn) else np.zeros(0, np.int64)
            for cells in (zone.c0, zone.c1):
                rep = np.repeat(cells, counts)
                keep = rep >= 0
                pairs_cell.append(rep[keep])
                pairs_node.append(flat[keep])
        if not pairs_cell:
            return []
        cell_ids = np.concatenate(pairs_cell)
        node_ids = np.concatenate(pairs_node)
        pairs = np.unique(np.stack([cell_ids, node_ids], axis=1), axis=0)
        splits = np.searchsorted(pairs[:, 0], np.arange(1, self.num_cells))
        return np.split(pairs[:, 1], splits)

    def edges(self) -> np.ndarray:
        """Directed node-node edge list via per-cell cliques (dedup both dirs)."""
        from .tensorize import cells_to_edges

        cell_sets = self.cell_point_sets()
        sizes = np.array([len(c) for c in cell_sets])
        chunks = []
        for size in np.unique(sizes):
            group = np.stack([c for c, s in zip(cell_sets, sizes) if s == size])
            chunks.append(cells_to_edges(group))
        allp = np.concatenate(chunks, axis=0)
        return np.unique(allp, axis=0).astype(np.int32)

    def wall_node_indices(self, name_substring: str = "wall") -> np.ndarray:
        """Unique node ids on wall zones (extract_wall_block,
        GraphDataset.py:259-271 selects blocks named 'wall:walls')."""
        ids = []
        for zone in self.face_zones:
            if zone.bc_type == BC_WALL or name_substring in zone.name:
                fn = zone.face_nodes
                if isinstance(fn, np.ndarray) and fn.ndim == 2:
                    ids.append(fn.reshape(-1))
                elif len(fn):
                    ids.append(np.concatenate(fn))
        if not ids:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate(ids)).astype(np.int64)

    def wall_faces(self, name_substring: str = "wall") -> list[np.ndarray]:
        faces = []
        for zone in self.face_zones:
            if zone.bc_type == BC_WALL or name_substring in zone.name:
                fn = zone.face_nodes
                faces.extend(list(fn))
        return faces


def mesh_from_cells(points: np.ndarray, cells: np.ndarray) -> FluentMesh:
    """Builds a face-based FluentMesh from tet cells (test/synthetic helper).

    Interior faces get real c0/c1 adjacency; boundary faces are grouped into
    a single 'walls' zone (wall-node identification downstream goes by zone
    name/bc type, FluentMesh.wall_node_indices).
    """
    tet_faces = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]])
    f = cells[:, tet_faces]                      # [C, 4, 3]
    faces_flat = f.reshape(-1, 3)
    owner = np.repeat(np.arange(len(cells)), 4)
    key = np.sort(faces_flat, axis=1)
    order = np.lexsort((key[:, 2], key[:, 1], key[:, 0]))
    key_s, faces_s, owner_s = key[order], faces_flat[order], owner[order]
    is_dup = np.all(key_s[1:] == key_s[:-1], axis=1)

    interior_faces, ic0, ic1 = [], [], []
    boundary_faces, bc0 = [], []
    i = 0
    while i < len(key_s):
        if i + 1 < len(key_s) and is_dup[i]:
            interior_faces.append(faces_s[i])
            ic0.append(owner_s[i])
            ic1.append(owner_s[i + 1])
            i += 2
        else:
            boundary_faces.append(faces_s[i])
            bc0.append(owner_s[i])
            i += 1

    def _faces_arr(faces):
        # empty face sets must stay int-typed: np.asarray([]) is float64 and
        # cell_point_sets/edges would die casting it (single-tet meshes)
        return (np.asarray(faces, np.int64) if faces
                else np.zeros((0, 3), np.int64))

    zones = [
        FaceZone(2, BC_INTERIOR, "interior:interior-fluid",
                 _faces_arr(interior_faces), np.asarray(ic0, np.int64),
                 np.asarray(ic1, np.int64)),
        FaceZone(3, BC_WALL, "wall:walls",
                 _faces_arr(boundary_faces), np.asarray(bc0, np.int64),
                 np.full(len(boundary_faces), -1)),
    ]
    return FluentMesh(points=np.asarray(points, np.float32), face_zones=zones,
                      num_cells=len(cells))
