"""Wall shear stress post-pass: LSQ gradients and surface tensor math in torch.

Port of the JAX package's ``physics/wss.py`` (which replaces the reference's
compute_wss.py:5-120).  The surface is host numpy, copied: boundary-face
extraction for the linear cell zoo or from Fluent face zones, and
area-weighted, outward-oriented point normals (vtkDataSetSurfaceFilter +
vtkPolyDataNormals in the reference).  The gradients and the stress run in
torch on ``device`` (``cuda`` unless ``device="cpu"``):

    tau = mu * (grad_u + grad_u^T) . n;  tau_wall = tau - (tau.n) n
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .divergence import build_node_neighbors, compute_gradient_weights

# Face decompositions for the linear 3D cell zoo, keyed by nodes-per-cell.
# Node orderings are VTK's (tet=10, pyramid=14, wedge=13, hexahedron=12);
# each face template is a proper perimeter cycle (fan triangulation of the
# cycle gives the polygon's area vector).  Winding per template is
# irrelevant — orientation is re-fixed against the owner-cell centroid.
_CELL_FACES = {
    4: [[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]],
    5: [[0, 1, 2, 3], [0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]],
    6: [[0, 1, 2], [3, 4, 5], [0, 1, 4, 3], [1, 2, 5, 4], [2, 0, 3, 5]],
    8: [[0, 1, 2, 3], [4, 5, 6, 7], [0, 1, 5, 4], [1, 2, 6, 5],
        [2, 3, 7, 6], [3, 0, 4, 7]],
}


def _cell_groups(cells):
    """Yields (cell_indices, [Cg, k] int array) per distinct node count."""
    if isinstance(cells, np.ndarray) and cells.ndim == 2:
        yield np.arange(len(cells)), cells.astype(np.int64, copy=False)
        return
    sizes = np.array([len(c) for c in cells])
    for k in np.unique(sizes):
        idx = np.nonzero(sizes == k)[0]
        yield idx, np.stack([np.asarray(cells[i], np.int64) for i in idx])


def _polygon_area_vectors(points: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area vectors [F, 3] of uniform-size polygon faces [F, k] (fan from
    corner 0; exact for planar faces, the standard approximation otherwise)."""
    tri = points[faces]                           # [F, k, 3]
    area = np.zeros((len(faces), 3), points.dtype)
    for i in range(1, faces.shape[1] - 1):
        area += 0.5 * np.cross(tri[:, i] - tri[:, 0], tri[:, i + 1] - tri[:, 0])
    return area


def _orient_outward(points, faces, owner_centroids):
    """Reverses face cycles whose area vector points toward the owner cell
    (vtkPolyDataNormals consistency, compute_wss.py:53-58)."""
    area = _polygon_area_vectors(points, faces)
    face_cent = points[faces].mean(axis=1)
    flip = np.einsum("fd,fd->f", area, face_cent - owner_centroids) < 0
    faces[flip] = faces[flip][:, ::-1]
    return faces


def extract_boundary_faces(points: np.ndarray, cells):
    """Boundary polygons of a tet/hex/wedge/pyramid/mixed mesh (host-side).

    Equivalent of vtkDataSetSurfaceFilter (compute_wss.py:45-48) for the
    whole linear cell zoo — the reference handles every cell type there, and
    real ANSYS meshes are hex/poly-dominant; faces used
    by exactly one cell, cycles oriented so normals point away from the
    owning cell's centroid (vtkPolyDataNormals consistency, :53-58).

    Args:
      points: [N, 3].
      cells: [C, k] uniform int array (k in {4, 5, 6, 8}: tet, pyramid,
        wedge, hex) or a ragged list/object array mixing those sizes.
        Polyhedral (face-defined) meshes have no cell array — use
        ``wall_surface_from_fluent`` on the face zones instead.

    Returns:
      [F, 3] int array for all-triangle surfaces (tet-mesh compatibility),
      else a list of per-face node-id arrays.
    """
    blocks = []     # (faces [Fg, m], owner cell ids)
    for idx, grp in _cell_groups(cells):
        k = grp.shape[1]
        if k not in _CELL_FACES:
            raise ValueError(
                f"unsupported cell with {k} nodes (supported: tet=4, "
                "pyramid=5, wedge=6, hex=8; polyhedral meshes go through "
                "wall_surface_from_fluent)")
        cent = points[grp].mean(axis=1)
        for tmpl in _CELL_FACES[k]:
            blocks.append((grp[:, tmpl], idx, cent))

    kmax = max(f.shape[1] for f, _, _ in blocks)
    keys = [np.pad(np.sort(f, axis=1), ((0, 0), (0, kmax - f.shape[1])),
                   constant_values=-1) for f, _, _ in blocks]
    key = np.concatenate(keys, axis=0)
    _, inv, counts = np.unique(key, axis=0, return_inverse=True,
                               return_counts=True)
    boundary = counts[inv] == 1

    out, pos = [], 0
    for f, _, cent in blocks:
        m = boundary[pos:pos + len(f)]
        pos += len(f)
        if m.any():
            out.append(_orient_outward(points, f[m].copy(), cent[m]))
    if not out:
        # fully periodic / watertight-interior input: no face is used by
        # exactly one cell.  Return an empty surface in the uniform form
        # (same degenerate contract as wall_surface_from_fluent) instead of
        # an opaque IndexError from out[0]
        return np.zeros((0, 3), np.int64)
    if all(f.shape[1] == out[0].shape[1] for f in out):
        return np.concatenate(out, axis=0)
    return [face for blk in out for face in blk]


def wall_surface_from_fluent(mesh, wall_only: bool = True):
    """Boundary polygons straight from Fluent face zones (host-side).

    Fluent meshes are face-based (data/fluent_mesh.py) — polyhedral cell
    zones (element-type 7, reference dataset/GraphDataset.py:323-325)
    never materialize a cell array, so the surface comes from the zones
    directly: wall zones (bc_type 3 / name 'wall') by default, every
    boundary face (c1 < 0 and c0 < 0 sides included) with wall_only=False.
    Faces are oriented away from their owning cell's centroid.

    Returns the same ragged/uniform faces form as extract_boundary_faces.
    """
    pts = np.asarray(mesh.points)
    # approximate owner centroids from face incidence (exact enough for
    # orientation): mean of each cell's node positions
    cell_sets = mesh.cell_point_sets()
    cents = np.stack([pts[c].mean(axis=0) for c in cell_sets]) \
        if cell_sets else np.zeros((0, 3), pts.dtype)

    from ..data.fluent_mesh import BC_WALL

    faces, owners = [], []
    for zone in mesh.face_zones:
        is_wall = zone.bc_type == BC_WALL or "wall" in zone.name
        if wall_only and not is_wall:
            continue
        fn = zone.face_nodes
        fl = list(fn) if not (isinstance(fn, np.ndarray) and fn.ndim == 2) \
            else [fn[i] for i in range(len(fn))]
        for i, f in enumerate(fl):
            c0 = int(zone.c0[i]) if len(zone.c0) else -1
            c1 = int(zone.c1[i]) if len(zone.c1) else -1
            if not wall_only and c0 >= 0 and c1 >= 0:
                continue        # interior face: not part of the surface
            owner = c0 if c0 >= 0 else c1
            if owner < 0:
                continue
            faces.append(np.asarray(f, np.int64))
            owners.append(owner)
    if not faces:
        # same degenerate contract as extract_boundary_faces: an empty
        # uniform faces array, not a bare list
        return np.zeros((0, 3), np.int64)
    sizes = np.array([len(f) for f in faces])
    owners = np.asarray(owners)
    out_by_size = []
    for k in np.unique(sizes):
        sel = np.nonzero(sizes == k)[0]
        grp = np.stack([faces[i] for i in sel])
        out_by_size.append(_orient_outward(pts, grp, cents[owners[sel]]))
    if len(out_by_size) == 1:
        return out_by_size[0]
    return [face for blk in out_by_size for face in blk]


def point_normals(points: np.ndarray, faces) -> tuple[np.ndarray, np.ndarray]:
    """Area-weighted point normals on the boundary surface.

    ``faces`` is a uniform [F, k] polygon array or a ragged list of per-face
    node-id arrays (mixed tri/quad/polygon surfaces).
    Returns (surface_point_ids, unit normals [S, 3]).
    """
    acc = np.zeros_like(points, dtype=np.float64)
    all_ids = []
    for _, grp in _cell_groups(faces):
        fn = _polygon_area_vectors(points, grp)
        for corner in range(grp.shape[1]):
            np.add.at(acc, grp[:, corner], fn)
        all_ids.append(grp.reshape(-1))
    surf_ids = np.unique(np.concatenate(all_ids))
    n = acc[surf_ids]
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    return surf_ids, n.astype(points.dtype, copy=False)


def velocity_gradients(points: torch.Tensor, velocity: torch.Tensor,
                       nbr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-node velocity gradient tensors [N, 3, 3]: grad[i][c, d] = d u_d / d x_c,
    through the true-gradient LSQ weights (exact on linear fields), the
    stand-in for vtkGradientFilter (compute_wss.py:36-42)."""
    w = compute_gradient_weights(points, nbr, mask)               # [N, 3, K]
    dv = (velocity[nbr] - velocity[:, None, :]) * mask[..., None]  # [N, K, 3]
    return (w[:, :, :, None] * dv[:, None, :, :]).sum(2)


def wall_shear_stress_from_gradients(grads: torch.Tensor, normals: torch.Tensor,
                                     dynamic_viscosity: float = 1.0):
    """tau_wall and |tau_wall| (compute_wss.py:82-98, vectorized)."""
    stress = dynamic_viscosity * (grads + grads.transpose(1, 2))
    tau_total = (stress * normals[:, None, :]).sum(2)
    tau_normal = (tau_total * normals).sum(1)
    tau_wall = tau_total - tau_normal[:, None] * normals
    return tau_wall, torch.linalg.vector_norm(tau_wall, dim=1)


def compute_wall_shear_stress(points: np.ndarray, cells, edges: np.ndarray,
                              velocity: np.ndarray,
                              dynamic_viscosity: float = 1.0,
                              output_filename: str | None = None,
                              faces=None, device=None):
    """The whole post-pass; with ``output_filename`` it writes the .vtp
    surface as the reference does (compute_wss.py:113-116).  Returns
    (surface_point_ids, tau_wall, |tau|) as numpy arrays.

    ``faces`` overrides the boundary extraction with a precomputed surface
    (``wall_surface_from_fluent`` for polyhedral Fluent meshes, which have
    no cell array); ``cells`` may then be None.  The gradients run on
    ``device``."""
    dev = resolve_device(device)
    if faces is None:
        faces = extract_boundary_faces(points, cells)
    surf_ids, normals = point_normals(points, faces)
    nbr, mask = build_node_neighbors(edges, len(points))
    grads = velocity_gradients(
        torch.as_tensor(np.asarray(points, np.float32), device=dev),
        torch.as_tensor(np.asarray(velocity, np.float32), device=dev),
        torch.as_tensor(nbr, dtype=torch.long, device=dev),
        torch.as_tensor(mask, device=dev))
    tau, mag = wall_shear_stress_from_gradients(
        grads[torch.as_tensor(surf_ids, device=dev)],
        torch.as_tensor(np.asarray(normals, np.float32), device=dev),
        dynamic_viscosity)
    tau, mag = tau.cpu().numpy(), mag.cpu().numpy()
    print(f"Wall shear stress computed. Max magnitude: {mag.max():.6f} Pa")
    print(f"Mean magnitude: {mag.mean():.6f} Pa")

    if output_filename is not None:
        from ..data.vtu import write_vtp_polydata

        local = np.full(len(points), -1, np.int64)
        local[surf_ids] = np.arange(len(surf_ids))
        faces_local = local[faces] if isinstance(faces, np.ndarray) \
            else [local[f] for f in faces]
        write_vtp_polydata(
            output_filename.replace(".vtu", ".vtp"), points[surf_ids], faces_local,
            point_data={
                "Normals": normals.astype(np.float32),
                "WallShearStressVector": tau.astype(np.float32),
                "WallShearStressMagnitude": mag.astype(np.float32),
            })
        print(f"Results written to: {output_filename.replace('.vtu', '.vtp')}")
    return surf_ids, tau, mag
