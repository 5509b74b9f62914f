"""Synthetic duct meshes + analytic laminar fields (test/bench workload).

SURVEY.md §7 P0: a pure-Python synthetic duct-mesh generator (tet grid in a
duct) standing in for the ANSYS cases, so the framework runs end-to-end with
no external data.  The analytic field is a rectangular-duct laminar profile
(series solution truncated): axial velocity u(y,z) parabolic-like, zero
cross-flow, linear pressure drop — the same normalization pipeline as the real
datasets then applies (tensorize.normalize_fields).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .tensorize import VTK_TETRA, cells_to_edges, edge_lengths

# 6-tet decomposition of a hexahedron (consistent orientation).
_HEX_TO_TETS = np.array([
    [0, 1, 3, 7], [0, 1, 7, 5], [0, 5, 7, 4],
    [1, 2, 3, 7], [1, 7, 2, 6], [1, 7, 6, 5],
])


@dataclasses.dataclass
class DuctMesh:
    points: np.ndarray        # [N, 3] float32
    cells: np.ndarray         # [C, 4] int32 tetrahedra
    cell_types: np.ndarray    # [C] uint8 == VTK_TETRA
    wall_mask: np.ndarray     # [N] bool (duct walls, y/z extremes)


def make_duct_mesh(nx: int = 12, ny: int = 6, nz: int = 6,
                   lx: float = 2.0, ly: float = 0.5, lz: float = 0.5) -> DuctMesh:
    """Structured tet mesh of a rectangular duct [0,lx]x[0,ly]x[0,lz]."""
    xs = np.linspace(0, lx, nx)
    ys = np.linspace(0, ly, ny)
    zs = np.linspace(0, lz, nz)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    points = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)

    def nid(i, j, k):
        return (i * ny + j) * nz + k

    i, j, k = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1),
                          indexing="ij")
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    corners = np.stack([
        nid(i, j, k), nid(i + 1, j, k), nid(i + 1, j + 1, k), nid(i, j + 1, k),
        nid(i, j, k + 1), nid(i + 1, j, k + 1), nid(i + 1, j + 1, k + 1), nid(i, j + 1, k + 1),
    ], axis=1)  # [H, 8]
    cells = corners[:, _HEX_TO_TETS].reshape(-1, 4).astype(np.int32)

    wall = (np.isclose(points[:, 1], 0) | np.isclose(points[:, 1], ly)
            | np.isclose(points[:, 2], 0) | np.isclose(points[:, 2], lz))
    return DuctMesh(points=points, cells=cells,
                    cell_types=np.full(len(cells), VTK_TETRA, np.uint8),
                    wall_mask=wall)


def duct_field(points: np.ndarray, ly: float = 0.5, lz: float = 0.5,
               u0: float = 1.0, n_terms: int = 7) -> tuple[np.ndarray, np.ndarray]:
    """Analytic laminar rectangular-duct flow (series solution).

    Returns velocity [N,3] and pressure [N,1] (pressure drops linearly along x).
    """
    y = points[:, 1] / ly
    z = points[:, 2] / lz
    u = np.zeros(len(points))
    for n in range(1, 2 * n_terms, 2):
        term = (1.0 / n**3) * np.sin(n * np.pi * y) * (
            1 - (np.cosh(n * np.pi * (z - 0.5)) / np.cosh(n * np.pi * 0.5)))
        u += term
    u = u0 * u / max(u.max(), 1e-12)
    velocity = np.stack([u, 0.02 * np.sin(2 * np.pi * y) * np.sin(2 * np.pi * z),
                         np.zeros_like(u)], axis=1)
    x = points[:, 0]
    pressure = (1.0 + (x.max() - x) / max(x.max() - x.min(), 1e-12))[:, None]
    return velocity.astype(np.float32), pressure.astype(np.float32)


def bend_duct(points: np.ndarray, velocity: np.ndarray, lx: float,
              bend_deg: float) -> tuple[np.ndarray, np.ndarray]:
    """Bends a straight duct (axis = x) into a circular arc of ``bend_deg``
    degrees in the x-y plane, rotating velocity vectors with the local frame.

    The reference's duct cases ARE bend angles ("0degree".."60degree",
    configs/exp_config/teecnet_duct.yaml root layout); the straight-duct
    series solution is computed first, then mapped isometrically along the
    centerline: P = C(phi) + yc*n(phi) + z*ez with C the arc through the
    section centroid.  bend_deg=0 returns inputs unchanged.
    """
    theta = float(np.deg2rad(bend_deg))
    if abs(theta) < 1e-9:
        return points, velocity
    x = points[:, 0].astype(np.float64)
    y = points[:, 1].astype(np.float64)
    ymid = (y.max() + y.min()) / 2.0
    yc = y - ymid  # signed in-plane offset from the centerline
    radius = lx / theta
    phi = x / lx * theta
    sin, cos = np.sin(phi), np.cos(phi)
    # centerline C(phi) = (R sin, ymid + R(1-cos)); frame t=(cos,sin),
    # n=(-sin,cos); P = C + yc*n.  At phi=0 this is the identity.
    px = (radius - yc) * sin
    py = ymid + radius * (1 - cos) + yc * cos
    new_points = np.stack([px, py, points[:, 2].astype(np.float64)], 1)
    vx = velocity[:, 0] * cos - velocity[:, 1] * sin
    vy = velocity[:, 0] * sin + velocity[:, 1] * cos
    new_velocity = np.stack([vx, vy, velocity[:, 2]], 1)
    return new_points.astype(np.float32), new_velocity.astype(np.float32)


def obstacle_deflect(points: np.ndarray, velocity: np.ndarray,
                     pressure: np.ndarray, center_x: float, center_y: float,
                     radius: float) -> tuple[np.ndarray, np.ndarray]:
    """Immersed-cylinder blockage (axis = z) inside the duct.

    Physically richer than aspect/bend variation (round-1 quality lever
    list): the axial profile is deflected by the potential-flow solution
    around a cylinder at (center_x, center_y) — u' = u0*(1 - R^2(x^2-y^2)/r^4),
    v' = -2 u0 R^2 xy / r^4 (exact solution of continuity + irrotationality
    outside the body, decaying as R^2/r^2) — with a smooth solid-body damp
    to zero inside the radius (immersed-boundary style; the mesh is not cut)
    and a Bernoulli-consistent pressure perturbation
    p' = p + (|v_before|^2 - |v_after|^2)/2, so stagnation pressure rises
    upstream of the body and drops in the accelerated side lobes.
    """
    x = points[:, 0].astype(np.float64) - center_x
    y = points[:, 1].astype(np.float64) - center_y
    r2 = np.maximum(x * x + y * y, 1e-12)
    rr = radius * radius / r2
    u0 = velocity[:, 0].astype(np.float64)
    v0 = velocity[:, 1].astype(np.float64)
    vx = u0 * (1.0 - rr * (x * x - y * y) / r2)
    vy = v0 - u0 * rr * 2.0 * x * y / r2
    damp = np.clip((np.sqrt(r2) / radius - 0.6) / 0.4, 0.0, 1.0)
    vx *= damp
    vy *= damp
    vz = velocity[:, 2].astype(np.float64) * damp
    p = pressure[:, 0].astype(np.float64) + 0.5 * (
        u0 * u0 + v0 * v0 - vx * vx - vy * vy)
    v = np.stack([vx, vy, vz], axis=1).astype(np.float32)
    return v, p[:, None].astype(np.float32)


def make_sample_pair(n_high=(16, 8, 8), n_low=(8, 4, 4), noise: float = 0.0,
                     seed: int = 0):
    """A (low-res-interpolated-input, high-res-target) training pair.

    Mirrors the reference pipeline: solve on both meshes, interpolate the
    low-res field onto the high-res mesh as ``x``, keep the true high-res field
    as ``y`` (GraphDataset.py:978-1030).  Interpolation here is the same
    Gaussian-kernel scheme as ops/interpolate.py to keep the synthetic workload
    faithful to the real one.
    """
    from ..ops.interpolate import gaussian_interpolate_host

    high = make_duct_mesh(*n_high)
    low = make_duct_mesh(*n_low)
    v_hi, p_hi = duct_field(high.points)
    v_lo, p_lo = duct_field(low.points)
    if noise:
        rng = np.random.default_rng(seed)
        v_lo = v_lo + noise * rng.normal(size=v_lo.shape).astype(np.float32)

    spacing = np.max(low.points.max(0) - low.points.min(0)) / max(n_low)
    fields_lo = np.concatenate([v_lo, p_lo], axis=1)
    fields_interp = gaussian_interpolate_host(low.points, fields_lo, high.points,
                                              radius=float(spacing) * 1.5, sharpness=2.0)

    from .tensorize import normalize_fields
    v_in, p_in = normalize_fields(fields_interp[:, :3], fields_interp[:, 3:4], "ansys")
    v_y, p_y = normalize_fields(v_hi, p_hi, "ansys")

    edges = cells_to_edges(high.cells)
    return {
        "mesh": high,
        "x": np.concatenate([v_in, p_in], axis=1),
        "y": np.concatenate([v_y, p_y], axis=1),
        "pos": high.points,
        "senders": edges[:, 0],
        "receivers": edges[:, 1],
        "edge_attr": edge_lengths(high.points, edges),
    }
