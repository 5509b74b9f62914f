"""Port of physics/wss.py and the WSS CLI: boundary faces, normals,
gradients, stresses and the ``.vtp`` arrays against the JAX package's on the
same numpy inputs, on the CPU, over the surfaces the JAX package's tests
use (tet duct, hex duct, wedges, a polyhedral Fluent mesh, empty)."""

import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_eng_super_resolution_tpu.data import fluent_mesh as jfm
from fast_eng_super_resolution_tpu.data.synthetic import duct_field, make_duct_mesh
from fast_eng_super_resolution_tpu.data.tensorize import cells_to_edges
from fast_eng_super_resolution_tpu.data.vtu import write_vtu
from fast_eng_super_resolution_tpu.physics import wss as jwss
from fast_eng_super_resolution_tpu_torch.data import fluent_mesh as tfm
from fast_eng_super_resolution_tpu_torch.data.vtu import _decode_data_array
from fast_eng_super_resolution_tpu_torch.physics import divergence as tdiv
from fast_eng_super_resolution_tpu_torch.physics import wss as twss

# float32 LSQ gradients and stresses, sums in different orders: 1e-5 of
# the max (the magnitude's max for the stresses)
TOL = 1e-5


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _hex_duct(nx=9, ny=5, nz=5, L=2.0, W=0.5, H=0.5):
    """Structured hexahedral duct (VTK hexahedron node ordering)."""
    xs, ys, zs = np.linspace(0, L, nx), np.linspace(0, W, ny), np.linspace(0, H, nz)
    pts = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1)
    pts = pts.reshape(-1, 3).astype(np.float32)

    def nid(i, j, k):
        return (i * ny + j) * nz + k

    cells = [[nid(i, j, k), nid(i + 1, j, k), nid(i + 1, j + 1, k),
              nid(i, j + 1, k), nid(i, j, k + 1), nid(i + 1, j, k + 1),
              nid(i + 1, j + 1, k + 1), nid(i, j + 1, k + 1)]
             for i in range(nx - 1) for j in range(ny - 1)
             for k in range(nz - 1)]
    return pts, np.asarray(cells, np.int64)


def _prism_fluent(fm, layers=4, r=1.0, h=0.5):
    """A stack of hexagonal prisms as a face-based (polyhedral) FluentMesh
    of the module ``fm``: no cell array, mixed 4/6-gon wall faces."""
    ang = np.arange(6) * np.pi / 3
    ring = np.stack([r * np.cos(ang), r * np.sin(ang)], 1)
    pts = np.concatenate(
        [np.concatenate([ring, np.full((6, 1), m * h)], 1)
         for m in range(layers + 1)]).astype(np.float32)
    hexf = [np.arange(6, dtype=np.int64) + 6 * m for m in range(layers + 1)]
    interior = [(hexf[m], m - 1, m) for m in range(1, layers)]
    quads = [(np.array([6 * m + i, 6 * m + (i + 1) % 6,
                        6 * (m + 1) + (i + 1) % 6, 6 * (m + 1) + i],
                       np.int64), m)
             for m in range(layers) for i in range(6)]
    zones = [
        fm.FaceZone(2, fm.BC_INTERIOR, "interior:interior-fluid",
                    [f for f, _, _ in interior],
                    np.array([a for _, a, _ in interior], np.int64),
                    np.array([b for _, _, b in interior], np.int64)),
        fm.FaceZone(3, fm.BC_WALL, "wall:walls", [f for f, _ in quads],
                    np.array([c for _, c in quads], np.int64),
                    np.full(len(quads), -1, np.int64)),
        fm.FaceZone(4, fm.BC_WALL, "wall:caps", [hexf[0], hexf[layers]],
                    np.array([0, layers - 1], np.int64),
                    np.array([-1, -1], np.int64)),
    ]
    return fm.FluentMesh(points=pts, face_zones=zones, num_cells=layers)


def _wedges():
    pts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float32)
    return pts, [np.array([0, 1, 3, 4, 5, 7]), np.array([1, 2, 3, 5, 6, 7])]


def _surfaces():
    """(name, points, jax faces, port faces) for every surface kind."""
    duct = make_duct_mesh(10, 6, 6)
    hex_pts, hex_cells = _hex_duct()
    wedge_pts, wedges = _wedges()
    tet = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    twin = np.array([[0, 1, 2, 3], [0, 1, 2, 3]], np.int64)
    out = []
    for name, pts, cells in (("tet_duct", duct.points, duct.cells),
                             ("hex_duct", hex_pts, hex_cells),
                             ("wedges", wedge_pts, wedges),
                             ("empty", tet, twin)):
        out.append((name, pts, jwss.extract_boundary_faces(pts, cells),
                    twss.extract_boundary_faces(pts, cells)))
    jm, tm = _prism_fluent(jfm), _prism_fluent(tfm)
    out.append(("fluent", jm.points, jwss.wall_surface_from_fluent(jm),
                twss.wall_surface_from_fluent(tm)))
    out.append(("fluent_all", jm.points,
                jwss.wall_surface_from_fluent(jm, wall_only=False),
                twss.wall_surface_from_fluent(tm, wall_only=False)))
    empty = jfm.FluentMesh(points=tet, face_zones=[], num_cells=0)
    out.append(("fluent_empty", tet, jwss.wall_surface_from_fluent(empty),
                twss.wall_surface_from_fluent(
                    tfm.FluentMesh(points=tet, face_zones=[], num_cells=0))))
    return out


SURFACES = _surfaces()


@pytest.mark.parametrize("case", SURFACES, ids=[s[0] for s in SURFACES])
def test_boundary_faces_and_normals_equal(case):
    """The host surface is copied: the same faces (uniform or ragged, in the
    same order and winding) and the same point normals."""
    name, pts, ref, got = case
    assert type(ref) is type(got)
    if isinstance(ref, np.ndarray):
        assert ref.dtype == got.dtype
        np.testing.assert_array_equal(ref, got)
    else:
        assert len(ref) == len(got)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)
    if name in ("empty", "fluent_empty"):
        assert isinstance(got, np.ndarray) and got.shape == (0, 3)
        return
    ids_j, n_j = jwss.point_normals(pts, ref)
    ids_t, n_t = twss.point_normals(pts, got)
    np.testing.assert_array_equal(ids_j, ids_t)
    np.testing.assert_array_equal(n_j, n_t)


def test_unsupported_cell_raises():
    pts, _ = _wedges()
    with pytest.raises(ValueError, match="unsupported cell"):
        twss.extract_boundary_faces(pts, np.arange(7, dtype=np.int64)[None, :])


def _fields(points):
    rng = np.random.default_rng(0)
    a = np.array([[1.0, 2.0, -0.5], [0.3, -1.0, 0.7], [0.0, 0.5, 1.5]])
    v, _ = duct_field(points)
    return {"linear": (points @ a.T).astype(np.float32),
            "duct": (v + 0.05 * rng.normal(size=v.shape)).astype(np.float32)}


@pytest.mark.parametrize("field", ["linear", "duct"])
@pytest.mark.parametrize("mesh", ["tet_duct", "hex_duct"])
def test_gradients_and_stress_match_jax(field, mesh):
    if mesh == "tet_duct":
        duct = make_duct_mesh(10, 6, 6)
        pts, cells = duct.points, duct.cells
    else:
        pts, cells = _hex_duct()
    edges = cells_to_edges(cells)
    vel = _fields(pts)[field]
    nbr, mask = tdiv.build_node_neighbors(edges, len(pts))
    ref = np.asarray(jwss.velocity_gradients(
        jnp.asarray(pts), jnp.asarray(vel), jnp.asarray(nbr),
        jnp.asarray(mask)))
    got = twss.velocity_gradients(torch.as_tensor(pts), torch.as_tensor(vel),
                                  torch.as_tensor(nbr).long(),
                                  torch.as_tensor(mask)).numpy()
    assert _rel(got, ref) < TOL
    ids, normals = twss.point_normals(pts, twss.extract_boundary_faces(pts, cells))
    tau_j, mag_j = jwss.wall_shear_stress_from_gradients(
        jnp.asarray(ref[ids]), jnp.asarray(normals), 1e-3)
    tau_t, mag_t = twss.wall_shear_stress_from_gradients(
        torch.as_tensor(ref[ids]), torch.as_tensor(normals), 1e-3)
    assert _rel(tau_t.numpy(), tau_j) < TOL
    assert _rel(mag_t.numpy(), mag_j) < TOL


def _read_vtp(path):
    """PointData arrays and the point count of a ``.vtp`` written by
    ``write_vtp_polydata``."""
    root = ET.parse(path).getroot()
    piece = root.find(".//Piece")
    arrays = {el.get("Name"): _decode_data_array(el)
              for el in piece.find("PointData").findall("DataArray")}
    conn = {el.get("Name"): _decode_data_array(el)
            for el in piece.find("Polys").findall("DataArray")}
    return arrays, int(piece.get("NumberOfPoints")), conn


@pytest.mark.parametrize("mesh", ["tet_duct", "hex_duct", "fluent"])
def test_compute_wall_shear_stress_matches_jax(tmp_path, mesh):
    """The whole post-pass and its ``.vtp`` arrays; analytic shear where the
    JAX package's tests check it (u = (gamma y, 0, 0) on the bottom wall of
    the ducts: |tau| = mu gamma; u = (gamma z, 0, 0) on the prism stack's
    side walls: |tau| = mu gamma |n_x|)."""
    gamma, mu = 2.0, 1e-3
    faces = None
    if mesh == "fluent":
        m = _prism_fluent(tfm)
        pts, cells, edges = m.points, None, m.edges()
        faces = twss.wall_surface_from_fluent(m)
        vel = np.stack([gamma * pts[:, 2], 0 * pts[:, 0], 0 * pts[:, 0]], 1)
    else:
        if mesh == "tet_duct":
            duct = make_duct_mesh(10, 6, 6)
            pts, cells = duct.points, duct.cells
        else:
            pts, cells = _hex_duct()
        edges = cells_to_edges(cells)
        vel = np.stack([gamma * pts[:, 1], 0 * pts[:, 0], 0 * pts[:, 0]], 1)
    vel = vel.astype(np.float32)
    out_j, out_t = str(tmp_path / "j.vtu"), str(tmp_path / "t.vtu")
    ids_j, tau_j, mag_j = jwss.compute_wall_shear_stress(
        pts, cells, edges, vel, mu, out_j, faces=faces)
    ids_t, tau_t, mag_t = twss.compute_wall_shear_stress(
        pts, cells, edges, vel, mu, out_t, faces=faces, device="cpu")
    np.testing.assert_array_equal(ids_j, ids_t)
    assert isinstance(tau_t, np.ndarray) and tau_t.shape == tau_j.shape
    assert np.abs(tau_t - tau_j).max() <= TOL * mag_j.max()
    assert np.abs(mag_t - mag_j).max() <= TOL * mag_j.max()
    (a_j, n_j, c_j), (a_t, n_t, c_t) = (_read_vtp(str(tmp_path / "j.vtp")),
                                        _read_vtp(str(tmp_path / "t.vtp")))
    assert n_j == n_t and sorted(a_j) == sorted(a_t)
    for key in c_j:
        np.testing.assert_array_equal(c_j[key], c_t[key])
    np.testing.assert_array_equal(a_j["Normals"], a_t["Normals"])
    for key in ("WallShearStressVector", "WallShearStressMagnitude"):
        assert np.abs(a_t[key] - a_j[key]).max() <= TOL * mag_j.max(), key
    sp = pts[ids_t]
    if mesh == "fluent":
        _, normals = twss.point_normals(pts, faces)
        mid = (sp[:, 2] > 0.25) & (sp[:, 2] < 1.75)
        np.testing.assert_allclose(mag_t[mid], mu * gamma * np.abs(normals[mid, 0]),
                                   rtol=1e-4)
        return
    bottom = (np.isclose(sp[:, 1], 0) & (sp[:, 0] > 0.3) & (sp[:, 0] < 1.7)
              & (sp[:, 2] > 0.15) & (sp[:, 2] < 0.35))
    assert bottom.sum() > 0
    np.testing.assert_allclose(mag_t[bottom], mu * gamma,
                               rtol=0.15 if mesh == "tet_duct" else 1e-4)


def test_compute_wss_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """``python -m fast_eng_super_resolution_tpu_torch.compute_wss`` on the
    CPU: the three fields, the reference's output names, arrays equal to the
    JAX package's post-pass within TOL; a missing field is skipped."""
    from fast_eng_super_resolution_tpu_torch import compute_wss

    duct = make_duct_mesh(10, 6, 6)
    pts, cells = duct.points, duct.cells
    fields = _fields(pts)
    vtu = str(tmp_path / "pred_0.vtu")
    write_vtu(vtu, pts, cells, np.full(len(cells), 10, np.uint8),
              point_data={"velocity": fields["duct"],
                          "interpolated_velocity": fields["linear"],
                          "pressure": fields["duct"][:, 0]})
    monkeypatch.chdir(tmp_path)
    written = compute_wss.main(["--input", vtu, "--device", "cpu",
                                "--viscosity", "2e-3"])
    assert written == ["wall_shear_stress_results_pred.vtp",
                       "wall_shear_stress_results_interpolated.vtp"]
    assert "skipping ref_velocity: not present" in capsys.readouterr().out
    edges = cells_to_edges(cells)
    for name, tag in (("duct", "pred"), ("linear", "interpolated")):
        got, _, _ = _read_vtp(f"wall_shear_stress_results_{tag}.vtp")
        _, tau, mag = jwss.compute_wall_shear_stress(pts, cells, edges,
                                                     fields[name], 2e-3)
        assert np.abs(got["WallShearStressMagnitude"] - mag).max() <= TOL * mag.max()
        assert np.abs(got["WallShearStressVector"] - tau).max() <= TOL * mag.max()
    assert not os.path.exists("wall_shear_stress_results_reference.vtp")
