"""VTU (VTK XML UnstructuredGrid) writer/reader — no VTK dependency.

The reference shells out to vtkXMLUnstructuredGridWriter/Reader
(reference run_ALDS_3D.py:34-38, compute_wss.py:122-133); this module
implements the format directly: XML ``<VTKFile type="UnstructuredGrid">`` with
base64-encoded binary DataArrays (header_type UInt64, no compression), the
same structural content ParaView reads.  Field dtypes follow the reference's
32-bit downcast convention (convert_all_mesh_arrays_to_32bit,
GraphDataset.py:2055-2170): Float32 points/fields, Int32 connectivity.

Writer and reader round-trip (tests/test_vtu.py); the reader also accepts
ascii-format DataArrays for interop.
"""

from __future__ import annotations

import base64
import struct
import xml.etree.ElementTree as ET

import numpy as np

_DTYPES = {
    "Float32": np.float32, "Float64": np.float64,
    "Int32": np.int32, "Int64": np.int64,
    "UInt8": np.uint8, "UInt32": np.uint32, "UInt64": np.uint64,
    "Int8": np.int8, "Int16": np.int16, "UInt16": np.uint16,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _flatten_cells(cells) -> tuple[np.ndarray, np.ndarray, int]:
    """(connectivity, offsets, n_cells) from uniform [C, K] or ragged cells
    (one implementation shared by the VTU and VTP writers)."""
    if isinstance(cells, np.ndarray) and cells.ndim == 2:
        connectivity = cells.reshape(-1).astype(np.int32)
        offsets = (np.arange(1, cells.shape[0] + 1)
                   * cells.shape[1]).astype(np.int32)
        return connectivity, offsets, cells.shape[0]
    if not len(cells):
        return np.zeros(0, np.int32), np.zeros(0, np.int32), 0
    connectivity = np.concatenate(
        [np.asarray(c).ravel() for c in cells]).astype(np.int32)
    offsets = np.cumsum([len(c) for c in cells]).astype(np.int32)
    return connectivity, offsets, len(cells)


def _b64(arr: np.ndarray) -> str:
    raw = np.ascontiguousarray(arr).tobytes()
    return base64.b64encode(struct.pack("<Q", len(raw)) + raw).decode("ascii")


def _data_array(name: str | None, arr: np.ndarray) -> str:
    arr = np.asarray(arr)
    ncomp = 1 if arr.ndim == 1 else arr.shape[1]
    dtype_name = _NAMES[arr.dtype.type]
    name_attr = f' Name="{name}"' if name else ""
    return (f'<DataArray type="{dtype_name}"{name_attr} '
            f'NumberOfComponents="{ncomp}" format="binary">{_b64(arr)}</DataArray>')


def write_vtu(path: str, points: np.ndarray, cells: np.ndarray,
              cell_types: np.ndarray, point_data: dict[str, np.ndarray] | None = None,
              cell_data: dict[str, np.ndarray] | None = None) -> None:
    """Writes an unstructured grid.

    Args:
      points: [N, 3] float.
      cells: [C, K] uniform int connectivity, or list/object-array of
        variable-length cells.
      cell_types: [C] uint8 VTK cell type ids (tensorize.VTK_*).
      point_data / cell_data: name -> [N(,c)] / [C(,c)] arrays.
    """
    points = np.asarray(points, np.float32)
    connectivity, offsets, ncells = _flatten_cells(cells)
    cell_types = np.asarray(cell_types, np.uint8)

    parts = [
        '<?xml version="1.0"?>',
        '<VTKFile type="UnstructuredGrid" version="1.0" byte_order="LittleEndian" header_type="UInt64">',
        "<UnstructuredGrid>",
        f'<Piece NumberOfPoints="{len(points)}" NumberOfCells="{ncells}">',
    ]
    if point_data:
        parts.append("<PointData>")
        for name, arr in point_data.items():
            parts.append(_data_array(name, np.asarray(arr, np.float32)))
        parts.append("</PointData>")
    if cell_data:
        parts.append("<CellData>")
        for name, arr in cell_data.items():
            parts.append(_data_array(name, np.asarray(arr, np.float32)))
        parts.append("</CellData>")
    parts.append("<Points>")
    parts.append(_data_array(None, points))
    parts.append("</Points>")
    parts.append("<Cells>")
    parts.append(_data_array("connectivity", connectivity))
    parts.append(_data_array("offsets", offsets))
    parts.append(_data_array("types", cell_types))
    parts.append("</Cells>")
    parts.extend(["</Piece>", "</UnstructuredGrid>", "</VTKFile>"])
    with open(path, "w") as f:
        f.write("\n".join(parts))


_HEADER = {"UInt64": ("<Q", 8), "UInt32": ("<I", 4)}


def _decode_data_array(el: ET.Element, header_type: str = "UInt64") -> np.ndarray:
    dtype = _DTYPES[el.get("type")]
    ncomp = int(el.get("NumberOfComponents", "1"))
    fmt = el.get("format", "binary")
    text = (el.text or "").strip()
    if fmt == "ascii":
        arr = np.array(text.split(), dtype=float).astype(dtype) if text else np.zeros(0, dtype)
    elif fmt == "binary":
        # the byte-count prefix width follows the file's header_type —
        # unpacking a UInt32 header as UInt64 would swallow the first 4
        # data bytes and corrupt every array
        hfmt, hsize = _HEADER[header_type]
        raw = base64.b64decode(text)
        (nbytes,) = struct.unpack(hfmt, raw[:hsize])
        arr = np.frombuffer(raw[hsize:hsize + nbytes], dtype=dtype).copy()
    else:
        raise ValueError(f"unsupported DataArray format: {fmt}")
    if ncomp > 1:
        arr = arr.reshape(-1, ncomp)
    return arr


def read_vtu(path: str) -> dict:
    """Reads a VTU file written by this module (or simple external VTUs).

    Returns dict with points, connectivity, offsets, cell_types, cells (list of
    per-cell index arrays, or [C, K] when uniform), point_data, cell_data.
    """
    tree = ET.parse(path)
    root = tree.getroot()
    header_type = root.get("header_type", "UInt64")
    if header_type not in _HEADER:
        raise ValueError(f"unsupported header_type {header_type!r}")
    if root.get("compressor"):
        raise ValueError(
            f"compressed VTU not supported (compressor="
            f"{root.get('compressor')!r}); write with compression disabled")
    piece = root.find(".//Piece")
    out: dict = {"point_data": {}, "cell_data": {}}

    def decode(el):
        return _decode_data_array(el, header_type)

    pts = piece.find("Points/DataArray")
    out["points"] = np.asarray(decode(pts), np.float32).reshape(-1, 3)

    arrays = {el.get("Name"): decode(el)
              for el in piece.findall("Cells/DataArray")}
    conn, offs = arrays["connectivity"].ravel(), arrays["offsets"].ravel()
    out["connectivity"], out["offsets"] = conn, offs
    out["cell_types"] = arrays["types"].ravel()
    starts = np.concatenate([[0], offs[:-1]])
    lens = offs - starts
    if len(lens) and np.all(lens == lens[0]):
        out["cells"] = conn.reshape(len(lens), int(lens[0]))
    else:
        out["cells"] = [conn[s:e] for s, e in zip(starts, offs)]

    for section, key in (("PointData", "point_data"), ("CellData", "cell_data")):
        sec = piece.find(section)
        if sec is not None:
            for el in sec.findall("DataArray"):
                out[key][el.get("Name")] = decode(el)
    return out


def write_vtp_polydata(path: str, points: np.ndarray, polys: np.ndarray,
                       point_data: dict[str, np.ndarray] | None = None) -> None:
    """Minimal VTP (PolyData) writer for WSS surface output
    (compute_wss.py:113-116 writes .vtp)."""
    points = np.asarray(points, np.float32)
    connectivity, offsets, npolys = _flatten_cells(polys)
    parts = [
        '<?xml version="1.0"?>',
        '<VTKFile type="PolyData" version="1.0" byte_order="LittleEndian" header_type="UInt64">',
        "<PolyData>",
        f'<Piece NumberOfPoints="{len(points)}" NumberOfPolys="{npolys}">',
    ]
    if point_data:
        parts.append("<PointData>")
        for name, arr in point_data.items():
            parts.append(_data_array(name, np.asarray(arr, np.float32)))
        parts.append("</PointData>")
    parts.append("<Points>")
    parts.append(_data_array(None, points))
    parts.append("</Points>")
    parts.append("<Polys>")
    parts.append(_data_array("connectivity", connectivity))
    parts.append(_data_array("offsets", offsets))
    parts.append("</Polys>")
    parts.extend(["</Piece>", "</PolyData>", "</VTKFile>"])
    with open(path, "w") as f:
        f.write("\n".join(parts))
