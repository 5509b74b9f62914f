"""Fluent legacy ``.msh`` parser and writer (ASCII + binary sections).

Replaces vtkFLUENTReader (reference dataset/GraphDataset.py:323-330).
The format is scheme-like sections ``(index (header-args) [payload])`` with
hexadecimal indices:

  (0 "comment")                         comment
  (2 ND)                                dimensionality
  (10 (0 first last 0 ND))              node count declaration (zone 0)
  (10 (zid first last type ND)( ... ))  node coordinates, one point per line
  (12 (0 first last 0))                 cell count declaration
  (12 (zid first last type etype))      cell zone declaration
  (13 (zid first last bctype ftype)(...)) faces: each row
        [nnodes] n0 n1 ... c0 c1        (hex; nnodes present for mixed ftype 0)
  (45 (zid type name)())                zone name metadata
  (39 (zid type name)())                alt zone metadata

Binary variants use offset indices with raw little-endian payloads after the
header's opening paren, closed by ``End of Binary Section``:

  (3010 ...)  nodes, float32        (2010 ...)  nodes, float64
  (3013 ...)  faces, int32          (2013 ...)  faces, int32

Only what the pipeline needs is consumed (nodes, faces+adjacency, zone names);
unknown sections are skipped structurally.  The writer emits the same subset
(``binary=True`` for the binary form) so tests round-trip parser behavior.
"""

from __future__ import annotations

import re

import numpy as np

from .fluent_mesh import BC_INTERIOR, BC_WALL, FaceZone, FluentMesh

_FACE_NNODES = {2: 2, 3: 3, 4: 4}  # linear/tri/quad face types
_BINARY_NODE_SECTIONS = {2010: np.float64, 3010: np.float32}
_BINARY_FACE_SECTIONS = {2013: np.int32, 3013: np.int32}
_END_BINARY = re.compile(rb"End\s+of\s+Binary\s+Section\s+(\d+)\)?")


def _grow_points(points, last: int):
    """Size the coordinate array to cover node id ``last`` — split/multi-zone
    node sections each carry only their own range, and the zid-0 declaration
    (which has the global count) may not have been seen yet."""
    if points is None:
        return np.zeros((last, 3), np.float64)
    if len(points) < last:
        return np.vstack([points, np.zeros((last - len(points), 3))])
    return points


def _tokenize_sections(text: str):
    """Yields (index, header_args, payload_str) for each top-level section."""
    i, n = 0, len(text)
    while i < n:
        if text[i] != "(":
            i += 1
            continue
        # read section index
        j = i + 1
        while j < n and text[j] not in " (\n\t":
            j += 1
        idx_str = text[i + 1:j].strip()
        # find matching close paren, tracking strings
        depth, k = 1, i + 1
        while k < n and depth:
            c = text[k]
            if c == '"':
                k += 1
                while k < n and text[k] != '"':
                    k += 1
            elif c == "(":
                depth += 1
            elif c == ")":
                depth -= 1
            k += 1
        body = text[i + 1:k - 1]
        # body starts with the index; strip it
        body = body[len(idx_str):].strip()
        header, payload = "", ""
        if body.startswith("("):
            depth2, m = 1, 1
            while m < len(body) and depth2:
                if body[m] == "(":
                    depth2 += 1
                elif body[m] == ")":
                    depth2 -= 1
                m += 1
            header = body[1:m - 1]
            payload = body[m:].strip()
            if payload.startswith("("):
                payload = payload[1:]
            if payload.endswith(")"):
                payload = payload[:-1]
        else:
            header = body
        try:
            index = int(idx_str)
        except ValueError:
            index = -1
        yield index, header, payload
        i = k


def _parse_ascii_faces(payload: str, count: int, ftype: int):
    nums = [int(t, 16) for t in payload.split()]
    faces, c0s, c1s = [], [], []
    pos = 0
    for _ in range(count):
        if ftype in _FACE_NNODES:
            nn = _FACE_NNODES[ftype]
        else:
            nn = nums[pos]
            pos += 1
        faces.append(np.array(nums[pos:pos + nn], np.int64) - 1)
        pos += nn
        c0s.append(nums[pos] - 1)
        c1s.append(nums[pos + 1] - 1)
        pos += 2
    return faces, np.array(c0s), np.array(c1s)


def _parse_binary_faces(buf: bytes, count: int, ftype: int, dtype):
    ints = np.frombuffer(buf, dtype=dtype)
    faces, c0s, c1s = [], [], []
    pos = 0
    for _ in range(count):
        if ftype in _FACE_NNODES:
            nn = _FACE_NNODES[ftype]
        else:
            nn = int(ints[pos])
            pos += 1
        faces.append(ints[pos:pos + nn].astype(np.int64) - 1)
        pos += nn
        c0s.append(int(ints[pos]) - 1)
        c1s.append(int(ints[pos + 1]) - 1)
        pos += 2
    return faces, np.array(c0s), np.array(c1s)


def read_msh(path: str) -> FluentMesh:
    with open(path, "rb") as f:
        data = f.read()

    points = None
    zone_names: dict[int, str] = {}
    raw_face_zones = []
    num_cells = 0

    # ---- binary sections: extract payloads, blank them out of the text ----
    text_parts = []
    cursor = 0
    hdr_re = re.compile(rb"\((\d+)\s*\(([^)]*)\)\s*\(")
    for m in hdr_re.finditer(data):
        index = int(m.group(1))
        if index not in _BINARY_NODE_SECTIONS and index not in _BINARY_FACE_SECTIONS:
            continue
        if m.start() < cursor:
            continue
        header = m.group(2).decode()
        args = [int(a, 16) for a in header.split()[:5]]
        zid, first, last = args[0], args[1], args[2]
        count = last - first + 1
        start = m.end()
        if index in _BINARY_NODE_SECTIONS:
            dtype = np.dtype(_BINARY_NODE_SECTIONS[index])
            nd = args[4] if len(args) > 4 else 3
            nbytes = count * nd * dtype.itemsize
            coords = np.frombuffer(data[start:start + nbytes], dtype=dtype)
            coords = coords.reshape(count, nd).astype(np.float64)
            if nd == 2:
                coords = np.concatenate([coords, np.zeros((count, 1))], 1)
            points = _grow_points(points, last)
            points[first - 1:last] = coords
            end = start + nbytes
        else:
            dtype = np.dtype(_BINARY_FACE_SECTIONS[index])
            bctype = args[3]
            ftype = args[4] if len(args) > 4 else 0
            if ftype in _FACE_NNODES:
                nbytes = count * (_FACE_NNODES[ftype] + 2) * dtype.itemsize
                buf = data[start:start + nbytes]
                end = start + nbytes
            else:
                # variable-length payload: the section's OWN trailer bounds
                # it — a trailer carrying a different section number means
                # this section never terminated (fail loudly instead of
                # swallowing every section in between)
                tail = _END_BINARY.search(data, start)
                if tail is not None and int(tail.group(1)) != index:
                    raise ValueError(
                        f".msh binary section {index}: found 'End of Binary "
                        f"Section {int(tail.group(1))}' before this "
                        "section's own trailer — unterminated section")
                stop = tail.start() if tail else len(data)
                buf = data[start:stop].rstrip(b")\n\r\t (")
                end = stop
            faces, c0, c1 = _parse_binary_faces(buf, count, ftype, dtype)
            raw_face_zones.append((zid, bctype, faces, c0, c1))
        # the trailer sits immediately after the payload; an unbounded
        # search could lock onto a LATER section's trailer and skip every
        # section in between
        tail = _END_BINARY.search(data, end, end + 200)
        if tail is not None and int(tail.group(1)) != index:
            tail = None
        end = tail.end() if tail else end
        text_parts.append(data[cursor:m.start()])
        cursor = end
    text_parts.append(data[cursor:])
    text = b"".join(text_parts).decode("latin-1")

    for index, header, payload in _tokenize_sections(text):
        if index == 2:
            continue
        elif index == 10:
            args = [int(a, 16) for a in header.split()[:4]]
            zid, first, last = args[0], args[1], args[2]
            if zid == 0:
                # binary sections may have filled (part of) it already
                points = _grow_points(points, last)
            else:
                coords = np.array(payload.split(), dtype=np.float64)
                nd = coords.size // (last - first + 1)
                coords = coords.reshape(-1, nd)
                if nd == 2:
                    coords = np.concatenate([coords, np.zeros((len(coords), 1))], 1)
                points = _grow_points(points, last)
                points[first - 1:last] = coords
        elif index == 12:
            args = [int(a, 16) for a in header.split()[:4]]
            zid, first, last = args[0], args[1], args[2]
            if zid == 0:
                num_cells = last - first + 1
            else:
                num_cells = max(num_cells, last)
        elif index == 13:
            args = [int(a, 16) for a in header.split()[:5]]
            zid, first, last, bctype = args[0], args[1], args[2], args[3]
            ftype = args[4] if len(args) > 4 else 0
            if zid == 0:
                continue
            faces, c0s, c1s = _parse_ascii_faces(payload, last - first + 1, ftype)
            raw_face_zones.append((zid, bctype, faces, c0s, c1s))
        elif index in (39, 45):
            m = re.match(r"\s*(\d+)\s+(\S+)\s+(\S+)", header)
            if m:
                zone_names[int(m.group(1))] = f"{m.group(2)}:{m.group(3)}"

    zones = []
    for zid, bctype, faces, c0, c1 in raw_face_zones:
        name = zone_names.get(zid, f"zone-{zid}")
        lens = {len(f) for f in faces}
        fn = np.stack(faces) if len(lens) == 1 else faces
        zones.append(FaceZone(zid, bctype, name, fn, c0, c1))

    return FluentMesh(points=points.astype(np.float32), face_zones=zones,
                      num_cells=num_cells)


def write_msh(path: str, mesh: FluentMesh, binary: bool = False) -> None:
    """Writes the subset read_msh consumes (round-trip for tests).

    binary=True emits (3010) float32 node and (3013) int32 face sections with
    raw little-endian payloads.
    """
    n = len(mesh.points)
    chunks: list[bytes] = [b'(0 "fast_eng_super_resolution_tpu mesh")\n(2 3)\n']
    chunks.append(f"(10 (0 1 {n:x} 0 3))\n".encode())
    if binary:
        chunks.append(f"(3010 (1 1 {n:x} 1 3)(".encode())
        chunks.append(np.ascontiguousarray(mesh.points, np.float32).tobytes())
        chunks.append(b")\nEnd of Binary Section 3010)\n")
    else:
        coord_lines = "\n".join(" ".join(f"{v:.9e}" for v in p) for p in mesh.points)
        chunks.append(f"(10 (1 1 {n:x} 1 3)(\n{coord_lines}\n))\n".encode())
    # cell zone id must not collide with any FACE zone id: the (45) name
    # entry below would otherwise overwrite that face zone's name on read
    cell_zid = max((z.zone_id for z in mesh.face_zones), default=1) + 1
    chunks.append(f"(12 (0 1 {mesh.num_cells:x} 0))\n".encode())
    chunks.append(f"(12 ({cell_zid:x} 1 {mesh.num_cells:x} 1 2))\n".encode())

    first = 1
    for zone in mesh.face_zones:
        fn = zone.face_nodes
        faces = (list(fn) if not (isinstance(fn, np.ndarray) and fn.ndim == 2)
                 else [fn[i] for i in range(fn.shape[0])])
        last = first + len(faces) - 1
        if binary:
            ints: list[int] = []
            for face, c0, c1 in zip(faces, zone.c0, zone.c1):
                ints.append(len(face))
                ints.extend(int(v) + 1 for v in face)
                ints.extend((int(c0) + 1, int(c1) + 1))
            chunks.append(
                f"(3013 ({zone.zone_id:x} {first:x} {last:x} {zone.bc_type:x} 0)(".encode())
            chunks.append(np.asarray(ints, np.int32).tobytes())
            chunks.append(b")\nEnd of Binary Section 3013)\n")
        else:
            rows = []
            for face, c0, c1 in zip(faces, zone.c0, zone.c1):
                toks = ([f"{len(face):x}"] + [f"{v + 1:x}" for v in face]
                        + [f"{c0 + 1:x}", f"{c1 + 1:x}"])
                rows.append(" ".join(toks))
            body = "\n".join(rows)
            chunks.append(
                f"(13 ({zone.zone_id:x} {first:x} {last:x} {zone.bc_type:x} 0)(\n{body}\n))\n".encode())
        first = last + 1

    for zone in mesh.face_zones:
        ztype, _, zname = zone.name.partition(":")
        chunks.append(f"(45 ({zone.zone_id} {ztype} {zname or ztype})())\n".encode())
    chunks.append(f"(45 ({cell_zid} interior {mesh.cell_zone_name})())\n".encode())
    with open(path, "wb") as f:
        f.write(b"".join(chunks))
