"""Fluent CFF (``.cas.h5``) reader/writer via h5py.

Replaces vtkFLUENTCFFReader (reference dataset/GraphDataset.py:914-916).
CFF is an HDF5 container; the mesh subset this reader consumes follows the
Common Fluids Format layout:

  /meshes/<mid>/nodes/coords/<sid>              [N, 3] float64
  /meshes/<mid>/faces/nodes/<sid>/nnodes        [F] per-face node counts
  /meshes/<mid>/faces/nodes/<sid>/nodes         flat 1-based node ids
  /meshes/<mid>/faces/c0/<sid>                  [F] 1-based left cell (0=none)
  /meshes/<mid>/faces/c1/<sid>                  [F] 1-based right cell (0=none)
  /meshes/<mid>/faces/zoneTopology/{id,zoneType,minId,maxId,name}
  /meshes/<mid>/cells/zoneTopology/{maxId}

Files written by other CFF producers can deviate; the reader fails with the
exact missing path so gaps surface loudly.  ``write_cas_h5`` emits the same
layout for round-trip tests and synthetic-data workflows.
"""

from __future__ import annotations

import numpy as np

from .fluent_mesh import FaceZone, FluentMesh


def _sorted_keys(group):
    return sorted(group.keys(), key=lambda k: int(k) if k.isdigit() else 1 << 30)


def _first_key(group):
    return _sorted_keys(group)[0]


def _concat_sections(group, reshape3: bool = False) -> np.ndarray:
    """Concatenates ALL numbered sections of a CFF dataset group in sid
    order.  Producers commonly write one section per zone — reading only
    the first section would make the zoneTopology minId/maxId ranges index
    out of (or into the wrong part of) the data."""
    parts = []
    for k in _sorted_keys(group):
        a = np.asarray(group[k])
        if reshape3 and a.ndim == 1:
            a = a.reshape(-1, 3)
        parts.append(a)
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def read_cas_h5(path: str) -> FluentMesh:
    import h5py

    with h5py.File(path, "r") as f:
        if "meshes" not in f:
            raise KeyError(f"{path}: no /meshes group (not a CFF case file?)")
        mesh_grp = f["meshes"][_first_key(f["meshes"])]

        points = _concat_sections(mesh_grp["nodes/coords"],
                                  reshape3=True).astype(np.float32)

        zt = mesh_grp["faces/zoneTopology"]
        zone_ids = np.asarray(zt["id"]).astype(int)
        zone_types = np.asarray(zt["zoneType"]).astype(int)
        min_ids = np.asarray(zt["minId"]).astype(int)
        max_ids = np.asarray(zt["maxId"]).astype(int)
        raw_names = zt["name"][()]
        if isinstance(raw_names, bytes):
            names = raw_names.decode().split(";")
        elif isinstance(raw_names, np.ndarray) and raw_names.dtype.kind in "SO":
            names = [x.decode() if isinstance(x, bytes) else str(x) for x in raw_names]
        else:
            names = [str(raw_names)]

        fn_grp = mesh_grp["faces/nodes"]
        fn_sids = _sorted_keys(fn_grp)
        nnodes = np.concatenate([np.asarray(fn_grp[k]["nnodes"])
                                 for k in fn_sids]).astype(np.int64)
        flat_nodes = np.concatenate([np.asarray(fn_grp[k]["nodes"])
                                     for k in fn_sids]).astype(np.int64) - 1
        c0 = _concat_sections(mesh_grp["faces/c0"]).astype(np.int64) - 1
        c1 = _concat_sections(mesh_grp["faces/c1"]).astype(np.int64) - 1
        if len(max_ids) and max_ids.max() > len(nnodes):
            raise ValueError(
                f"{path}: zoneTopology maxId {max_ids.max()} exceeds the "
                f"{len(nnodes)} faces found across faces/nodes sections "
                "(incomplete or reordered CFF sections)")

        offsets = np.concatenate([[0], np.cumsum(nnodes)])
        zones = []
        for i, zid in enumerate(zone_ids):
            lo, hi = min_ids[i] - 1, max_ids[i]  # 1-based inclusive ranges
            faces = [flat_nodes[offsets[j]:offsets[j + 1]] for j in range(lo, hi)]
            lens = {len(x) for x in faces}
            fn = np.stack(faces) if len(lens) == 1 and faces else faces
            name = names[i] if i < len(names) else f"zone-{zid}"
            zones.append(FaceZone(int(zid), int(zone_types[i]), name, fn,
                                  c0[lo:hi], c1[lo:hi]))

        num_cells = int(max(c0.max(initial=-1), c1.max(initial=-1)) + 1)
        if "cells/zoneTopology" in mesh_grp and "maxId" in mesh_grp["cells/zoneTopology"]:
            num_cells = int(np.asarray(mesh_grp["cells/zoneTopology/maxId"]).max())

    return FluentMesh(points=points, face_zones=zones, num_cells=num_cells)


def write_cas_h5(path: str, mesh: FluentMesh) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        g = f.create_group("meshes/1")
        g.create_dataset("nodes/coords/1", data=np.asarray(mesh.points, np.float64))

        all_faces, all_c0, all_c1 = [], [], []
        ids, types, min_ids, max_ids, names = [], [], [], [], []
        cursor = 1
        for zone in mesh.face_zones:
            fn = zone.face_nodes
            faces = ([fn[i] for i in range(fn.shape[0])]
                     if isinstance(fn, np.ndarray) and fn.ndim == 2 else list(fn))
            all_faces.extend(faces)
            all_c0.append(np.asarray(zone.c0) + 1)
            all_c1.append(np.asarray(zone.c1) + 1)
            ids.append(zone.zone_id)
            types.append(zone.bc_type)
            min_ids.append(cursor)
            max_ids.append(cursor + len(faces) - 1)
            names.append(zone.name)
            cursor += len(faces)

        nnodes = np.array([len(x) for x in all_faces], np.int64)
        flat = (np.concatenate(all_faces) + 1).astype(np.int64) if all_faces else np.zeros(0, np.int64)
        g.create_dataset("faces/nodes/1/nnodes", data=nnodes)
        g.create_dataset("faces/nodes/1/nodes", data=flat)
        g.create_dataset("faces/c0/1", data=np.concatenate(all_c0).astype(np.int64))
        g.create_dataset("faces/c1/1", data=np.concatenate(all_c1).astype(np.int64))
        zt = g.create_group("faces/zoneTopology")
        zt.create_dataset("id", data=np.array(ids, np.int64))
        zt.create_dataset("zoneType", data=np.array(types, np.int64))
        zt.create_dataset("minId", data=np.array(min_ids, np.int64))
        zt.create_dataset("maxId", data=np.array(max_ids, np.int64))
        zt.create_dataset("name", data=";".join(names).encode())
        g.create_dataset("cells/zoneTopology/maxId", data=np.array([mesh.num_cells], np.int64))
