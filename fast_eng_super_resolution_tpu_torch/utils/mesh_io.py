"""Mesh export/visualization utilities.

A copy of the JAX package's ``utils/mesh_io.py`` over the port's VTU writer.
Parity targets:
- convert_all_mesh_arrays_to_32bit (reference dataset/GraphDataset.py:
  2055-2170) — ParaView-friendly dtype downcasting.  Our VTU writer already
  emits Float32/Int32 natively (data/vtu.py), so this helper exists for users
  converting externally-produced array dicts.
- save_pyg_to_vtk (utils.py:91-122) — attach a prediction to a mesh and write
  a VTU.
- visualize_partitioned_dataset (GraphDataset.py:482-527, 1136-1181) — the
  reference opens an interactive VTK render window; a headless host has no
  display, so this emits a partition-id-colored VTU for ParaView instead.
"""

from __future__ import annotations

import numpy as np

from ..data.tensorize import VTK_TETRA
from ..data.vtu import write_vtu


def convert_arrays_to_32bit(arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """float64 -> float32, int64 -> int32 (GraphDataset.py:2133-2159 policy)."""
    out = {}
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        if arr.dtype == np.float64:
            out[name] = arr.astype(np.float32)
        elif arr.dtype in (np.int64, np.uint64):
            out[name] = arr.astype(np.int32)
        else:
            out[name] = arr
    return out


def save_graph_to_vtk(points: np.ndarray, cells: np.ndarray, pred: np.ndarray,
                      save_path: str) -> None:
    """save_pyg_to_vtk equivalent (utils.py:91-122): mesh + 'prediction' array."""
    pred = np.asarray(pred, np.float32)
    if pred.ndim == 1:
        pred = np.stack([pred, pred, pred], axis=1)  # utils.py:107-108
    write_vtu(save_path, points, cells, np.full(len(cells), VTK_TETRA, np.uint8),
              point_data={"prediction": pred})


def write_partition_visualization(points: np.ndarray, cells: np.ndarray,
                                  subdomains, save_path: str) -> None:
    """Partition-colored VTU (headless replacement for the reference's
    interactive render window)."""
    part_of_cell = np.full(len(cells), -1, np.int32)
    owner_count = np.zeros(len(points), np.float32)
    part_of_node = np.full(len(points), -1, np.int32)
    for p, sub in enumerate(subdomains):
        part_of_cell[sub.cell_ids] = p
        part_of_node[sub.global_node_ids] = p
        owner_count[sub.global_node_ids] += 1
    write_vtu(save_path, points, cells, np.full(len(cells), VTK_TETRA, np.uint8),
              point_data={"partition": part_of_node.astype(np.float32),
                          "overlap_count": owner_count},
              cell_data={"partition": part_of_cell.astype(np.float32)})
