"""Wall-shear-stress post-pass CLI (reference compute_wss.py:136-183):
``python -m fast_eng_super_resolution_tpu_torch.compute_wss``.

Reads a predicted VTU (default ``logs/vtk/ansys_neuralop/pred_0.vtu``),
computes the WSS of the predicted, interpolated and reference velocity
fields with mu = 1e-3 Pa.s, and writes ``wall_shear_stress_results_*.vtp``
in the working directory.  Runs on ``cuda`` unless ``--device=cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np

from .data.tensorize import cells_to_edges
from .data.vtu import read_vtu
from .physics.wss import compute_wall_shear_stress

FIELDS = (("velocity", "pred"), ("interpolated_velocity", "interpolated"),
          ("ref_velocity", "reference"))


def main(argv=None) -> list[str]:
    """Runs the post-pass; returns the paths of the ``.vtp`` files written."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", default="logs/vtk/ansys_neuralop/pred_0.vtu")
    parser.add_argument("--viscosity", type=float, default=1.0e-3)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    print(f"Loading VTK grid from: {args.input}")
    grid = read_vtu(args.input)
    print("\nAvailable point data arrays:")
    for name, arr in grid["point_data"].items():
        ncomp = 1 if arr.ndim == 1 else arr.shape[1]
        print(f"  - {name}: {ncomp} components, {len(arr)} tuples")

    cells = np.asarray(grid["cells"])
    edges = cells_to_edges(cells)
    written = []
    for field, tag in FIELDS:
        if field not in grid["point_data"]:
            print(f"skipping {field}: not present")
            continue
        out = f"wall_shear_stress_results_{tag}.vtp"
        compute_wall_shear_stress(
            grid["points"], cells, edges,
            np.asarray(grid["point_data"][field], np.float32),
            dynamic_viscosity=args.viscosity, output_filename=out,
            device=args.device)
        written.append(out)

    print("\nWall shear stress computation completed successfully!")
    return written


if __name__ == "__main__":
    main()
