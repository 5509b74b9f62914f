"""Physics post-passes: the divergence-free projection (CGNR with an
optional AMG V-cycle) and the wall shear stress."""

from .projection import DivergenceFreeProjection, smooth_with_continuity
from .wss import compute_wall_shear_stress

__all__ = ["DivergenceFreeProjection", "smooth_with_continuity",
           "compute_wall_shear_stress"]
