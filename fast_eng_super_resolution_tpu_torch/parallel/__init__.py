"""Training engines, graph (``train``) and grid (``grid_train``), on one
device or one rank of a data-parallel group (``mesh``)."""
