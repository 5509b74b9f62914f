"""Training engines, graph (``train``) and grid (``grid_train``), on one
device (multi-device is ROADMAP.md queue A item 16)."""
