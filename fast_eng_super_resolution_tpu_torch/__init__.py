"""fast_eng_super_resolution_tpu_torch — the PyTorch/CUDA port of
``fast_eng_super_resolution_tpu`` for NVIDIA Hopper GPUs.

Module names mirror the JAX package's, so each module's counterpart is found
by name.  The port imports torch, never jax, and nothing of the JAX package.

- ``core``   : padded subdomain graphs, checkpoints (flat-key npz + ``.pth``).
- ``ops``    : segment ops, edge-conditioned conv and its modes, the fused
               edge-conv layers and the per-edge messages (hand-written CUDA
               kernels under ``csrc/`` + their plain versions).
- ``models`` : KernelNN ("neuralop"), TEECNet ("teecnet"), and the grid
               family: FNO1d/2d/3d ("fno1d", "fno", "fno3d"), DeepONet.
- ``data``   : mesh ETL, RCB partitioner, datasets (the one-step grid
               datasets in ``grid_dataset``), reconstruction, VTU IO.
- ``sched``  : the partition scheduler's serving path.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
