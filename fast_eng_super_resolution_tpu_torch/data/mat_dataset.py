"""External-format operator-learning datasets: the FNO literature's ``.mat``
layout.

A copy of the JAX package's ``data/mat_dataset.py``: the standard
Darcy/Burgers/NS ``.mat`` files of the neural-operator literature, MATLAB v5
through scipy.io and v7.3 (HDF5) through h5py with the column-major
transpose, behind the MatDataset surface (reference dataset/MatDataset.py:
21-39).  h5py is imported only to read a v7.3 file; where it is missing (the
GPU host has none) that read raises an ImportError naming the file.
Canonical key names: ``coeff``/``sol`` for the Darcy files
(piececonst_r421_N1024_*.mat), ``a``/``u`` for Burgers (burgers_data_R10.mat).

Two task castings:

- ``task='sr'`` (default): channel 0 is the stored solution subsampled by
  ``downsample`` and bilinearly upsampled back (the improvement baseline),
  plus the normalized input/coefficient field as an extra channel; target =
  the full-resolution solution.  Unlike the generated tasks the coarse
  channel is a downsampled fine solution, not an independent coarse solve,
  so the task is easier (no discretization error).
- ``task='operator'``: the literature's map itself, x = normalized input
  field, y = solution, comparable to published FNO results (the
  "improvement over baseline" factor means nothing here: x holds no
  solution estimate).
"""

from __future__ import annotations

import glob
import os

import numpy as np


def load_mat_arrays(path: str, keys: list[str]) -> dict[str, np.ndarray]:
    """Reads named arrays from a .mat file, either MATLAB v5 (scipy.io) or
    v7.3/HDF5 (h5py; MATLAB stores column-major, so dims come back reversed
    and are transposed here to the MATLAB shape)."""
    try:
        import scipy.io as sio

        d = sio.loadmat(path)
        missing = [k for k in keys if k not in d]
        if missing:
            raise KeyError(
                f"{path}: missing keys {missing}; available: "
                f"{[k for k in d if not k.startswith('__')]}")
        return {k: np.asarray(d[k]) for k in keys}
    except (NotImplementedError, ValueError):
        # v7.3 .mat files are HDF5: scipy raises NotImplementedError on real
        # MATLAB v7.3 headers and ValueError on bare-HDF5 variants
        try:
            import h5py
        except ImportError as exc:
            raise ImportError(
                f"{path} is a MATLAB v7.3 (HDF5) file, which needs h5py, and "
                "h5py is not installed; save it as v5 (scipy.io.savemat, or "
                "MATLAB's save -v7) to read it here") from exc

        out = {}
        with h5py.File(path, "r") as f:
            for k in keys:
                if k not in f:
                    raise KeyError(
                        f"{path}: missing key {k!r}; available: "
                        f"{list(f.keys())}")
                out[k] = np.array(f[k]).T
        return out


def _upsample_clamped(coarse: np.ndarray, n: int, factor: int) -> np.ndarray:
    """Bilinear (linear in 1D) upsample of a POINT-SUBSAMPLED field back to
    ``n`` points with clamped (non-periodic) edges.

    The coarse channel here is ``fine[::factor]`` — coarse sample j sits
    exactly at fine index j*factor, so the aligned query is
    ``q = i / factor`` (exact at the subsample points: up[j*factor] ==
    coarse[j]).  darcy_pair's cell-centered query ``(i-(factor-1)/2)/factor``
    is correct there because its coarse field is an independent cell-centered
    solve; using it on a point subsample shifts the interpolant by
    (factor-1)/2 fine pixels and inflates the baseline MSE."""
    from .grid_dataset import _bilinear_sample

    m = coarse.shape[0]
    q = np.clip(np.arange(n) / factor, 0.0, m - 1.0)
    if coarse.ndim == 1:
        i0 = np.floor(q).astype(np.int64)
        i1 = np.minimum(i0 + 1, m - 1)
        t = q - i0
        return coarse[i0] * (1 - t) + coarse[i1] * t
    gxq, gyq = np.meshgrid(q, q, indexing="ij")
    return _bilinear_sample(coarse, gxq, gyq)


class MatGridDataset:
    """Grid-family dataset over an external ``.mat`` file (same access API
    as the generated grid datasets: ``__len__`` + ``__getitem__`` ->
    {'x': [n(, n), Cin], 'y': [n(, n), 1]})."""

    def __init__(self, root: str, mat_file: str | None = None,
                 input_key: str = "coeff", target_key: str = "sol",
                 task: str = "sr", downsample: int = 4,
                 num_samples: int | None = None, seed: int = 0, **kwargs):
        path = mat_file
        if path is not None and not os.path.isabs(path):
            path = os.path.join(root, path)
        if path is None:
            hits = sorted(glob.glob(os.path.join(root, "raw", "*.mat"))
                          + glob.glob(os.path.join(root, "*.mat")))
            if not hits:
                raise FileNotFoundError(
                    f"no .mat file under {root} (set mat_file: in the exp "
                    "config)")
            path = hits[0]
        if task not in ("sr", "operator"):
            raise ValueError(f"task must be 'sr' or 'operator', got {task!r}")

        arrays = load_mat_arrays(path, [input_key, target_key])
        a = np.asarray(arrays[input_key], np.float64)
        u = np.asarray(arrays[target_key], np.float64)
        if a.shape != u.shape:
            raise ValueError(
                f"{path}: {input_key} {a.shape} vs {target_key} {u.shape} "
                "shape mismatch")
        if u.ndim not in (2, 3):
            raise ValueError(
                f"{path}: expected [N, s] or [N, s, s] arrays, got {u.shape}")
        if num_samples is not None:
            a, u = a[: int(num_samples)], u[: int(num_samples)]
        n = u.shape[-1]
        if u.ndim == 3 and u.shape[1] != n:
            raise ValueError(f"{path}: non-square fields {u.shape}")
        if task == "sr" and n % downsample != 0:
            raise ValueError(
                f"resolution {n} not divisible by downsample {downsample}")

        xs, ys = [], []
        for i in range(u.shape[0]):
            fine = u[i]
            scale = np.abs(fine).max() + 1e-12
            amax, amin = a[i].max(), a[i].min()
            a_norm = (a[i] - (amax + amin) / 2.0) / (amax - amin + 1e-12)
            if task == "sr":
                sub = (fine[::downsample] if fine.ndim == 1
                       else fine[::downsample, ::downsample])
                up = _upsample_clamped(sub, n, downsample)
                x = np.stack([up / scale, a_norm], axis=-1)
            else:
                x = a_norm[..., None]
            xs.append(x.astype(np.float32))
            ys.append((fine / scale)[..., None].astype(np.float32))
        self.x, self.y = np.stack(xs), np.stack(ys)
        self.task = task
        self.resolution = n
        self.downsample = downsample if task == "sr" else None
        self.mat_path = path

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"x": self.x[i], "y": self.y[i]}
