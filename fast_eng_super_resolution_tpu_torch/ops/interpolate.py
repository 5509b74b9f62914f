"""Gaussian-kernel scattered-field interpolation (low-res -> high-res mesh).

Replaces vtkPointInterpolator + vtkGaussianKernel(radius=0.012*3, sharpness=2)
(reference dataset/GraphDataset.py:1078-1094).  VTK's Gaussian kernel weights
points within ``radius`` by w_i = exp(-(sharpness * d_i / radius)^2),
normalized to sum 1.  Empty neighborhoods fall back to the nearest source
point (the reference produces NaNs there, GraphDataset.py:1013-1014).

Two paths over the same host-built neighbour lists (``build_neighbor_lists``):
- ``gaussian_interpolate_host``: numpy + cKDTree, used in one-shot ETL;
- ``gaussian_interpolate_device``: the weighted gather on torch tensors, on
  whatever device they lie on (for interpolation inside an on-device
  pipeline).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import cKDTree


def build_neighbor_lists(src_points: np.ndarray, dst_points: np.ndarray,
                         radius: float, max_neighbors: int = 32):
    """Fixed-size neighbor lists: [M, K] indices + mask, nearest-first."""
    tree = cKDTree(src_points)
    dists, idxs = tree.query(dst_points, k=max_neighbors,
                             distance_upper_bound=radius, workers=-1)
    if max_neighbors == 1:
        dists, idxs = dists[:, None], idxs[:, None]
    mask = np.isfinite(dists)
    # query returns n (num src) for out-of-radius entries; make them safe.
    idxs = np.where(mask, idxs, 0)
    dists = np.where(mask, dists, 0.0)
    # nearest fallback for empty neighborhoods
    empty = ~mask.any(axis=1)
    if empty.any():
        d_nn, i_nn = tree.query(dst_points[empty], k=1, workers=-1)
        idxs[empty, 0] = i_nn
        # clamp the stored distance to the radius: past ~5x radius the f32
        # Gaussian weight underflows to exactly 0 and the fallback would
        # return a silent zero field instead of the nearest value; the row
        # has ONE unmasked neighbor, so normalization makes any positive
        # weight equivalent to weight 1
        dists[empty, 0] = np.minimum(d_nn, radius)
        mask[empty, 0] = True
    return idxs.astype(np.int32), dists.astype(np.float32), mask


def gaussian_interpolate_host(src_points: np.ndarray, src_values: np.ndarray,
                              dst_points: np.ndarray, radius: float,
                              sharpness: float = 2.0,
                              max_neighbors: int = 32) -> np.ndarray:
    idxs, dists, mask = build_neighbor_lists(src_points, dst_points, radius, max_neighbors)
    w = np.exp(-((sharpness * dists / radius) ** 2)) * mask
    w_sum = np.maximum(w.sum(axis=1, keepdims=True), 1e-30)
    vals = src_values[idxs]  # [M, K, C]
    return ((w[..., None] * vals).sum(axis=1) / w_sum).astype(np.float32)


def gaussian_interpolate_device(src_values: torch.Tensor, idxs: torch.Tensor,
                                dists: torch.Tensor, mask: torch.Tensor,
                                radius: float,
                                sharpness: float = 2.0) -> torch.Tensor:
    """The weighted gather of ``gaussian_interpolate_host`` on tensors:
    ``src_values`` [S, C] at the [M, K] neighbour lists (``idxs``,
    ``dists``, ``mask`` from ``build_neighbor_lists``) -> [M, C]."""
    w = torch.exp(-((sharpness * dists / radius) ** 2)) * mask.to(
        src_values.dtype)
    w_sum = torch.clamp(w.sum(dim=1, keepdim=True), min=1e-30)
    vals = src_values[idxs.long()]  # [M, K, C]
    return (w[..., None] * vals).sum(dim=1) / w_sum
