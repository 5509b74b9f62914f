"""Full-mesh reconstruction from per-subdomain predictions.

Replaces the reference's vtkAppendDataSets + vtkStaticPointLocator
duplicate-point averaging loop (reference dataset/GraphDataset.py:1324-1409)
with an exact segment-mean over global node ids — the partitioner kept them,
so there is no need to rediscover duplicates by radius search.  Optionally
weighted by the per-subdomain node weights the scheduler computes
(GradientbasedLoss.compute_node_weight, scheduler_gnn.py:503-515).
"""

from __future__ import annotations

import numpy as np
import torch


def overlap_average(
    predictions: list[np.ndarray],
    global_ids: list[np.ndarray],
    num_nodes: int,
    weights: list[np.ndarray] | None = None,
) -> np.ndarray:
    """Averages per-subdomain nodal values back onto the full mesh (host).

    Args:
      predictions: list of [n_i, C] arrays (one per subdomain).
      global_ids: list of [n_i] int arrays into the full mesh.
      num_nodes: full-mesh node count.
      weights: optional per-subdomain [n_i] blending weights; None -> plain
        mean (the reference's behavior at GraphDataset.py:1396-1400).
    """
    c = predictions[0].shape[1]
    acc = np.zeros((num_nodes, c), np.float64)
    wacc = np.zeros((num_nodes,), np.float64)
    for i, (pred, gid) in enumerate(zip(predictions, global_ids)):
        w = np.ones(len(gid)) if weights is None else np.asarray(weights[i], np.float64)
        np.add.at(acc, gid, pred * w[:, None])
        np.add.at(wacc, gid, w)
    covered = wacc > 0
    acc[covered] /= wacc[covered, None]
    return acc.astype(np.float32)


def overlap_average_device(predictions: torch.Tensor, global_ids: torch.Tensor,
                           weights: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Device overlap average over the concatenated subdomain node axis.

    predictions [T, C], global_ids [T] int, weights [T] (0 for padding rows —
    padding's global_ids may point anywhere valid).  Divides only where the
    summed weight is positive, like the host path's ``wacc > 0``: weights
    from compute_node_weight are unclamped sums that can go negative, and a
    plain max(wsum, eps) would emit ~1e30 garbage there instead of 0.
    """
    idx = global_ids.long()
    acc = predictions.new_zeros((num_nodes, predictions.shape[1]))
    acc.index_add_(0, idx, predictions * weights[:, None])
    wsum = weights.new_zeros(num_nodes).index_add_(0, idx, weights)
    covered = (wsum > 0.0)[:, None]
    return torch.where(covered,
                       acc / torch.where(covered, wsum[:, None],
                                         torch.ones_like(wsum[:, None])),
                       torch.zeros_like(acc))
