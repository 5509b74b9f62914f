"""Segment (gather/scatter) primitives for static-shape graphs.

These replace torch_geometric's scatter-based aggregation (the reference's
per-edge message + scatter-mean in NNConv_old / KernelConv, models/model.py:
424-441, 521-536) with ``index_add_``.  Padding is handled by masks.
"""

from __future__ import annotations

import torch


def masked_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Sums ``data[e]`` into ``out[segment_ids[e]]``; masked entries contribute 0.

    Args:
      data: [E, ...] values.
      segment_ids: [E] int indices in [0, num_segments).
      num_segments: output size.
      mask: optional [E] bool.
    """
    if mask is not None:
        data = torch.where(mask.reshape(mask.shape + (1,) * (data.ndim - 1)),
                           data, torch.zeros((), dtype=data.dtype,
                                             device=data.device))
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def masked_segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int, mask: torch.Tensor | None = None,
                        count: torch.Tensor | None = None) -> torch.Tensor:
    """Mean with PyG semantics: segments with zero (real) edges produce 0.

    Matches ``aggr='mean'`` in the reference convs (model.py:394, 551).
    ``count`` lets callers hoist the (loop-invariant) degree computation out
    of repeated-conv loops.
    """
    total = masked_segment_sum(data, segment_ids, num_segments, mask)
    if count is None:
        count = segment_degree(segment_ids, num_segments, mask, data.dtype)
    count = torch.clamp(count, min=1.0)
    return total / count.reshape(count.shape + (1,) * (data.ndim - 1))


def segment_degree(segment_ids: torch.Tensor, num_segments: int,
                   mask: torch.Tensor | None = None,
                   dtype=torch.float32) -> torch.Tensor:
    """Number of (real) edges incident on each segment."""
    ones = (torch.ones(segment_ids.shape, dtype=dtype, device=segment_ids.device)
            if mask is None else mask.to(dtype))
    out = torch.zeros(num_segments, dtype=dtype, device=segment_ids.device)
    return out.index_add_(0, segment_ids.long(), ones)
