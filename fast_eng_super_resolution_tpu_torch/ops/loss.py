"""Node weights for the scheduler's reconstruction (the loss itself comes
with training: ROADMAP.md queue A item 7)."""

from __future__ import annotations

import torch

from .segment import masked_segment_sum


def compute_node_weight(pred: torch.Tensor, target: torch.Tensor,
                        senders: torch.Tensor, receivers: torch.Tensor,
                        edge_attr: torch.Tensor,
                        edge_mask: torch.Tensor | None = None,
                        node_mask: torch.Tensor | None = None) -> torch.Tensor:
    """GradientbasedLoss.compute_node_weight (scheduler_gnn.py:503-515),
    batched over subdomains.

    All arguments carry a leading [B] axis (pred/target [B, N, C], senders/
    receivers [B, E], edge_attr [B, E, A], masks [B, N] / [B, E]).  Each
    subdomain's blending weight is its summed (unclamped) edge weight
    broadcast to every node: returns [B, N].
    """
    b, n = pred.shape[0], pred.shape[1]
    ar = torch.arange(b, device=pred.device)[:, None]
    s, r = senders.long(), receivers.long()
    grad_pred = (pred[ar, s] - pred[ar, r]) / edge_attr
    grad_tgt = (target[ar, s] - target[ar, r]) / edge_attr
    edge_w = torch.amax(grad_pred - grad_tgt, dim=2)              # [B, E]
    flat_ids = (s + ar * n).reshape(-1)
    node_w = masked_segment_sum(
        edge_w.reshape(-1), flat_ids, b * n,
        None if edge_mask is None else edge_mask.reshape(-1)).reshape(b, n)
    if node_mask is not None:
        node_w = torch.where(node_mask, node_w, torch.zeros_like(node_w))
    total = node_w.sum(dim=1, keepdim=True)
    return total.expand(b, n).contiguous()
