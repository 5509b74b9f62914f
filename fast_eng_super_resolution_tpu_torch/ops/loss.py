"""Training loss and node weights.

Parity target: GradientbasedLoss (reference models/scheduler_gnn.py:472-515)
and the composite training loss ``grad_loss + 0.1 * Linf``
(scheduler_gnn.py:151-154), as the JAX package implements them
(ops/loss.py).  All functions are mask-aware, so they run on padded graphs
without bias, and reduce like the reference on unpadded inputs.  Gradients
come from autograd, but for ``gradient_weight_scalar`` under
``FESR_LOSS_VJP=custom`` (read per call; unset or any other value is
autograd): then the JAX package's hand-written backward runs, as the
``torch.autograd.Function`` ``GradientWeightScalar``.
"""

from __future__ import annotations

import os

import torch

from .segment import masked_segment_sum


class GradientWeightScalar(torch.autograd.Function):
    """The gradient weight as a function of ``diff = pred - target`` with
    the JAX package's custom VJP (``_gw_scalar_core``): the backward is a
    one-hot of each edge's argmax channel, scaled by the upstream gradient,
    the node's clamp gate, the edge mask and 1/edge_attr of that channel,
    summed onto senders minus receivers (two ``index_add_``), instead of
    autograd's transposed gathers.  At ties it follows JAX's custom path:
    the first argmax channel and the clamp boundary take the whole gradient
    (autograd splits it).  ``edge_mask``/``node_mask`` are float (1.0 =
    real); edge_attr and the index tensors get no gradient."""

    @staticmethod
    def forward(ctx, diff, senders, receivers, idx, edge_attr, edge_mask,
                node_mask, max_weight, min_weight):
        n = diff.shape[0]
        s, r, ix = senders.long(), receivers.long(), idx.long()
        g = (diff[s] - diff[r]) / edge_attr                      # [E, C]
        edge_w = torch.amax(g, dim=1)
        arg = torch.argmax(g, dim=1)                              # the first
        node_w = torch.zeros(n, dtype=diff.dtype, device=diff.device
                             ).index_add_(0, ix, edge_w * edge_mask)
        clamped = torch.clamp(node_w, max=max_weight)
        active = (node_w <= max_weight).to(diff.dtype)
        if min_weight is not None:
            active = active * (clamped >= min_weight).to(diff.dtype)
            clamped = torch.clamp(clamped, min=min_weight)
        inv_sel = 1.0 / edge_attr.expand_as(g).gather(1, arg[:, None])[:, 0]
        ctx.save_for_backward(arg, inv_sel, active * node_mask, s, r, ix,
                              edge_mask)
        ctx.n_channels = g.shape[1]
        return (clamped * node_mask).sum()

    @staticmethod
    def backward(ctx, ct):
        arg, inv_sel, gate, s, r, ix, edge_mask = ctx.saved_tensors
        up = ct * gate[ix] * edge_mask * inv_sel                  # [E]
        ohot = torch.zeros(arg.shape[0], ctx.n_channels, dtype=up.dtype,
                           device=up.device).scatter_(1, arg[:, None],
                                                      up[:, None])
        n = gate.shape[0]
        d_s = torch.zeros(n, ctx.n_channels, dtype=up.dtype,
                          device=up.device).index_add_(0, s, ohot)
        d_r = torch.zeros_like(d_s).index_add_(0, r, ohot)
        return d_s - d_r, None, None, None, None, None, None, None, None


def gradient_weight_scalar(pred: torch.Tensor, target: torch.Tensor,
                           senders: torch.Tensor, receivers: torch.Tensor,
                           edge_attr: torch.Tensor,
                           edge_mask: torch.Tensor | None = None,
                           node_mask: torch.Tensor | None = None,
                           max_weight: float = 1.0,
                           scatter_to: str = "receivers",
                           min_weight: float | None = None) -> torch.Tensor:
    """The scalar gradient weight of GradientbasedLoss.forward.

    grad_e = (f[senders] - f[receivers]) / edge_attr; the per-edge weight is
    the channel max of (grad_pred - grad_target) (signed max, as
    torch.max(..., dim=1)[0] at scheduler_gnn.py:486), scatter-added to
    nodes (receivers in forward :491, senders in compute_node_weight :512),
    clamped from above by ``max_weight`` (:493), then summed (:495).

    ``min_weight`` floors each node weight (absent from the reference):
    training passes 0.0 so the weight cannot go negative and reward a
    growing MSE; ``None`` keeps the reference's behaviour.

    ``FESR_LOSS_VJP=custom`` runs ``GradientWeightScalar`` (the same value;
    the hand-written backward).
    """
    n = pred.shape[0]
    s, r = senders.long(), receivers.long()
    idx = r if scatter_to == "receivers" else s
    if os.environ.get("FESR_LOSS_VJP", "xla") == "custom":
        dt = pred.dtype
        em = (torch.ones(s.shape, dtype=dt, device=pred.device)
              if edge_mask is None else edge_mask.to(dt))
        nm = (torch.ones(n, dtype=dt, device=pred.device)
              if node_mask is None else node_mask.to(dt))
        return GradientWeightScalar.apply(
            pred - target, s, r, idx, edge_attr, em, nm, float(max_weight),
            None if min_weight is None else float(min_weight))
    grad_pred = (pred[s] - pred[r]) / edge_attr
    grad_tgt = (target[s] - target[r]) / edge_attr
    edge_w = torch.amax(grad_pred - grad_tgt, dim=1)
    node_w = masked_segment_sum(edge_w, idx, n, edge_mask)
    node_w = torch.clamp(node_w, max=max_weight)
    if min_weight is not None:
        node_w = torch.clamp(node_w, min=min_weight)
    if node_mask is not None:
        node_w = torch.where(node_mask, node_w, torch.zeros_like(node_w))
    return node_w.sum()


def _mse(pred: torch.Tensor, target: torch.Tensor,
         node_mask: torch.Tensor | None) -> torch.Tensor:
    sq = (pred - target) ** 2
    if node_mask is None:
        return sq.mean()
    m = node_mask[:, None].to(sq.dtype)
    return (sq * m).sum() / torch.clamp(m.sum() * sq.shape[1], min=1.0)


def gradient_based_loss(pred: torch.Tensor, target: torch.Tensor,
                        senders: torch.Tensor, receivers: torch.Tensor,
                        edge_attr: torch.Tensor,
                        edge_mask: torch.Tensor | None = None,
                        node_mask: torch.Tensor | None = None,
                        max_weight: float = 1.0) -> torch.Tensor:
    """GradientbasedLoss.forward (scheduler_gnn.py:481-501): mse * weight."""
    w = gradient_weight_scalar(pred, target, senders, receivers, edge_attr,
                               edge_mask, node_mask, max_weight, "receivers")
    return _mse(pred, target, node_mask) * w


def linf_loss(pred: torch.Tensor, target: torch.Tensor,
              node_mask: torch.Tensor | None = None) -> torch.Tensor:
    """max |pred - target| over real nodes (scheduler_gnn.py:153)."""
    err = (pred - target).abs()
    if node_mask is not None:
        err = torch.where(node_mask[:, None], err, torch.zeros_like(err))
    return err.max()


def training_loss(pred: torch.Tensor, target: torch.Tensor,
                  senders: torch.Tensor, receivers: torch.Tensor,
                  edge_attr: torch.Tensor,
                  edge_mask: torch.Tensor | None = None,
                  node_mask: torch.Tensor | None = None,
                  linf_weight: float = 0.1,
                  kind: str = "gradient") -> torch.Tensor:
    """The composite reference objective (scheduler_gnn.py:151-154).

    kind='gradient' -> gradient-weighted MSE + linf_weight * Linf;
    kind='mse'      -> plain MSE (the DDP path's choice, scheduler_gnn.py:390).
    """
    if kind == "mse":
        return _mse(pred, target, node_mask)
    if kind != "gradient":
        raise ValueError(f"unknown loss kind {kind!r} (expected mse | gradient)")
    base = gradient_based_loss(pred, target, senders, receivers, edge_attr,
                               edge_mask, node_mask)
    return base + linf_weight * linf_loss(pred, target, node_mask)


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
