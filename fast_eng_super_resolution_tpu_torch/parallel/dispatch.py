"""Expert dispatch: each subdomain of a batch through its own expert.

Parity target: the JAX package's ``parallel/dispatch.py``, which stacks the
experts' parameter trees on a leading axis (``stack_params``), gathers one
expert per graph (``select_expert``) and vmaps the model's ``apply`` over
the batch (``make_routed_apply``), so that one jit program covers every
routing pattern.  Here the experts are a list of ``nn.Module``s, already
the stack, and no program is compiled per pattern: ``routed_apply`` runs
each label present once, on the block-diagonal merge of that label's
graphs, and scatters the outputs back in batch order.  Graphs do not
interact, so the result equals each graph through its own expert.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.graph import GraphBatch, merge_batch


def routed_apply(experts: list, labels, batch: GraphBatch) -> torch.Tensor:
    """[B, N, C_out] predictions of the torch batch ``batch`` [B, N, ...] on
    the experts' device: graph b through ``experts[labels[b]].apply`` (the
    whole-graph form, in each expert's conv mode).  A label that covers the
    whole batch needs no gather or scatter.  Labels must be valid expert
    indices (the scheduler checks them)."""
    labels = np.asarray(labels)
    b, n = batch.x.shape[0], batch.x.shape[1]
    out = None
    for k in np.unique(labels):
        idx = np.flatnonzero(labels == k)
        idx_t = torch.as_tensor(idx, device=batch.x.device)
        sub = batch if len(idx) == b else batch.map(lambda a: a[idx_t])
        merged, _ = merge_batch(sub)
        pred = experts[int(k)].apply(
            merged.x, merged.senders, merged.receivers, merged.edge_attr,
            edge_mask=merged.edge_mask).reshape(len(idx), n, -1)
        if len(idx) == b:
            return pred
        if out is None:
            out = pred.new_zeros((b, n, pred.shape[-1]))
        out[idx_t] = pred
    return out
