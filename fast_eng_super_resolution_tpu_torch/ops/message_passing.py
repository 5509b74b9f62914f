"""Edge-conditioned graph convolution, the 'edge3d' form.

Reference math (NNConv_old, reference models/model.py:521-536):

    W_e  = EdgeMLP(edge_attr_e).reshape(C_in, C_out)          # per-edge matrix
    m_e  = x_sender(e) @ W_e                                  # per-edge bmm
    out_i = mean_{e: receiver(e)=i} m_e + x_i @ root + bias

'edge3d' forms the per-edge matrices with one [E, K] @ [K, C_in*C_out] GEMM
and contracts them with a batched einsum.  It is the plain whole-graph
reference; the serving path runs the fused layer (ops/fused_conv.py).  The
JAX package's other forms ('factored', 'edge', 'lut', 'pallas') are not
ported.
"""

from __future__ import annotations

import torch

from .segment import masked_segment_mean, masked_segment_sum


def apply_edge_mlp_hidden(layers, e: torch.Tensor, activation) -> torch.Tensor:
    """Runs all but the last layer of the edge MLP (DenseNet, model.py:289-315).

    ``layers`` is the list of ``nn.Linear`` layers; activation is applied
    after each layer except the last, which is not applied here at all.
    Returns the post-activation hidden features [E, K].
    """
    h = e
    for layer in layers[:-1]:
        h = activation(layer(h))
    return h


def _check_mode(mode: str) -> None:
    if mode != "edge3d":
        raise NotImplementedError(
            f"conv mode {mode!r}: only 'edge3d' is ported "
            "(ROADMAP.md queue A item 3)")


def precompute_edge_kernel(edge_mlp, edge_attr: torch.Tensor,
                           activation=torch.relu, mode: str = "edge3d"):
    """Hoists the edge-attr-only part of the conv out of shared-weight loops:
    the per-edge kernel matrices depend only on (params, edge_attr), so they
    are identical across depth.  Returns an opaque (mode, value) token for
    ``edge_conditioned_conv(precomputed=...)``."""
    _check_mode(mode)
    hidden = apply_edge_mlp_hidden(edge_mlp, edge_attr, activation)
    return (mode, edge_mlp[-1](hidden))  # [E, c_in*c_out]


def edge_conditioned_conv(x: torch.Tensor, senders: torch.Tensor,
                          receivers: torch.Tensor, edge_attr: torch.Tensor,
                          edge_mlp, root: torch.Tensor, bias: torch.Tensor,
                          edge_mask: torch.Tensor | None = None,
                          activation=torch.relu, aggr: str = "mean",
                          mode: str = "edge3d",
                          root_input: torch.Tensor | None = None,
                          precomputed=None,
                          degree: torch.Tensor | None = None) -> torch.Tensor:
    """One edge-conditioned convolution layer (single graph, static shapes).

    Args:
      x: [N, C_in] node features entering the message computation.
      senders/receivers: [E] int.
      edge_attr: [E, A].
      edge_mlp: list of ``nn.Linear``; the last maps K -> C_in*C_out.
      root: [C_r, C_out] self-connection weight; bias: [C_out].
      edge_mask: [E] bool.
      activation: edge-MLP nonlinearity.
      aggr: 'mean' (reference default) or 'sum'.
      root_input: node features for the root/self term; defaults to ``x``.
      precomputed: token from ``precompute_edge_kernel``.
      degree: optional precomputed real-edge counts per node.

    Returns:
      [N, C_out] updated node features.
    """
    _check_mode(mode)
    n, c_in = x.shape
    c_out = edge_mlp[-1].out_features // c_in
    if precomputed is not None:
        pre_mode, w_e_flat = precomputed
        if pre_mode != mode:
            raise ValueError(f"precomputed kernel for mode {pre_mode}, got {mode}")
    else:
        w_e_flat = precompute_edge_kernel(edge_mlp, edge_attr, activation,
                                          mode)[1]
    msg = torch.einsum("ei,eio->eo", x[senders.long()],
                       w_e_flat.reshape(-1, c_in, c_out))
    if aggr == "mean":
        aggregated = masked_segment_mean(msg, receivers, n, edge_mask,
                                         count=degree)
    elif aggr == "sum":
        aggregated = masked_segment_sum(msg, receivers, n, edge_mask)
    else:
        raise ValueError(f"unknown aggr {aggr!r} (expected mean | sum)")
    xr = x if root_input is None else root_input
    return aggregated + xr @ root + bias
