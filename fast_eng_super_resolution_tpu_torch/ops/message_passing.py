"""Edge-conditioned graph convolution and its formulations (``mode``).

Reference math (NNConv_old, reference models/model.py:521-536; KernelConv,
model.py:421-445):

    W_e  = EdgeMLP(edge_attr_e).reshape(C_in, C_out)          # per-edge matrix
    m_e  = x_sender(e) @ W_e                                  # per-edge bmm
    out_i = mean_{e: receiver(e)=i} m_e + x_i @ root + bias

The JAX package's forms, of which the port has three:

- 'edge3d': the per-edge matrices from one [E, K] @ [K, C_in*C_out] GEMM,
  contracted by a batched einsum ('auto' on a CUDA device: the general
  serving lane's form).
- 'factored': the dominant contraction moved to the node axis,
  U = einsum('ni,kio->nko', x, M3); m_e = einsum('ek,eko->eo', h_e, U[src])
  + (x @ b3)[src] ('auto' on the CPU, as in the JAX package off the TPU).
- 'pallas': the per-edge messages from ``ops.pallas_mp.fused_edge_messages``
  (a hand-written CUDA kernel on the GPU, its plain version on the CPU);
  forward only, as in the JAX package.

'edge' (a TPU layout experiment) and 'lut' (the tabulated edge kernel) raise.
The serving path's fused layer is ops/fused_conv.py.
"""

from __future__ import annotations

import torch

from .pallas_mp import fused_edge_messages
from .segment import masked_segment_mean, masked_segment_sum

MODES = ("auto", "factored", "edge", "edge3d", "pallas", "lut")
_NOT_PORTED = {"edge": "a TPU layout experiment, ROADMAP.md queue A item 3",
               "lut": "ROADMAP.md queue A item 3"}


def check_mode(mode: str) -> None:
    """Raises on a mode the port does not take."""
    if mode in _NOT_PORTED:
        raise NotImplementedError(
            f"conv mode {mode!r} is not ported ({_NOT_PORTED[mode]})")
    if mode not in MODES:
        raise ValueError(f"unknown conv mode {mode!r} (expected one of {MODES})")


def resolve_mode(mode: str, device) -> str:
    """'auto' -> 'edge3d' on a CUDA device, 'factored' elsewhere; any other
    ported mode is returned as it is."""
    check_mode(mode)
    if mode != "auto":
        return mode
    return "edge3d" if torch.device(device).type == "cuda" else "factored"


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


def precompute_edge_kernel(edge_mlp, edge_attr: torch.Tensor,
                           activation=torch.relu, mode: str = "auto",
                           edge_mask: torch.Tensor | None = None):
    """Hoists the edge-attr-only part of the conv out of shared-weight loops:
    the per-edge kernel depends only on (params, edge_attr), so it is
    identical across depth.  Returns an opaque (mode, value) token for
    ``edge_conditioned_conv(precomputed=...)``: the per-edge matrices
    [E, c_in*c_out] for 'edge3d', the edge MLP's hidden features [E, K]
    otherwise.  ``edge_mask`` is read only by the (unported) 'lut' form."""
    del edge_mask
    mode = resolve_mode(mode, edge_attr.device)
    hidden = apply_edge_mlp_hidden(edge_mlp, edge_attr, activation)
    if mode == "edge3d":
        return (mode, edge_mlp[-1](hidden))
    return (mode, hidden)


def edge_conditioned_conv(x: torch.Tensor, senders: torch.Tensor,
                          receivers: torch.Tensor, edge_attr: torch.Tensor,
                          edge_mlp, root: torch.Tensor, bias: torch.Tensor,
                          edge_mask: torch.Tensor | None = None,
                          activation=torch.relu, aggr: str = "mean",
                          mode: str = "factored",
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
      activation: edge-MLP nonlinearity (ReLU for KernelNN, LeakyReLU for
        TEECNet).
      aggr: 'mean' (reference default) or 'sum'.
      mode: formulation, see the module docstring ('auto' resolves on x's
        device).
      root_input: node features for the root/self term; defaults to ``x``.
        TEECNet applies root to the pre-linear features while messages use
        ``linear(x)`` (model.py:430-445), so callers pass both.
      precomputed: token from ``precompute_edge_kernel``.
      degree: optional precomputed real-edge counts per node.

    Returns:
      [N, C_out] updated node features.
    """
    mode = resolve_mode(mode, x.device)
    n, c_in = x.shape
    last = edge_mlp[-1]
    c_out = last.out_features // c_in
    if precomputed is not None:
        pre_mode, value = precomputed
        if pre_mode != mode:
            raise ValueError(f"precomputed kernel for mode {pre_mode}, got {mode}")
    else:
        value = precompute_edge_kernel(edge_mlp, edge_attr, activation,
                                       mode)[1]
    src = senders.long()
    if mode == "edge3d":
        msg = torch.einsum("ei,eio->eo", x[src], value.reshape(-1, c_in, c_out))
    elif mode == "pallas":
        msg = fused_edge_messages(value, x[src], last.weight.t(), last.bias)
    else:  # factored
        m3 = last.weight.t().reshape(-1, c_in, c_out)
        u = torch.einsum("ni,kio->nko", x, m3)  # [N, K, C_out]
        v = x @ last.bias.reshape(c_in, c_out)  # [N, C_out]
        msg = torch.einsum("ek,eko->eo", value, u[src]) + v[src]
    if aggr == "mean":
        aggregated = masked_segment_mean(msg, receivers, n, edge_mask,
                                         count=degree)
    elif aggr == "sum":
        aggregated = masked_segment_sum(msg, receivers, n, edge_mask)
    else:
        raise ValueError(f"unknown aggr {aggr!r} (expected mean | sum)")
    xr = x if root_input is None else root_input
    return aggregated + xr @ root + bias
