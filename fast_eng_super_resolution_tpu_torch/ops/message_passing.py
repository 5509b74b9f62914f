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
- 'lut': the tabulated edge kernel.  The edge MLP maps a scalar (the edge
  length) to the c_in x c_out matrix, so it is sampled at ``lut_knots``
  knots spanning the real edges' range, the node-side products for every
  knot come from one GEMM, and each edge interpolates linearly between the
  two knots around its length: [E, 2, c_out] gathered instead of
  [E, c_in * c_out] computed.

``kernel_dtype`` (KernelNN's) stores the 'edge3d' per-edge matrices in that
type; the contraction rounds x the same way and accumulates in float32, as
the JAX package's ``preferred_element_type`` does.  'edge' (a TPU layout
experiment) raises.  The serving path's fused layer is ops/fused_conv.py.
"""

from __future__ import annotations

import torch

from .pallas_mp import fused_edge_messages
from .segment import masked_segment_mean, masked_segment_sum

MODES = ("auto", "factored", "edge", "edge3d", "pallas", "lut")
_NOT_PORTED = {"edge": "a TPU layout experiment, ROADMAP.md queue A item 3"}


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


def kernel_torch_dtype(kernel_dtype: str | None):
    """The torch type of a ``kernel_dtype`` name (None stays None)."""
    if kernel_dtype is None:
        return None
    dt = getattr(torch, str(kernel_dtype), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"unknown kernel_dtype {kernel_dtype!r}")
    return dt


def precompute_edge_kernel(edge_mlp, edge_attr: torch.Tensor,
                           activation=torch.relu, mode: str = "auto",
                           kernel_dtype: str | None = None,
                           lut_knots: int = 512,
                           edge_mask: torch.Tensor | None = None):
    """Hoists the edge-attr-only part of the conv out of shared-weight loops:
    the per-edge kernel depends only on (params, edge_attr), so it is
    identical across depth.  Returns an opaque (mode, value) token for
    ``edge_conditioned_conv(precomputed=...)``: the per-edge matrices
    [E, c_in*c_out] for 'edge3d' (in ``kernel_dtype`` when given), the
    table (w_knots, i0, frac) for 'lut', the edge MLP's hidden features
    [E, K] otherwise.

    'lut' spans its knots over the real edges (``edge_mask``) only: padding
    slots carry edge_attr 1.0, which on fine meshes would stretch the table
    far past the real range.  A graph whose edges are all masked keeps
    finite knots [0, 1], so the backward stays finite."""
    mode = resolve_mode(mode, edge_attr.device)
    if mode == "lut":
        knots = int(lut_knots)
        e = edge_attr[:, 0]
        if edge_mask is not None:
            lo = torch.where(edge_mask, e, torch.inf).min()
            hi = torch.where(edge_mask, e, -torch.inf).max()
            ok = torch.isfinite(lo) & torch.isfinite(hi)
            lo = torch.where(ok, lo, 0.0)
            hi = torch.where(ok, hi, 1.0)
        else:
            lo, hi = e.min(), e.max()
        span = (hi - lo).clamp_min(1e-30)
        grid = torch.arange(knots, device=e.device) / (knots - 1)
        knot_attr = (lo + span * grid)[:, None]
        w_knots = edge_mlp[-1](apply_edge_mlp_hidden(edge_mlp, knot_attr,
                                                     activation))
        t = (e - lo) / span * (knots - 1)
        i0 = torch.clamp(torch.floor(t).to(torch.int32), 0, knots - 2)
        return (mode, (w_knots, i0, t - i0.to(t.dtype)))
    hidden = apply_edge_mlp_hidden(edge_mlp, edge_attr, activation)
    if mode == "edge3d":
        w_e = edge_mlp[-1](hidden)
        dt = kernel_torch_dtype(kernel_dtype)
        return (mode, w_e if dt is None else w_e.to(dt))
    return (mode, hidden)


def edge_conditioned_conv(x: torch.Tensor, senders: torch.Tensor,
                          receivers: torch.Tensor, edge_attr: torch.Tensor,
                          edge_mlp, root: torch.Tensor, bias: torch.Tensor,
                          edge_mask: torch.Tensor | None = None,
                          activation=torch.relu, aggr: str = "mean",
                          mode: str = "factored",
                          root_input: torch.Tensor | None = None,
                          precomputed=None,
                          degree: torch.Tensor | None = None,
                          edges_sorted: bool = False,
                          lut_knots: int = 512) -> torch.Tensor:
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
      edges_sorted: the caller's promise of ascending receivers (pad_graph
        emits them sorted).  A hint that changes no bit: the JAX package
        picks a sorted-scatter lowering from it; the segment sums here
        read no order.
      lut_knots: the table size of mode 'lut' when ``precomputed`` is None.

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
                                       mode, edge_mask=edge_mask,
                                       lut_knots=lut_knots)[1]
    src = senders.long()
    if mode == "edge3d":
        xs = x[src]
        if value.dtype != xs.dtype:
            # x rounded as the matrices are, the products summed in float32
            xs, value = xs.to(value.dtype).to(xs.dtype), value.to(xs.dtype)
        msg = torch.einsum("ei,eio->eo", xs, value.reshape(-1, c_in, c_out))
    elif mode == "lut":
        # the node-side knot products as one GEMM, then per edge the two
        # interpolation endpoints
        w_knots, i0, frac = value
        kk = w_knots.shape[0]
        w2 = (w_knots.reshape(kk, c_in, c_out).permute(1, 0, 2)
              .reshape(c_in, kk * c_out))
        uf = (x @ w2).reshape(n * kk, c_out)
        base = src * kk + i0.long()
        msg = (uf[base] * (1.0 - frac)[:, None]
               + uf[base + 1] * frac[:, None])
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
