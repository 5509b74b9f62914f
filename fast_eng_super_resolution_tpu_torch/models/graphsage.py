"""GraphSAGE baseline.

Parity target: the JAX package's ``models/graphsage.py``, itself the
reference's torch_geometric ``GraphSAGE(in_channels, out_channels,
num_layers=5)`` (utils.py:38-39): a stack of SAGEConv layers with hidden
size == out_channels, mean neighbour aggregation, ReLU between layers and
none after the last:

    h_i' = lin_l(mean_{j in N(i)} h_j) + lin_r(h_i)

``lin_l`` has a bias and ``lin_r`` none (PyG's SAGEConv).  The model has no
fused form (``fused_ok`` False): it serves through the general lane's
``apply`` and trains in the 'merged' layout.  Weights move to and from the
JAX package's parameter tree (``jax_key``); a tree saved with a ``lin_r``
bias (the JAX package's older checkpoints) loads with that bias kept.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.segment import masked_segment_mean, segment_degree
from .common import jax_tree, linear_init, load_jax_tree


class SAGELayer(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        skip = nn.utils.skip_init
        self.lin_l = skip(nn.Linear, c_in, c_out)
        self.lin_r = skip(nn.Linear, c_in, c_out, bias=False)


class GraphSAGE(nn.Module):
    fused_ok = False

    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 5, seed: int = 0):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.num_layers = num_layers
        self.layers = nn.ModuleList([
            SAGELayer(in_channels if i == 0 else out_channels, out_channels)
            for i in range(num_layers)])
        self.init_params(torch.Generator().manual_seed(seed))

    def init_params(self, generator: torch.Generator) -> None:
        """The JAX package's init distributions (``linear_init``'s
        U(-1/sqrt(c_in), 1/sqrt(c_in)); ``lin_r``'s weight drawn as a full
        linear layer's), from ``generator``."""
        for layer in self.layers:
            linear_init(layer.lin_l, generator)
            bound = 1.0 / layer.lin_r.in_features ** 0.5
            with torch.no_grad():
                layer.lin_r.weight.uniform_(-bound, bound, generator=generator)
                if layer.lin_r.bias is not None:
                    layer.lin_r.bias.uniform_(-bound, bound,
                                              generator=generator)

    def apply(self, x: torch.Tensor, senders: torch.Tensor,
              receivers: torch.Tensor, edge_attr: torch.Tensor | None = None,
              edge_mask: torch.Tensor | None = None) -> torch.Tensor:
        """Forward pass for one (padded) graph. x: [N, C_in] -> [N, C_out];
        ``edge_attr`` is unused (SAGEConv reads no edge features)."""
        n = x.shape[0]
        h = x
        # the degree is loop-invariant: one segment sum, not one per layer
        deg = segment_degree(receivers, n, edge_mask, x.dtype)
        src = senders.long()
        for i, layer in enumerate(self.layers):
            neigh = masked_segment_mean(h[src], receivers, n, edge_mask,
                                        count=deg)
            h = layer.lin_l(neigh) + layer.lin_r(h)
            if i < self.num_layers - 1:
                h = torch.relu(h)
        return h

    @staticmethod
    def jax_key(name: str) -> tuple[str, bool]:
        """(flat key in the JAX package's parameter tree, transposed?):
        ``layers.{i}.lin_l.weight`` -> ``layers/{i}/lin_l/w`` (w [in, out])."""
        layers, i, lin, leaf = name.split(".")
        return (f"{layers}/{i}/{lin}/{'w' if leaf == 'weight' else 'b'}",
                leaf == "weight")

    def from_jax_params(self, params: dict) -> "GraphSAGE":
        """Loads the JAX package's tree (numpy leaves); a layer whose
        ``lin_r`` carries a bias gets one, so an older checkpoint predicts
        what it validated as."""
        if len(params["layers"]) != self.num_layers:
            raise ValueError(f"checkpoint has {len(params['layers'])} layers, "
                             f"model {self.num_layers}")
        for layer, p in zip(self.layers, params["layers"]):
            if ("b" in p["lin_r"]) != (layer.lin_r.bias is not None):
                dev = layer.lin_r.weight.device
                layer.lin_r = nn.Linear(layer.lin_r.in_features,
                                        layer.lin_r.out_features,
                                        bias="b" in p["lin_r"], device=dev)
        load_jax_tree(self, params)
        return self

    def to_jax_params(self) -> dict:
        return jax_tree(self)
