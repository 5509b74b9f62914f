"""DeepONet — branch/trunk operator network on regular grids.

Parity target: the JAX package's ``models/deeponet.py`` (reference
models/model.py:213-256).  Branch and trunk are 3-layer ReLU MLPs; the
output is their elementwise product, the trunk evaluated on the unit
meshgrid ('ij' indexing) of the input's grid.  ``AdaptDeepONet``
(model.py:185-210) sums that product over its channels to [B, n, n, 1].
As in the JAX package, ``init_model('deeponet', ...)`` needs the exp-config
key ``trunk_size``, which the reference's factory demands too.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import (from_torch_linear, jax_tree, linear_init, load_jax_tree,
                     mlp_apply, mlp_layers)
from .fno import _grid_coords


class DeepONet(nn.Module):
    def __init__(self, branch_input_dim: int, trunk_input_dim: int,
                 hidden_dim: int, output_dim: int, seed: int = 0):
        super().__init__()
        h, o = hidden_dim, output_dim
        self.branch_input_dim, self.trunk_input_dim = (branch_input_dim,
                                                       trunk_input_dim)
        self.hidden_dim, self.output_dim = hidden_dim, output_dim
        self.branch = mlp_layers([branch_input_dim, h, h, o])
        self.trunk = mlp_layers([trunk_input_dim, h, h, o])
        self.init_params(torch.Generator().manual_seed(seed))

    def init_params(self, generator: torch.Generator) -> None:
        """torch.nn.Linear's uniform init for every layer, drawn from
        ``generator`` (the draws differ from jax.random's)."""
        for layer in (*self.branch, *self.trunk):
            linear_init(layer, generator)

    def forward(self, branch_input: torch.Tensor,
                boundary_info=None) -> torch.Tensor:
        """branch_input: [B, n, n, C] -> [B, n, n, output_dim]."""
        b, n = branch_input.shape[0], branch_input.shape[1]
        r = _grid_coords(n, branch_input.device)
        gx, gy = torch.meshgrid(r, r, indexing="ij")
        grid = torch.stack([gx, gy], -1).expand(b, n, n, 2)
        return (mlp_apply(self.branch, branch_input, torch.relu)
                * mlp_apply(self.trunk, grid, torch.relu))

    apply = forward

    @staticmethod
    def jax_key(name: str) -> tuple[str, bool]:
        """(flat key in the JAX package's tree, transposed?): ``branch.0.weight``
        is ``branch/0/w`` [in, out]."""
        net, i, leaf = name.split(".")
        return f"{net}/{i}/{leaf[0]}", leaf == "weight"

    def from_jax_params(self, params: dict) -> "DeepONet":
        load_jax_tree(self, params)
        return self

    def to_jax_params(self) -> dict:
        return jax_tree(self)

    def import_pth(self, state_dict) -> "DeepONet":
        """Loads the reference's state_dict (model.py:213-233 layout:
        ``branch.{0,2,4}.*``, ``trunk.{0,2,4}.*``; ReLUs between)."""
        sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else v
              for k, v in state_dict.items()}
        for net in ("branch", "trunk"):
            for layer, i in zip(getattr(self, net), (0, 2, 4)):
                from_torch_linear(layer, sd, f"{net}.{i}")
        return self


class AdaptDeepONet(DeepONet):
    """adaptDeepONet (reference model.py:185-210): DeepONet on grid patches,
    its output summed over the channels to [B, n, n, 1]."""

    def __init__(self, branch_size: int, trunk_size: int, hidden_dim: int,
                 num_outputs: int, seed: int = 0):
        super().__init__(branch_size, trunk_size, hidden_dim, num_outputs,
                         seed=seed)

    def forward(self, x: torch.Tensor, boundary=None) -> torch.Tensor:
        return super().forward(x, boundary).sum(-1, keepdim=True)

    apply = forward

