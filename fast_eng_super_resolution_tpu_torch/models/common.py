"""Shared building blocks for the models: init helpers and the conversion
between a torch ``nn.Linear`` and the reference's ``.pth`` state-dict keys.
(The JAX package's parameter-tree layout is ``KernelNN.jax_key``.)"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def linear_init(layer: nn.Linear, generator: torch.Generator,
                scale: float | None = None) -> None:
    """torch.nn.Linear-style init: U(-1/sqrt(c_in), 1/sqrt(c_in)) for w and b."""
    bound = scale if scale is not None else 1.0 / math.sqrt(layer.in_features)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)


def pyg_uniform_init(param: torch.Tensor, size: int,
                     generator: torch.Generator) -> None:
    """torch_geometric.nn.inits.uniform: U(-1/sqrt(size), 1/sqrt(size))."""
    bound = 1.0 / math.sqrt(size)
    with torch.no_grad():
        param.uniform_(-bound, bound, generator=generator)


def from_torch_linear(layer: nn.Linear, state_dict, prefix: str) -> None:
    """Loads '{prefix}.weight' [out, in] and '{prefix}.bias' into ``layer``."""
    with torch.no_grad():
        layer.weight.copy_(torch.tensor(
            np.asarray(state_dict[f"{prefix}.weight"], np.float32)))
        layer.bias.copy_(torch.tensor(
            np.asarray(state_dict[f"{prefix}.bias"], np.float32)))


def to_torch_linear(layer: nn.Linear, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = layer.weight.detach().cpu().numpy().copy()
    out[f"{prefix}.bias"] = layer.bias.detach().cpu().numpy().copy()
