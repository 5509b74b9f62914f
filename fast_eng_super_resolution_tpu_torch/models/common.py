"""Shared building blocks for the models: init helpers, the conversion
between a torch ``nn.Linear`` and the reference's ``.pth`` state-dict keys,
and the move of a model's parameters to and from the JAX package's
parameter tree (each model names a parameter's key there: ``jax_key``)."""

from __future__ import annotations

import copy
import math

import numpy as np
import torch
from torch import nn

from ..core.checkpoint import flatten_params, unflatten_params


def linear_init(layer: nn.Linear, generator: torch.Generator,
                scale: float | None = None) -> None:
    """torch.nn.Linear-style init: U(-1/sqrt(c_in), 1/sqrt(c_in)) for w and b."""
    bound = scale if scale is not None else 1.0 / math.sqrt(layer.in_features)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)


def mlp_layers(sizes: list[int]) -> nn.ModuleList:
    """Linear layers ``sizes[0] -> sizes[1] -> ...`` (uninitialized: the
    owner draws them with ``linear_init``)."""
    return nn.ModuleList([nn.utils.skip_init(nn.Linear, a, b)
                          for a, b in zip(sizes[:-1], sizes[1:])])


def mlp_apply(layers, x: torch.Tensor, activation) -> torch.Tensor:
    """``activation`` after every layer but the last (the JAX package's
    ``mlp_apply``)."""
    for layer in layers[:-1]:
        x = activation(layer(x))
    return layers[-1](x)


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


def load_jax_tree(model: nn.Module, params: dict) -> None:
    """Copies the JAX package's parameter tree (numpy leaves) into
    ``model``, each parameter from its ``model.jax_key``."""
    flat = flatten_params(params)
    with torch.no_grad():
        for name, p in model.named_parameters():
            key, transposed = model.jax_key(name)
            a = np.asarray(flat[key], np.float32)
            p.copy_(torch.as_tensor(np.ascontiguousarray(
                a.T if transposed else a)))


def jax_tree(model: nn.Module) -> dict:
    """``model``'s parameters as the JAX package's tree of numpy arrays
    (``load_jax_tree``'s inverse)."""
    flat = {}
    for name, p in model.named_parameters():
        key, transposed = model.jax_key(name)
        a = p.detach().cpu().numpy()
        flat[key] = (a.T if transposed else a).copy()
    return unflatten_params(flat)


def with_edges_sorted(model: nn.Module) -> nn.Module:
    """``model`` promising receiver-sorted edges: a shallow copy sharing its
    parameters with ``edges_sorted`` True (the JAX package's
    ``dataclasses.replace(model, edges_sorted=True)``), or ``model`` itself
    when it has no such field."""
    if not hasattr(model, "edges_sorted"):
        return model
    view = copy.copy(model)
    view.edges_sorted = True
    return view
