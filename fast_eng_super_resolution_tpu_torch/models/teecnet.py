"""TEECNet — Taylor-series Expansion Error Correction Network.

Parity target: reference models/model.py:259-286 (TEECNet) with its shared
KernelConv (model.py:365-448): messages are ``linear(x_j) @ W_op(e)`` where
``W_op = DenseNet([in_edge, 32, 64, 128, width**2], LeakyReLU)(e)``
(model.py:403, 426-441), aggregation 'mean' (model.py:394), and the update
adds ``x @ root + bias`` on the *pre-linear* node features (model.py:444-445).
There is no nonlinearity between layers (model.py:280-282), so on random
weights and inputs the output can grow large: compare it relative to its max.

``apply`` is the plain whole-graph form in the conv formulation ``mode``
(ops/message_passing.py, 'edge' included); ``apply_fused`` and
``apply_fused_ad`` run each layer through the fused edge-conv layer on
``linear(h)`` (B1 forward and B2 backward on the GPU), with the same
signatures as KernelNN's, so the serving lanes and the trainer take either
model.  The JAX package's ``remat``, an XLA
scheduling knob, is left out; ``edges_sorted`` is kept as a hint that
changes no bit.  ``kernel_type='powerseries'`` (models/powerseries.py, which
``init_model`` never builds, as in the JAX package) makes the per-edge
matrices with the nonlinear power-series stack ``kernel.ps``: its last stage
is nonlinear, so it has no fused form (``fused_ok`` False; ``apply_fused``
and ``apply_fused_ad`` raise) and serves and trains through ``apply``, the
general lane and the 'merged' layout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.message_passing import (apply_edge_mlp_hidden, check_mode,
                                   edge_conditioned_conv,
                                   precompute_edge_kernel, resolve_mode)
from ..ops.segment import masked_segment_mean, segment_degree
from .common import (from_torch_linear, jax_tree, linear_init, load_jax_tree,
                     pyg_uniform_init, to_torch_linear)
from .powerseries import PowerSeriesKernel

_leaky_relu = functools.partial(F.leaky_relu, negative_slope=0.01)
_EDGE_HIDDEN = (32, 64, 128)  # the operator kernel's hidden widths (model.py:403)
_PTH_EDGE = (0, 2, 4, 6)      # its Linear layers' indices in the .pth


class KernelConv(nn.Module):
    """TEECNet's shared conv weights (model.py:365-409): the node-side
    ``linear``, the operator kernel ``edge_mlp``, ``root`` and ``bias``."""

    def __init__(self, width: int, in_edge: int):
        super().__init__()
        skip = nn.utils.skip_init
        self.linear = skip(nn.Linear, width, width)
        sizes = (in_edge, *_EDGE_HIDDEN, width * width)
        self.edge_mlp = nn.ModuleList([skip(nn.Linear, a, b)
                                       for a, b in zip(sizes[:-1], sizes[1:])])
        self.root = nn.Parameter(torch.empty(width, width))
        self.bias = nn.Parameter(torch.empty(width))


class TEECNet(nn.Module):
    """Mirrors TEECNet.__init__ (model.py:269-276)."""

    def __init__(self, in_channels: int, width: int, out_channels: int,
                 num_layers: int = 4, in_edge: int = 1, mode: str = "auto",
                 kernel_type: str = "dense", num_powers: int = 3,
                 ps_layers: int = 3, edges_sorted: bool = False,
                 seed: int = 0):
        super().__init__()
        if kernel_type not in ("dense", "powerseries"):
            raise ValueError(f"unknown kernel_type {kernel_type!r} "
                             "(expected dense | powerseries)")
        check_mode(mode)
        self.in_channels, self.width, self.out_channels = (
            in_channels, width, out_channels)
        self.num_layers, self.in_edge = num_layers, in_edge
        self.mode, self.kernel_type = mode, kernel_type
        self.num_powers, self.ps_layers = num_powers, ps_layers
        self.edges_sorted = edges_sorted  # a hint (see KernelNN)
        skip = nn.utils.skip_init
        self.fc1 = skip(nn.Linear, in_channels, width)
        self.kernel = KernelConv(width, in_edge)
        if kernel_type == "powerseries":
            self.kernel.ps = PowerSeriesKernel(in_edge, width * width,
                                               ps_layers, num_powers)
        self.fc_out = skip(nn.Linear, width, out_channels)
        self.init_params(torch.Generator().manual_seed(seed))

    @property
    def fused_ok(self) -> bool:
        """The fused layer folds the operator kernel's last Linear into the
        kernel: valid for the dense kernel only (the power-series kernel is
        nonlinear in its last stage)."""
        return self.kernel_type == "dense"

    def _check_fused(self) -> None:
        """The fused forms build every layer from the dense operator
        kernel ``edge_mlp``; a power-series model's own kernel is
        ``kernel.ps``, so they refuse it rather than compute another
        model's math."""
        if not self.fused_ok:
            raise ValueError(
                f"kernel_type={self.kernel_type!r} has no fused form: serve "
                "and train it through apply (the general lane, the 'merged' "
                "layout)")

    def init_params(self, generator: torch.Generator) -> None:
        """The JAX package's init distributions (TEECNet.init), drawn from
        ``generator`` (the draws themselves differ from jax.random's)."""
        kern = self.kernel
        linear_init(self.fc1, generator)
        linear_init(kern.linear, generator)
        for layer in kern.edge_mlp:
            linear_init(layer, generator)
        pyg_uniform_init(kern.root, self.width, generator)
        pyg_uniform_init(kern.bias, self.width, generator)
        linear_init(self.fc_out, generator)
        if self.kernel_type == "powerseries":
            kern.ps.init_params(generator)

    def apply(self, x: torch.Tensor, senders: torch.Tensor,
              receivers: torch.Tensor, edge_attr: torch.Tensor,
              edge_mask: torch.Tensor | None = None) -> torch.Tensor:
        """Forward pass for one (padded) graph. x: [N, C_in] -> [N, C_out].
        The per-edge operator kernel is shared across layers: computed once."""
        kern = self.kernel
        h = self.fc1(x)
        deg = segment_degree(receivers, x.shape[0], edge_mask)
        if self.kernel_type == "powerseries":
            # per-edge matrices from the nonlinear series (whatever the mode)
            w_e = kern.ps(edge_attr).reshape(-1, self.width, self.width)
            src = senders.long()
            for _ in range(self.num_layers):
                msg = torch.einsum("ei,eio->eo", kern.linear(h)[src], w_e)
                h = (masked_segment_mean(msg, receivers, h.shape[0],
                                         edge_mask, count=deg)
                     + h @ kern.root + kern.bias)
            return self.fc_out(h)
        mode = resolve_mode(self.mode, x.device)
        pre = precompute_edge_kernel(kern.edge_mlp, edge_attr, _leaky_relu,
                                     mode, edge_mask=edge_mask)
        for _ in range(self.num_layers):
            h = edge_conditioned_conv(
                kern.linear(h), senders, receivers, edge_attr, kern.edge_mlp,
                kern.root, kern.bias, edge_mask=edge_mask,
                activation=_leaky_relu, mode=mode, root_input=h,
                precomputed=pre, degree=deg, edges_sorted=self.edges_sorted)
        return self.fc_out(h)

    def apply_fused(self, x: torch.Tensor, edge_attr_blocked: torch.Tensor,
                    senders_perm: torch.Tensor, s_matrix, *, rows_blk: int,
                    blk: int, gemm_dtype: str = "bfloat16") -> torch.Tensor:
        """Forward via the fused conv layer (ops/fused_conv.py), as
        ``KernelNN.apply_fused``: the operator kernel's hidden layers once,
        then per layer the fused layer on ``linear(h)`` and
        ``agg[:n] + h @ root + bias`` on the pre-linear ``h``."""
        from ..ops.fused_conv import _gemm_dtype, fused_edge_conv

        self._check_fused()
        kern = self.kernel
        dt = _gemm_dtype(gemm_dtype)
        n = x.shape[0]
        h = self.fc1(x)
        h_e = apply_edge_mlp_hidden(kern.edge_mlp, edge_attr_blocked,
                                    _leaky_relu)
        last = kern.edge_mlp[-1]
        # cast once: the layer's operands are layer-invariant
        h_e = h_e.to(dt).contiguous()
        w3 = last.weight.t().to(dt).contiguous()
        b3 = last.bias.float().contiguous()
        for _ in range(self.num_layers):
            agg = fused_edge_conv(h_e, kern.linear(h), senders_perm, w3, b3,
                                  s_matrix, c_in=self.width, c_out=self.width,
                                  rows_blk=rows_blk, blk=blk,
                                  gemm_dtype=gemm_dtype)
            h = agg[:n] + h @ kern.root + kern.bias
        return self.fc_out(h)

    def apply_fused_ad(self, x: torch.Tensor, edge_attr_blocked: torch.Tensor,
                       fused_aux: dict, s_matrix, *, rows_blk: int, blk: int,
                       gemm_dtype: str = "bfloat16") -> torch.Tensor:
        """Differentiable fused forward (training path): ``apply_fused``'s
        math, each layer through ``ops.fused_conv.fused_edge_conv_ad``
        (B1 forward, B2 backward).  ``fused_aux`` and ``s_matrix`` come from
        ``prepare_fused_train``."""
        from ..ops.fused_conv import fused_edge_conv_ad

        self._check_fused()
        kern = self.kernel
        n = x.shape[0]
        h = self.fc1(x)
        h_e = apply_edge_mlp_hidden(kern.edge_mlp, edge_attr_blocked,
                                    _leaky_relu)
        last = kern.edge_mlp[-1]
        w3 = last.weight.t()
        for _ in range(self.num_layers):
            agg = fused_edge_conv_ad(h_e, kern.linear(h), w3, last.bias,
                                     s_matrix, fused_aux, c_in=self.width,
                                     c_out=self.width, rows_blk=rows_blk,
                                     blk=blk, gemm_dtype=gemm_dtype)
            h = agg[:n] + h @ kern.root + kern.bias
        return self.fc_out(h)

    @staticmethod
    def prepare_fused(senders, receivers, edge_attr, n_nodes,
                      edge_mask=None, rows_blk: int = 64,
                      quantum: int = 256, compact: bool = False):
        """Host-side (numpy) fused-path operands for a static graph:
        (edge_attr_blocked, senders_perm, s_matrix, rows_blk, blk)."""
        from ..ops.fused_conv import prepare_fused

        return prepare_fused(senders, receivers, edge_attr, n_nodes,
                             edge_mask, rows_blk, quantum, compact=compact)

    @staticmethod
    def prepare_fused_train(senders, receivers, edge_attr, n_nodes,
                            edge_mask=None, rows_blk: int = 64,
                            quantum: int = 256, compact: bool = False):
        """Host-side operands for ``apply_fused_ad``:
        (edge_attr_blocked, fused_aux, s_matrix, rows_blk, blk)."""
        from ..ops.fused_conv import prepare_fused_train

        return prepare_fused_train(senders, receivers, edge_attr, n_nodes,
                                   edge_mask, rows_blk, quantum,
                                   compact=compact)

    # -- weight layouts ----------------------------------------------------
    def _check_shapes(self, root_width: int, fc1_shape) -> None:
        if root_width != self.width:
            raise ValueError(
                f"checkpoint width {root_width} does not match model config "
                f"width {self.width}")
        if tuple(fc1_shape) != (self.width, self.in_channels):
            raise ValueError(
                f"checkpoint fc1 {tuple(fc1_shape)} does not match "
                f"(width={self.width}, in_channels={self.in_channels})")

    def import_pth(self, state_dict) -> "TEECNet":
        """Loads a reference checkpoint (torch state_dict / numpy dict).

        Key layout per logs/models/collection_duct_teecnet/partition_0.pth:
        fc1.*, kernel.{root_param, bias, linear.*,
        operator_kernel.layers.{0,2,4,6}.*}, fc_out.*.
        """
        sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else v
              for k, v in state_dict.items()}
        self._check_shapes(sd["kernel.root_param"].shape[0],
                           sd["fc1.weight"].shape)
        kern = self.kernel
        from_torch_linear(self.fc1, sd, "fc1")
        from_torch_linear(kern.linear, sd, "kernel.linear")
        for i, layer in zip(_PTH_EDGE, kern.edge_mlp):
            from_torch_linear(layer, sd, f"kernel.operator_kernel.layers.{i}")
        with torch.no_grad():
            kern.root.copy_(torch.tensor(
                np.asarray(sd["kernel.root_param"], np.float32)))
            kern.bias.copy_(torch.tensor(
                np.asarray(sd["kernel.bias"], np.float32)))
        from_torch_linear(self.fc_out, sd, "fc_out")
        return self

    def export_pth(self) -> dict:
        """Inverse of import_pth — numpy state_dict in the reference's layout."""
        kern = self.kernel
        out: dict = {}
        to_torch_linear(self.fc1, "fc1", out)
        to_torch_linear(kern.linear, "kernel.linear", out)
        for i, layer in zip(_PTH_EDGE, kern.edge_mlp):
            to_torch_linear(layer, f"kernel.operator_kernel.layers.{i}", out)
        out["kernel.root_param"] = kern.root.detach().cpu().numpy().copy()
        out["kernel.bias"] = kern.bias.detach().cpu().numpy().copy()
        to_torch_linear(self.fc_out, "fc_out", out)
        return out

    def from_jax_params(self, params: dict) -> "TEECNet":
        """Loads the JAX package's TEECNet parameter tree (numpy leaves:
        fc1/{w,b}, kernel/linear, kernel/edge_mlp/[4], kernel/root,
        kernel/bias, fc_out, and kernel/ps for the power-series kernel)."""
        self._check_shapes(np.shape(params["kernel"]["root"])[0],
                           np.shape(params["fc1"]["w"])[::-1])
        load_jax_tree(self, params)
        return self

    @staticmethod
    def jax_key(name: str) -> tuple[str, bool]:
        """(flat key in the JAX package's parameter tree, transposed?) of the
        parameter ``name``: a linear layer's weight is stored there as
        w [in, out], the transpose of ``nn.Linear.weight``; a power-series
        conv keeps its w, b beside its root_param (no ``linear`` level)."""
        *path, leaf = name.split(".")
        if leaf not in ("weight", "bias") or name in ("kernel.root",
                                                      "kernel.bias"):
            return "/".join(path + [leaf]), False
        if path[:2] == ["kernel", "ps"]:
            path = path[:-1]  # kernel.ps.<conv>.linear.weight -> .../<conv>/w
        return "/".join(path + [{"weight": "w", "bias": "b"}[leaf]]), \
            leaf == "weight"

    def to_jax_params(self) -> dict:
        """The JAX package's parameter tree, numpy leaves (``from_jax_params``
        inverse; ``core.checkpoint.save_params`` writes it)."""
        return jax_tree(self)
