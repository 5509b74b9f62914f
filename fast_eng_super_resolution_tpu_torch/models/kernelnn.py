"""KernelNN ("neuralop") — the reference's default surrogate model.

Parity target: reference models/model.py:543-562 (KernelNN) built on
NNConv_old (model.py:451-540) with a shared DenseNet edge kernel
[ker_in, ker_width, ker_width, width**2] + ReLU (model.py:550) and
aggr='mean' (model.py:551).  Forward: fc1 -> depth x relu(conv) -> fc2
(model.py:555-562), the conv weights shared across depth (model.py:558-559).

``apply`` is the plain whole-graph form in the conv formulation ``mode``
(ops/message_passing.py: 'auto', 'edge3d', 'factored', 'pallas', 'lut');
the JAX package's scheduling knob ``remat`` changes no result and is left
out, and ``edges_sorted`` is kept as a hint that changes no bit.
``kernel_dtype`` (e.g. 'bfloat16') stores the 'edge3d' per-edge matrices
(and the rank-r U, V) in that type, as the JAX package does, and
``lut_knots`` sizes mode 'lut''s table; both only affect ``apply``.
``apply_fused`` runs each layer through the fused edge-conv layer (ops/fused_conv.py), a hand-written CUDA
kernel on the GPU, and ``apply_fused_ad`` is its differentiable form for
training (the backward a second hand-written kernel).  With ``kernel_rank``
= r the edge MLP's head gives each edge a factorized kernel W_e = U_e V_e^T
(U_e, V_e [width, r], head width 2 r width) and every form runs the rank-r
layer instead (the JAX package's ``_apply_lowrank`` and the rank-r fused
kernels).  Weights move in and
out in two layouts besides the module's own: the reference's ``.pth`` state
dict (``import_pth``/``export_pth``) and the JAX package's parameter tree
(``from_jax_params``/``to_jax_params``, one key per parameter: ``jax_key``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.message_passing import (apply_edge_mlp_hidden, check_mode,
                                   edge_conditioned_conv, kernel_torch_dtype,
                                   precompute_edge_kernel, resolve_mode)
from ..ops.segment import masked_segment_mean, segment_degree
from .common import (from_torch_linear, jax_tree, linear_init, load_jax_tree,
                     pyg_uniform_init, to_torch_linear)


class KernelNN(nn.Module):
    """Mirrors KernelNN.__init__ (model.py:544-553)."""

    def __init__(self, width: int, ker_width: int, depth: int,
                 ker_in: int = 1, in_width: int = 3, out_width: int = 3,
                 mode: str = "auto", kernel_rank: int | None = None,
                 kernel_dtype: str | None = None, lut_knots: int = 512,
                 edges_sorted: bool = False, seed: int = 0):
        super().__init__()
        check_mode(mode)
        kernel_torch_dtype(kernel_dtype)  # raises on an unknown type
        if int(lut_knots) < 2:
            raise ValueError(f"lut_knots={lut_knots!r}: needs at least 2")
        self.width, self.ker_width, self.depth = width, ker_width, depth
        self.ker_in, self.in_width, self.out_width = ker_in, in_width, out_width
        self.mode = mode
        self.kernel_rank = kernel_rank
        self.kernel_dtype, self.lut_knots = kernel_dtype, lut_knots
        # promise of receiver-sorted edges (pad_graph emits them sorted): a
        # hint that changes no bit, kept for the JAX package's field
        self.edges_sorted = edges_sorted
        skip = nn.utils.skip_init
        self.fc1 = skip(nn.Linear, in_width, width)
        self.edge_mlp = nn.ModuleList([
            skip(nn.Linear, ker_in, ker_width),
            skip(nn.Linear, ker_width, ker_width),
            skip(nn.Linear, ker_width, self.head_width)])
        self.root = nn.Parameter(torch.empty(width, width))
        self.bias = nn.Parameter(torch.empty(width))
        self.fc2 = skip(nn.Linear, width, out_width)
        self.init_params(torch.Generator().manual_seed(seed))

    @property
    def head_width(self) -> int:
        """The edge MLP's output width: width^2 at full rank, 2 r width
        (U_e then V_e) at rank r."""
        w, r = self.width, self.kernel_rank
        return w * w if r is None else 2 * r * w

    def init_params(self, generator: torch.Generator) -> None:
        """The JAX package's init distributions (KernelNN.init), drawn from
        ``generator`` (the draws themselves differ from jax.random's)."""
        linear_init(self.fc1, generator)
        for layer in self.edge_mlp:
            linear_init(layer, generator)
        pyg_uniform_init(self.root, self.width, generator)
        pyg_uniform_init(self.bias, self.width, generator)
        linear_init(self.fc2, generator)

    def apply(self, x: torch.Tensor, senders: torch.Tensor,
              receivers: torch.Tensor, edge_attr: torch.Tensor,
              edge_mask: torch.Tensor | None = None) -> torch.Tensor:
        """Forward pass for one (padded) graph. x: [N, C_in] -> [N, C_out].

        The per-edge kernel is loop-invariant (shared weights), so it is
        computed once, not depth times.  The rank-r branch ignores ``mode``,
        as in the JAX package."""
        h = self.fc1(x)
        if self.kernel_rank is not None:
            return self._apply_lowrank(h, senders, receivers, edge_attr,
                                       edge_mask)
        mode = resolve_mode(self.mode, x.device)
        pre = precompute_edge_kernel(self.edge_mlp, edge_attr, torch.relu,
                                     mode, edge_mask=edge_mask,
                                     kernel_dtype=self.kernel_dtype,
                                     lut_knots=self.lut_knots)
        deg = segment_degree(receivers, x.shape[0], edge_mask)
        for _ in range(self.depth):
            h = torch.relu(edge_conditioned_conv(
                h, senders, receivers, edge_attr, self.edge_mlp, self.root,
                self.bias, edge_mask=edge_mask, mode=mode, precomputed=pre,
                degree=deg, edges_sorted=self.edges_sorted,
                lut_knots=self.lut_knots))
        return self.fc2(h)

    def _apply_lowrank(self, h: torch.Tensor, senders: torch.Tensor,
                       receivers: torch.Tensor, edge_attr: torch.Tensor,
                       edge_mask: torch.Tensor | None) -> torch.Tensor:
        """Rank-r conv: msg_e = (h[s_e] @ U_e) @ V_e^T, scatter-mean; U/V
        from one loop-invariant edge-MLP pass [E, 2 r w].  With
        ``kernel_dtype``, U, V, h[s_e] and the first product are rounded to
        it (float32 sums), as the JAX package computes them under jit: XLA
        keeps the second product, converted straight back, in float32."""
        w, r = self.width, self.kernel_rank
        dt = kernel_torch_dtype(self.kernel_dtype)
        rnd = ((lambda a: a) if dt is None
               else (lambda a: a.to(dt).to(torch.float32)))
        hid = apply_edge_mlp_hidden(self.edge_mlp, edge_attr, torch.relu)
        uv = rnd(self.edge_mlp[-1](hid))
        u = uv[:, :w * r].reshape(-1, w, r)
        v = uv[:, w * r:].reshape(-1, w, r)
        deg = segment_degree(receivers, h.shape[0], edge_mask)
        for _ in range(self.depth):
            t = rnd(torch.einsum("ei,eir->er", rnd(h[senders.long()]), u))
            msg = torch.einsum("er,eor->eo", t, v)
            agg = masked_segment_mean(msg, receivers, h.shape[0], edge_mask,
                                      count=deg)
            h = torch.relu(agg + h @ self.root + self.bias)
        return self.fc2(h)

    def _fused_layer_kw(self, rows_blk: int, blk: int, gemm_dtype: str) -> dict:
        kw = dict(c_in=self.width, c_out=self.width, rows_blk=rows_blk,
                  blk=blk, gemm_dtype=gemm_dtype)
        if self.kernel_rank is not None:
            kw["rank"] = self.kernel_rank
        return kw

    def apply_fused(self, x: torch.Tensor, edge_attr_blocked: torch.Tensor,
                    senders_perm: torch.Tensor, s_matrix, *, rows_blk: int,
                    blk: int, gemm_dtype: str = "bfloat16") -> torch.Tensor:
        """Forward via the fused conv layer (ops/fused_conv.py).

        The edge MLP's hidden layer runs once (layer-invariant), then depth x
        fused conv, then ``agg[:n] + h @ root + bias`` and ReLU.  bf16 GEMM
        inputs by default, as in the JAX package; 'float32' for
        full-precision parity.  ``s_matrix`` is dense S or a ``CompactS``.
        A rank-r model runs the rank-r layer (B3 on the GPU).
        """
        from ..ops.fused_conv import (_gemm_dtype, fused_edge_conv,
                                      fused_edge_conv_lowrank)

        layer = (fused_edge_conv if self.kernel_rank is None
                 else fused_edge_conv_lowrank)
        kw = self._fused_layer_kw(rows_blk, blk, gemm_dtype)
        dt = _gemm_dtype(gemm_dtype)
        n = x.shape[0]
        h = self.fc1(x)
        h_e = apply_edge_mlp_hidden(self.edge_mlp, edge_attr_blocked,
                                    torch.relu)
        last = self.edge_mlp[-1]
        # cast once: the layer's operands are depth-invariant
        h_e = h_e.to(dt).contiguous()
        w3 = last.weight.t().to(dt).contiguous()
        b3 = last.bias.float().contiguous()
        for _ in range(self.depth):
            agg = layer(h_e, h, senders_perm, w3, b3, s_matrix, **kw)
            h = torch.relu(agg[:n] + h @ self.root + self.bias)
        return self.fc2(h)

    def apply_fused_ad(self, x: torch.Tensor, edge_attr_blocked: torch.Tensor,
                       fused_aux: dict, s_matrix, *, rows_blk: int, blk: int,
                       gemm_dtype: str = "bfloat16") -> torch.Tensor:
        """Differentiable fused forward (training path).

        Same math as ``apply_fused``, each layer through
        ``ops.fused_conv.fused_edge_conv_ad`` (forward B1, backward B2): no
        per-slot [slots, w^2] matrices are kept for the backward.  The
        float32 tensors autograd tracks go into the layer, which rounds them
        to ``gemm_dtype`` inside, so every gradient arrives in float32.
        ``fused_aux`` and ``s_matrix`` come from ``prepare_fused_train``.
        A rank-r model runs ``fused_edge_conv_lowrank_ad`` (B3, B4).
        """
        from ..ops.fused_conv import (fused_edge_conv_ad,
                                      fused_edge_conv_lowrank_ad)

        layer = (fused_edge_conv_ad if self.kernel_rank is None
                 else fused_edge_conv_lowrank_ad)
        kw = self._fused_layer_kw(rows_blk, blk, gemm_dtype)
        n = x.shape[0]
        h = self.fc1(x)
        h_e = apply_edge_mlp_hidden(self.edge_mlp, edge_attr_blocked,
                                    torch.relu)
        last = self.edge_mlp[-1]
        w3 = last.weight.t()
        for _ in range(self.depth):
            agg = layer(h_e, h, w3, last.bias, s_matrix, fused_aux, **kw)
            h = torch.relu(agg[:n] + h @ self.root + self.bias)
        return self.fc2(h)

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

    @staticmethod
    def prepare_fused(senders, receivers, edge_attr, n_nodes,
                      edge_mask=None, rows_blk: int = 64,
                      quantum: int = 256, compact: bool = False):
        """Host-side (numpy) fused-path operands for a static graph.

        Returns (edge_attr_blocked, senders_perm, s_matrix, rows_blk, blk).
        """
        from ..ops.fused_conv import prepare_fused

        return prepare_fused(senders, receivers, edge_attr, n_nodes,
                             edge_mask, rows_blk, quantum, compact=compact)

    # -- weight layouts ----------------------------------------------------
    def _check_shapes(self, root_width: int, fc1_shape, head: int) -> None:
        if root_width != self.width:
            raise ValueError(
                f"checkpoint width {root_width} does not match model config "
                f"width {self.width}")
        if tuple(fc1_shape) != (self.width, self.in_width):
            raise ValueError(
                f"checkpoint fc1 {tuple(fc1_shape)} does not match "
                f"(width={self.width}, in_width={self.in_width})")
        # the edge-MLP head width encodes the kernel factorization: full rank
        # = width*width, rank r = 2*r*width.  A checkpoint of the other kind
        # would slice the flat head with the wrong column meaning.
        if head != self.head_width:
            raise ValueError(
                f"checkpoint edge-MLP head width {head} does not match "
                f"kernel_rank={self.kernel_rank} (expected {self.head_width}; "
                "full-rank checkpoints cannot load into low-rank configs or "
                "vice versa)")

    def import_pth(self, state_dict) -> "KernelNN":
        """Loads a reference checkpoint (torch state_dict / numpy dict).

        Key layout per logs/models/collection_duct_neuralop/partition_0.pth:
        fc1.*, conv1.root, conv1.bias, conv1.nn.layers.{0,2,4}.*, fc2.*.
        """
        sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else v
              for k, v in state_dict.items()}
        self._check_shapes(sd["conv1.root"].shape[0], sd["fc1.weight"].shape,
                           sd["conv1.nn.layers.4.weight"].shape[0])
        from_torch_linear(self.fc1, sd, "fc1")
        for i, layer in zip((0, 2, 4), self.edge_mlp):
            from_torch_linear(layer, sd, f"conv1.nn.layers.{i}")
        with torch.no_grad():
            self.root.copy_(torch.tensor(np.asarray(sd["conv1.root"], np.float32)))
            self.bias.copy_(torch.tensor(np.asarray(sd["conv1.bias"], np.float32)))
        from_torch_linear(self.fc2, sd, "fc2")
        return self

    def export_pth(self) -> dict:
        """Inverse of import_pth — numpy state_dict in the reference's layout."""
        out: dict = {}
        to_torch_linear(self.fc1, "fc1", out)
        for i, layer in zip((0, 2, 4), self.edge_mlp):
            to_torch_linear(layer, f"conv1.nn.layers.{i}", out)
        out["conv1.root"] = self.root.detach().cpu().numpy().copy()
        out["conv1.bias"] = self.bias.detach().cpu().numpy().copy()
        to_torch_linear(self.fc2, "fc2", out)
        return out

    def from_jax_params(self, params: dict) -> "KernelNN":
        """Loads the JAX package's KernelNN parameter tree (numpy leaves:
        fc1/{w,b}, conv/edge_mlp/[3]/{w,b}, conv/root, conv/bias, fc2)."""
        conv = params["conv"]
        self._check_shapes(np.shape(conv["root"])[0],
                           np.shape(params["fc1"]["w"])[::-1],
                           np.shape(conv["edge_mlp"][-1]["w"])[1])
        load_jax_tree(self, params)
        return self

    @staticmethod
    def jax_key(name: str) -> tuple[str, bool]:
        """(flat key in the JAX package's parameter tree, transposed?) of the
        parameter ``name``: the tree stores a linear layer's weight as
        w [in, out], the transpose of ``nn.Linear.weight``."""
        parts = name.split(".")
        leaf = {"weight": "w", "bias": "b"}
        if parts[0] in ("fc1", "fc2"):
            return f"{parts[0]}/{leaf[parts[1]]}", parts[1] == "weight"
        if parts[0] == "edge_mlp":
            return (f"conv/edge_mlp/{parts[1]}/{leaf[parts[2]]}",
                    parts[2] == "weight")
        return f"conv/{name}", False

    def to_jax_params(self) -> dict:
        """The JAX package's parameter tree, numpy leaves (``from_jax_params``
        inverse; ``core.checkpoint.save_params`` writes it)."""
        return jax_tree(self)
