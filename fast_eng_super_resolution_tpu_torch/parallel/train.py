"""The training engine over padded graph batches, on one device.

Parity target: the JAX package's parallel/train.py, which replaces the
reference's single-device epoch loop (scheduler_gnn.py:116-189).  Loss
semantics match the reference's PyG batching: the subdomains of a batch form
one merged (block-diagonal) graph, and the loss is the MSE over its real
nodes times the summed clamped gradient weight (scheduler_gnn.py:481-501)
plus ``0.1 * max |err|`` (:151-154); see ops/loss.py.

The model is a KernelNN or a TEECNet.  Two layouts: ``'merged'`` runs the
plain whole-graph ``model.apply``; ``'fused'`` runs ``model.apply_fused_ad``,
whose layers are the hand-written forward (B1) and backward (B2) kernels on
the GPU (B3/B4 at rank r) and their plain versions on the CPU.  A model in
conv mode 'pallas' does not train in the merged layout: its first step
raises, as the per-edge message kernel has no backward (in the JAX package
neither); the fused layout ignores the mode.

Optimizer: Adam with optax's defaults (betas 0.9/0.999, eps 1e-8 added after
the square root, no weight decay), the learning rate set from the host every
epoch, mirroring both reference schedules: StepLR(step_size, gamma)
(:392-394) and ReduceLROnPlateau(factor=0.5, patience=5) (:140).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.checkpoint import flatten_params, unflatten_params
from ..core.graph import Graph
from ..ops.loss import gradient_weight_scalar, linf_loss
from ..utils.device import resolve_device

_MULTI_DEVICE = ("multi-device training is not ported yet (ROADMAP.md "
                 "queue A item 16)")


def combine_loss_parts(sq_sum, n_real, w_sum, linf_max, kind: str = "gradient",
                       linf_weight: float = 0.1) -> torch.Tensor:
    mse = sq_sum / torch.clamp(n_real, min=1.0)
    if kind == "mse":
        return mse
    if kind != "gradient":
        raise ValueError(f"unknown loss kind {kind!r} (expected mse | gradient)")
    return mse * w_sum + linf_weight * linf_max


def _loss_parts(pred: torch.Tensor, graph: Graph):
    """(sq_sum, n_real, w_sum, linf_max) of one merged graph's prediction."""
    m = graph.node_mask[:, None].to(pred.dtype)
    sq_sum = ((pred - graph.y) ** 2 * m).sum()
    n_real = m.sum() * pred.shape[-1]
    w = gradient_weight_scalar(pred, graph.y, graph.senders, graph.receivers,
                               graph.edge_attr, graph.edge_mask,
                               graph.node_mask, min_weight=0.0)
    return sq_sum, n_real, w, linf_loss(pred, graph.y, graph.node_mask)


def merged_loss(model, graph: Graph, kind: str = "gradient",
                linf_weight: float = 0.1) -> torch.Tensor:
    """Loss over ONE merged (block-diagonal) graph of torch tensors — the
    analogue of the reference's PyG batching, which also merges subdomains
    into one graph per step (scheduler_gnn.py:148-154)."""
    pred = model.apply(graph.x, graph.senders, graph.receivers,
                       graph.edge_attr, edge_mask=graph.edge_mask)
    return combine_loss_parts(*_loss_parts(pred, graph), kind=kind,
                              linf_weight=linf_weight)


def merged_fused_loss_parts(model, batch: dict, rows_blk: int, blk: int,
                            gemm_dtype: str = "bfloat16"):
    """(sq_sum, n_real, w_sum, linf_max) through the fused conv layers."""
    graph, fused = batch["graph"], batch["fused"]
    pred = model.apply_fused_ad(graph.x, fused["edge_attr"], fused["aux"],
                                fused["s"], rows_blk=rows_blk, blk=blk,
                                gemm_dtype=gemm_dtype)
    return _loss_parts(pred, graph)


def merged_fused_loss(model, batch: dict, rows_blk: int, blk: int,
                      kind: str = "gradient", linf_weight: float = 0.1,
                      gemm_dtype: str = "bfloat16") -> torch.Tensor:
    """``merged_loss`` through the fused conv layers (B1 forward, B2
    backward).  ``batch``: {'graph': merged Graph, 'fused': {'edge_attr',
    'aux', 's'}} from ``make_fused_batch``; the gradient-weight and L-inf
    terms use the graph's own edge arrays."""
    parts = merged_fused_loss_parts(model, batch, rows_blk, blk, gemm_dtype)
    return combine_loss_parts(*parts, kind=kind, linf_weight=linf_weight)


def make_fused_batch(merged: Graph, model, rows_blk: int = 64,
                     quantum: int = 256, device=None):
    """(batch dict for layout='fused', rows_blk, blk) from a merged host
    graph (numpy leaves), its tensors on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for).  S stays in its compact generators: the kernels
    read them directly, the plain versions expand them."""
    dev = resolve_device(device)
    ea, aux, s, rows_blk, blk = model.prepare_fused_train(
        np.asarray(merged.senders), np.asarray(merged.receivers),
        np.asarray(merged.edge_attr), merged.x.shape[0],
        np.asarray(merged.edge_mask), rows_blk=rows_blk, quantum=quantum,
        compact=True)
    fused = {"edge_attr": torch.as_tensor(ea, device=dev),
             "aux": {k: torch.as_tensor(v, device=dev) for k, v in aux.items()},
             "s": s.to(dev)}
    return {"graph": merged.to_torch(dev), "fused": fused}, rows_blk, blk


def make_fused_batches(graphs: list, model, rows_blk: int = 64, device=None):
    """(fused batches, rows_blk, blk) for merged host graphs that share ONE
    block geometry: each is first blocked with the default quantum, then all
    again at the largest blk if they differ (the JAX scheduler's common blk
    across a partition's train and val batches)."""
    def build(quantum):
        return [make_fused_batch(g, model, rows_blk, quantum, device)
                for g in graphs]

    out = build(256)
    blk = max(bk for *_, bk in out)
    if any(bk != blk for *_, bk in out):
        out = build(blk)
    return [fb for fb, _, _ in out], rows_blk, blk


def make_fused_shard_batches(*args, **kwargs):
    raise NotImplementedError(_MULTI_DEVICE)


def stack_batches(*args, **kwargs):
    raise NotImplementedError(_MULTI_DEVICE)


@dataclasses.dataclass
class Trainer:
    """Steps, evaluates and predicts ``model`` (an ``nn.Module`` trained in
    place) on one device; the optimizer is ``init``'s Adam."""

    model: torch.nn.Module
    lr: float
    loss_kind: str = "gradient"
    linf_weight: float = 0.1
    layout: str = "merged"   # 'merged' (one graph, plain conv) or 'fused'
    # (merged graph + fused conv layers: B1/B2 on the GPU)
    fused_rows_blk: int = 64   # block geometry for layout='fused'
    fused_blk: int = 0         # (from make_fused_batch)
    fused_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.layout == "batched":
            raise NotImplementedError(
                f"layout='batched' ([B, ...] over a device mesh): {_MULTI_DEVICE}")
        if self.layout not in ("merged", "fused"):
            raise ValueError(f"unknown layout {self.layout!r} "
                             "(expected merged | fused)")

    def loss(self, batch) -> torch.Tensor:
        if self.layout == "fused":
            return merged_fused_loss(self.model, batch, self.fused_rows_blk,
                                     self.fused_blk, self.loss_kind,
                                     self.linf_weight, self.fused_dtype)
        return merged_loss(self.model, batch, self.loss_kind, self.linf_weight)

    def init(self, seed: int | None = None) -> torch.optim.Adam:
        """A fresh Adam over the model's parameters.  With ``seed`` the
        parameters are first drawn anew from it (on the CPU, then moved
        back), so a seed gives the same weights on every device."""
        if seed is not None:
            dev = next(self.model.parameters()).device
            self.model.cpu().init_params(torch.Generator().manual_seed(seed))
            self.model.to(dev)
        return torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)

    def step(self, opt: torch.optim.Optimizer, batch) -> torch.Tensor:
        """One Adam step on ``batch``; returns the loss before the step (a
        0-d tensor on the device: reading it is the caller's host sync)."""
        opt.zero_grad(set_to_none=True)
        loss = self.loss(batch)
        loss.backward()
        opt.step()
        return loss.detach()

    def epoch(self, opt: torch.optim.Optimizer, batches, order) -> torch.Tensor:
        """A step per index of ``order`` into ``batches``; the per-step
        losses stay on the device, so an epoch costs one host sync."""
        return torch.stack([self.step(opt, batches[int(i)]) for i in order])

    @torch.no_grad()
    def evaluate(self, batch) -> float:
        return float(self.loss(batch))

    @torch.no_grad()
    def predict(self, batch) -> torch.Tensor:
        if self.layout == "fused":
            g, fused = batch["graph"], batch["fused"]
            return self.model.apply_fused_ad(
                g.x, fused["edge_attr"], fused["aux"], fused["s"],
                rows_blk=self.fused_rows_blk, blk=self.fused_blk,
                gemm_dtype=self.fused_dtype)
        return self.model.apply(batch.x, batch.senders, batch.receivers,
                                batch.edge_attr, edge_mask=batch.edge_mask)

    @staticmethod
    def set_lr(opt: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
        for group in opt.param_groups:
            group["lr"] = float(lr)
        return opt

    @staticmethod
    def get_lr(opt: torch.optim.Optimizer) -> float:
        return float(opt.param_groups[0]["lr"])

    def state_tree(self, opt: torch.optim.Optimizer) -> dict:
        """Adam's state as a tree of numpy arrays: ``step``,
        ``learning_rate`` and the two moments ``exp_avg``/``exp_avg_sq`` in
        the JAX package's parameter-tree layout (``model.jax_key``)."""
        flat = {}
        step = 0
        for name, p in self.model.named_parameters():
            key, transposed = self.model.jax_key(name)
            state = opt.state.get(p, {})
            for slot in ("exp_avg", "exp_avg_sq"):
                a = (state[slot].detach().cpu().numpy() if slot in state
                     else np.zeros(tuple(p.shape), np.float32))
                flat[f"{slot}/{key}"] = a.T if transposed else a
            if "step" in state:
                step = int(state["step"])
        flat["step"] = np.asarray(step, np.int64)
        flat["learning_rate"] = np.asarray(self.get_lr(opt), np.float32)
        return unflatten_params(flat)

    def load_state_tree(self, opt: torch.optim.Optimizer, tree: dict) -> None:
        """Restores ``state_tree``'s output into ``opt``."""
        flat = flatten_params(tree)
        step = int(flat["step"])
        for name, p in self.model.named_parameters():
            key, transposed = self.model.jax_key(name)
            state = {"step": torch.tensor(float(step), dtype=torch.float32)}
            for slot in ("exp_avg", "exp_avg_sq"):
                a = np.asarray(flat[f"{slot}/{key}"], np.float32)
                state[slot] = torch.as_tensor(
                    np.ascontiguousarray(a.T if transposed else a),
                    device=p.device)
            opt.state[p] = state
        self.set_lr(opt, float(flat["learning_rate"]))

    def make_shard_map_step(self, *args, **kwargs):
        raise NotImplementedError(_MULTI_DEVICE)

    def make_fused_shard_map_step(self, *args, **kwargs):
        raise NotImplementedError(_MULTI_DEVICE)


class StepLR:
    """torch.optim.lr_scheduler.StepLR equivalent (scheduler_gnn.py:392-394)."""

    def __init__(self, lr: float, step_size: int, gamma: float):
        self.lr0, self.step_size, self.gamma = lr, step_size, gamma

    def __call__(self, epoch: int) -> float:
        return self.lr0 * (self.gamma ** (epoch // self.step_size))


class CosineLR:
    """Half-cosine decay from ``lr`` to ``min_lr`` over ``total`` epochs."""

    def __init__(self, lr: float, total: int, min_lr: float = 0.0):
        self.lr0, self.total, self.min_lr = lr, max(total, 1), min_lr

    def __call__(self, epoch: int) -> float:
        t = min(max(epoch, 0), self.total) / self.total
        return self.min_lr + 0.5 * (self.lr0 - self.min_lr) * (
            1.0 + float(np.cos(np.pi * t)))


class ReduceLROnPlateau:
    """torch ReduceLROnPlateau(mode='min', factor=0.5, patience=5) equivalent
    (scheduler_gnn.py:140), with torch's default relative threshold 1e-4: an
    improvement counts only when metric < best * (1 - threshold)."""

    def __init__(self, lr: float, factor: float = 0.5, patience: int = 5,
                 min_lr: float = 0.0, threshold: float = 1e-4):
        self.lr, self.factor, self.patience, self.min_lr = lr, factor, patience, min_lr
        self.threshold = threshold
        self.best = np.inf
        self.bad_epochs = 0

    def update(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr


def train_val_split(num_items: int, val_frac: float = 0.2, seed: int = 0):
    """80/20 random split (random_split at scheduler_gnn.py:100-103, 125)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_items)
    n_train = int((1 - val_frac) * num_items)
    return perm[:n_train], perm[n_train:]
