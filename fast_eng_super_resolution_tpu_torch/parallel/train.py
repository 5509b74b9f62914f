"""The training engine over padded graph batches, on one device or one rank
of a data-parallel group.

Parity target: the JAX package's parallel/train.py, which replaces the
reference's epoch loop (scheduler_gnn.py:116-189) and its DDP worker
(:349-469).  Loss
semantics match the reference's PyG batching: the subdomains of a batch form
one merged (block-diagonal) graph, and the loss is the MSE over its real
nodes times the summed clamped gradient weight (scheduler_gnn.py:481-501)
plus ``0.1 * max |err|`` (:151-154); see ops/loss.py.

The model is a KernelNN or a TEECNet.  Three layouts: ``'merged'`` runs the
plain whole-graph ``model.apply`` on one merged graph; ``'batched'`` takes a
[B, ...] batch (a rank's shard) and merges it on the device, the same math;
``'fused'`` runs ``model.apply_fused_ad``, whose layers are the hand-written
forward (B1) and backward (B2) kernels on the GPU (B3/B4 at rank r) and
their plain versions on the CPU.  A model in conv mode 'pallas' does not
train in the merged layouts: its first step raises, as the per-edge message
kernel has no backward (in the JAX package neither); the fused layout
ignores the mode.

Across a data-parallel group (``parallel.mesh``), ``make_shard_map_step`` and
``make_fused_shard_map_step`` give the step on the concatenated batch.  The
loss is not linear in its parts, so neither averages per-rank losses nor
their gradients (DDP's rule): the parts are all-reduced first (sums, and the
max of L-inf with the JAX package's owner/count split of its gradient), each
rank back-propagates the local linearisation of the global loss at those
parts, and the gradients are summed over the ranks.

Optimizer: Adam with optax's defaults (betas 0.9/0.999, eps 1e-8 added after
the square root, no weight decay), the learning rate set from the host every
epoch, mirroring both reference schedules: StepLR(step_size, gamma)
(:392-394) and ReduceLROnPlateau(factor=0.5, patience=5) (:140).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..core.checkpoint import flatten_params, unflatten_params
from ..core.graph import Graph, merge_batch
from ..data.pipeline import _leaves, _tree_map
from ..ops.fused_conv import CompactS, expand_s as expand_s_dense
from ..ops.loss import gradient_weight_scalar, linf_loss
from ..utils.device import resolve_device
from .mesh import Mesh


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


def batched_loss_parts(model, batch: Graph):
    """(sq_sum, n_real, w_sum, linf_max) of a [B, ...] torch batch: the
    per-graph sums and the max over its graphs, computed on the batch's
    block-diagonal merge (no edge joins two graphs, so the merged sums and
    max are the per-graph ones combined)."""
    merged, _ = merge_batch(batch)
    pred = model.apply(merged.x, merged.senders, merged.receivers,
                       merged.edge_attr, edge_mask=merged.edge_mask)
    return _loss_parts(pred, merged)


def batched_loss(model, batch: Graph, kind: str = "gradient",
                 linf_weight: float = 0.1) -> torch.Tensor:
    """The reference's loss over a [B, ...] batch of padded graphs."""
    return combine_loss_parts(*batched_loss_parts(model, batch), kind=kind,
                              linf_weight=linf_weight)


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


def make_fused_shard_batches(batch: Graph, model, n_dev: int,
                             rows_blk: int = 64, quantum: int = 256,
                             with_graph: bool = True, expand_s: bool = True,
                             device=None, mesh: Mesh | None = None):
    """Host prep for the data-parallel fused step: splits a [B, ...] batch
    into ``n_dev`` groups of B / n_dev graphs, merges each block-diagonally,
    builds each group's scatter blocks at ONE block geometry (the largest
    blk of the groups) and stacks them on a leading group axis.

    Returns (dict, rows_blk, blk): {'graph': merged Graphs [n_dev, ...] or
    None (``with_graph=False``), 'fused': {'edge_attr', 'aux' (only
    'senders_perm' without the graph), and 's' [n_dev, nb*rows_blk, blk]
    dense, or (``expand_s=False``) 's_compact': {'slot_rows', 'row_weight'}
    [n_dev, ...]}}, torch tensors on ``device``.

    With ``mesh`` (of ``n_dev`` ranks) a rank builds its own group alone,
    row ``mesh.rank`` of that stack with a leading axis of 1, on the rank's
    device; the ranks agree on blk by an all-reduce.

    ``FESR_TIMING=1`` prints one ``[fesr-timing] make_fused_shard_batches:``
    line of the host stages' seconds (``device_get`` is the host copy of the
    batch); on a mesh only rank 0 prints.
    """
    b = batch.x.shape[0]
    if b % n_dev:
        raise ValueError(f"{b} graphs do not split into {n_dev} groups "
                         "(pad_batch_to_multiple)")
    if mesh is not None and mesh.size != n_dev:
        raise ValueError(f"n_dev={n_dev} on a mesh of {mesh.size} ranks")
    dev = mesh.device if mesh is not None else resolve_device(device)
    per = b // n_dev
    marks = [("start", time.perf_counter())]
    host = batch.map(lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor)
                     else np.asarray(a))
    marks.append(("device_get", time.perf_counter()))
    ranks = range(n_dev) if mesh is None else (mesh.rank,)
    groups = [merge_batch(host.map(lambda a: a[d * per:(d + 1) * per]))[0]
              for d in ranks]
    marks.append(("merge", time.perf_counter()))

    def build(merged, q):
        ea, aux, s, rb, bk = model.prepare_fused_train(
            merged.senders, merged.receivers, merged.edge_attr,
            merged.x.shape[0], merged.edge_mask, rows_blk=rows_blk,
            quantum=q, compact=True)
        return merged, ea, aux, s, rb, bk

    built = [build(g, quantum) for g in groups]
    blk = max(bk for *_, bk in built)
    if mesh is not None:
        blk = int(mesh.all_reduce(torch.tensor([blk], device=dev), "max")[0])
    built = [x if x[-1] == blk else build(x[0], blk) for x in built]
    marks.append(("scatter_build", time.perf_counter()))

    def stack(leaves):
        return torch.as_tensor(np.stack([np.asarray(a) for a in leaves]),
                               device=dev)

    graphs = (Graph(**{f.name: stack([getattr(g, f.name) for g, *_ in built])
                       for f in dataclasses.fields(Graph)})
              if with_graph else None)
    aux_keys = built[0][2].keys() if with_graph else ("senders_perm",)
    fused = {"edge_attr": stack([ea for _, ea, *_ in built]),
             "aux": {k: stack([aux[k] for _, _, aux, *_ in built])
                     for k in aux_keys}}
    sr = stack([s.slot_rows for *_, s, _, _ in built])
    rw = stack([s.row_weight for *_, s, _, _ in built])
    if expand_s:
        fused["s"] = expand_s_dense(sr.reshape(-1), rw.reshape(-1),
                                    rows_blk=rows_blk, blk=blk
                                    ).reshape(len(built), -1, blk)
    else:
        fused["s_compact"] = {"slot_rows": sr, "row_weight": rw}
    marks.append(("stack_upload", time.perf_counter()))
    if (os.environ.get("FESR_TIMING") == "1"
            and (mesh is None or mesh.rank == 0)):
        stages = ", ".join(f"{name}={t1 - t0:.2f}s" for (name, t1), (_, t0)
                           in zip(marks[1:], marks[:-1]))
        print(f"[fesr-timing] make_fused_shard_batches: {stages}", flush=True)
    return {"graph": graphs, "fused": fused}, rows_blk, blk


def stack_batches(batches: list, device=None):
    """Stacks same-shape batch trees (``Graph``s or dicts of arrays) along a
    new leading axis, as torch tensors on ``device``, for ``Trainer.epoch``;
    None when there are none or their tree structure or shapes differ (the
    caller then steps batch by batch)."""
    if not batches:
        return None
    leaves = [_leaves(b) for b in batches]
    shapes = [tuple(a.shape) for a in leaves[0]]
    if any(_structure(b) != _structure(batches[0])
           or [tuple(a.shape) for a in ls] != shapes
           for b, ls in zip(batches[1:], leaves[1:])):
        return None
    dev = resolve_device(device)
    stacked = iter([torch.stack([torch.as_tensor(ls[i], device=dev)
                                 for ls in leaves])
                    for i in range(len(shapes))])
    return _tree_map(lambda _: next(stacked), batches[0])


def _structure(tree):
    """The tree's structure: the container types and keys, leaves as
    None."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(v)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    if isinstance(tree, Graph):
        return "Graph"
    return None


def _index(tree, i: int):
    """Entry ``i`` of every leaf's leading axis."""
    return _tree_map(lambda a: a[i], tree)


def _global_parts(parts, mesh: Mesh):
    """The loss parts over the whole group, detached: (sq_sum, n_real,
    w_sum, linf_max), and this rank's share of L-inf's gradient (1/count on
    the ranks that hold the max, 0 elsewhere: the JAX package's owner/count
    split of a tied max)."""
    sq, n, w, linf = parts
    sums = mesh.all_reduce(torch.stack([sq, n, w]).detach().float(), "sum")
    lmax = mesh.all_reduce(linf.detach().float().reshape(1), "max")[0]
    owner = (linf.detach().float() == lmax).float().reshape(1)
    count = mesh.all_reduce(owner, "sum")[0]
    return (sums[0], sums[1], sums[2], lmax), owner[0] / torch.clamp(count,
                                                                     min=1.0)


def _all_reduce_grads(params, mesh: Mesh) -> None:
    """Sums every parameter's gradient over the ranks, in one collective."""
    grads = [p.grad for p in params if p.grad is not None]
    if mesh.backend is None or not grads:
        return
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]), "sum")
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


@dataclasses.dataclass
class Trainer:
    """Steps, evaluates and predicts ``model`` (an ``nn.Module`` trained in
    place) on one device, or on one rank of a mesh through the shard steps;
    the optimizer is ``init``'s Adam."""

    model: torch.nn.Module
    lr: float
    loss_kind: str = "gradient"
    linf_weight: float = 0.1
    layout: str = "merged"   # 'merged' (one graph, plain conv), 'batched'
    # ([B, ...] graphs merged on the device, plain conv) or 'fused' (merged
    # graph + fused conv layers: B1/B2 on the GPU)
    fused_rows_blk: int = 64   # block geometry for layout='fused'
    fused_blk: int = 0         # (from make_fused_batch)
    fused_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.layout not in ("merged", "batched", "fused"):
            raise ValueError(f"unknown layout {self.layout!r} "
                             "(expected merged | batched | fused)")

    def loss_parts(self, batch):
        """(sq_sum, n_real, w_sum, linf_max) of ``batch`` in the layout."""
        if self.layout == "fused":
            return merged_fused_loss_parts(self.model, batch,
                                           self.fused_rows_blk,
                                           self.fused_blk, self.fused_dtype)
        if self.layout == "batched":
            return batched_loss_parts(self.model, batch)
        pred = self.model.apply(batch.x, batch.senders, batch.receivers,
                                batch.edge_attr, edge_mask=batch.edge_mask)
        return _loss_parts(pred, batch)

    def loss(self, batch) -> torch.Tensor:
        return combine_loss_parts(*self.loss_parts(batch),
                                  kind=self.loss_kind,
                                  linf_weight=self.linf_weight)

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

    def epoch(self, opt: torch.optim.Optimizer, batches, order,
              step=None) -> torch.Tensor:
        """A step per index of ``order`` into ``batches`` (a list, or one
        tree stacked by ``stack_batches``), through ``step`` (by default
        ``self.step``; or a shard step); the per-step losses stay on the
        device, so an epoch costs one host sync."""
        step = step or self.step
        pick = ((lambda i: batches[i]) if isinstance(batches, list)
                else (lambda i: _index(batches, i)))
        return torch.stack([step(opt, pick(int(i))) for i in order])

    @torch.no_grad()
    def evaluate(self, batch, mesh: Mesh | None = None) -> float:
        """The loss of ``batch``; with a ``mesh`` of several ranks, of the
        group's batch, of which ``batch`` is this rank's shard."""
        if mesh is None or mesh.backend is None:
            return float(self.loss(batch))
        (sq, n, w, linf), _ = _global_parts(self.loss_parts(batch), mesh)
        return float(combine_loss_parts(sq, n, w, linf, self.loss_kind,
                                        self.linf_weight))

    @torch.no_grad()
    def predict(self, batch) -> torch.Tensor:
        """The prediction: [N, C] of a merged graph, [B, N, C] of a
        batched one."""
        if self.layout == "fused":
            g, fused = batch["graph"], batch["fused"]
            return self.model.apply_fused_ad(
                g.x, fused["edge_attr"], fused["aux"], fused["s"],
                rows_blk=self.fused_rows_blk, blk=self.fused_blk,
                gemm_dtype=self.fused_dtype)
        g = merge_batch(batch)[0] if self.layout == "batched" else batch
        out = self.model.apply(g.x, g.senders, g.receivers, g.edge_attr,
                               edge_mask=g.edge_mask)
        return (out.reshape(batch.x.shape[0], batch.x.shape[1], -1)
                if self.layout == "batched" else out)

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

    def _shard_step(self, opt, parts, mesh: Mesh) -> torch.Tensor:
        """One Adam step on the group's batch from this rank's loss
        ``parts``: all-reduce the parts, back-propagate the local
        linearisation of the global loss at them, sum the gradients over
        the ranks.  Returns the global loss (the same on every rank)."""
        glob, share = _global_parts(parts, mesh)
        at = [p.clone().requires_grad_(True) for p in glob]
        loss = combine_loss_parts(*at, kind=self.loss_kind,
                                  linf_weight=self.linf_weight)
        coeff = torch.autograd.grad(loss, at, allow_unused=True)
        sq, n, w, linf = parts
        local = (sq, n, w, linf * share)
        surrogate = sum(c * p for c, p in zip(coeff, local) if c is not None)
        surrogate.backward()
        _all_reduce_grads(self.model.parameters(), mesh)
        opt.step()
        return loss.detach()

    def make_shard_map_step(self, mesh: Mesh):
        """The explicit-collective train step: ``step(opt, shard)`` on this
        rank's [B / size, ...] shard of the group's batch (``shard_batch``)
        takes one Adam step on the whole batch and returns its loss; every
        rank then holds the same parameters.  Equals ``Trainer.step`` on the
        concatenated batch (the JAX package's ``make_shard_map_step``)."""
        def step(opt: torch.optim.Optimizer, batch) -> torch.Tensor:
            opt.zero_grad(set_to_none=True)
            return self._shard_step(
                opt, batched_loss_parts(self.model, batch), mesh)

        return step

    def make_fused_shard_map_step(self, mesh: Mesh, rows_blk: int, blk: int):
        """The data-parallel fused train step: ``step(opt, shard)`` where
        ``shard`` is this rank's ONE merged group from
        ``make_fused_shard_batches`` (leading axis 1): the fused layers (B1
        forward, B2 backward on the card; B3/B4 at a kernel rank) on the
        rank's group, then the collectives of ``make_shard_map_step``.
        Equals the single-device fused step on the concatenated batch."""
        def step(opt: torch.optim.Optimizer, batch: dict) -> torch.Tensor:
            lead = {a.shape[0] for a in _leaves(batch)}
            if lead != {1}:
                raise ValueError(
                    f"fused shard step: the shard has leading dims "
                    f"{sorted(lead)}, expected 1: make_fused_shard_batches' "
                    f"n_dev must equal the mesh's '{mesh.axis}' size, one "
                    "merged group per rank")
            local = _index(batch, 0)
            fused = dict(local["fused"])
            sc = fused.pop("s_compact", None)
            if sc is not None:
                fused["s"] = CompactS(sc["slot_rows"], sc["row_weight"])
            opt.zero_grad(set_to_none=True)
            parts = merged_fused_loss_parts(
                self.model, {"graph": local["graph"], "fused": fused},
                rows_blk, blk, self.fused_dtype)
            return self._shard_step(opt, parts, mesh)

        return step


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
