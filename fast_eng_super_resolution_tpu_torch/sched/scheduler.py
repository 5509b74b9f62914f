"""PartitionScheduler — the orchestration layer.

Parity target: GNNPartitionScheduler (reference models/scheduler_gnn.py:
23-469).  The port trains and serves its experts on one device, or on each
rank of a data-parallel group (``mesh``, one process per device as the
reference's DDP workers, :313-469):

- ``train``: 80/20 split, merged batches, the fused training layout on the
  GPU for a model with a fused form (kernels B1/B2; ``_train_layout``),
  Adam with the reference's LR schedules, a NaN guard that rolls back and
  halves the LR, best-val checkpointing to
  ``logs/models/collection_{exp}/partition_{i}.npz`` in the JAX package's
  layout (plus ``.pth`` and the port's own optimizer-state file) and
  step-resume (scheduler_gnn.py:86-189);
- ``predict``: loads the partition checkpoint (``.npz`` first, then the
  reference's ``.pth``), predicts every subdomain of a sample in
  edge-budgeted chunks through the fused edge-conv layer, and computes the
  per-subdomain node weights (scheduler_gnn.py:204-311).

With ``num_partitions`` > 1 an encoder and a classifier route the subdomains
(scheduler_gnn.py:53-83): ``__init__`` fits and saves them (train) or loads
them (pred), each partition trains its own expert on its cluster, and
``predict`` sends each subdomain to its cluster's expert — by label groups
through the fused layer, or through ``parallel.dispatch.routed_apply``;
one partition is the case of a single label.

On a mesh of several ranks, ``train`` pads every batch to a multiple of the
ranks and trains each rank's shard with the explicit-collective step
(``FESR_STEP_IMPL`` unset or ``shard_map``; the plain ``apply``) or the
fused shard step (``shard_map_fused``: B1/B2 on every rank's merged group),
validating with the batched loss over the group; ``predict`` gives each
rank its block of every chunk and gathers the outputs.  Rank 0 alone
writes checkpoints, routing state, plots and metrics.
"""

from __future__ import annotations

import copy
import hashlib
import inspect
import os

import numpy as np
import torch

from ..core import checkpoint as ckpt
from ..core.graph import merge_batch, pad_and_bucket
from ..models.common import with_edges_sorted
from ..ops.loss import compute_node_weight
from ..parallel.dispatch import routed_apply
from ..parallel.mesh import (Mesh, local_block, make_mesh,
                             pad_batch_to_multiple, replicate, shard_batch)
from ..parallel.train import (CosineLR, ReduceLROnPlateau, StepLR, Trainer,
                              make_fused_batches, make_fused_shard_batches,
                              train_val_split)
from ..utils.device import resolve_device
from ..utils.env import is_primary
from ..utils.logging import MetricLogger
from .serving import ServingLanes, _as_raw_graph, edge_budget, fused_ok


class PartitionScheduler(ServingLanes):
    def __init__(self, exp_name: str, num_partitions: int, dataset, model=None,
                 train: bool = True, encoder=None, classifier=None,
                 log_dir: str = "logs", device=None,
                 gemm_dtype: str = "bfloat16", mesh: Mesh | None = None):
        self.name = exp_name
        self.num_partitions = num_partitions
        self.model = model
        self.dataset = dataset
        self.log_dir = log_dir
        self.device = resolve_device(device)
        self.gemm_dtype = gemm_dtype
        # the process group's ranks when one is up, else this device alone
        self.mesh = mesh if mesh is not None else make_mesh(self.device)
        self._fused_cache: dict = {}  # graph-content -> fused operands
        if num_partitions != 1:
            self.encoder = encoder
            self.classifier = classifier
        self.subset_indices = self._train_partitions(num_partitions, train)
        if not train:
            self.experts = self._load_models()

    def get_sub_dataset(self):
        """Per-cluster dataset views (GNNPartitionScheduler.get_sub_dataset,
        scheduler_gnn.py:39-40)."""
        from ..data.subsets import Subset

        return [Subset(self.dataset, idx) for idx in self.subset_indices]

    # -- paths -----------------------------------------------------------
    def collection_dir(self) -> str:
        return os.path.join(self.log_dir, "models", f"collection_{self.name}")

    def _ckpt_path(self, i: int) -> str:
        return os.path.join(self.collection_dir(), f"partition_{i}.npz")

    def _pth_path(self, i: int) -> str:
        return os.path.join(self.collection_dir(), f"partition_{i}.pth")

    # -- routing ---------------------------------------------------------
    def _train_partitions(self, num_partitions: int, train: bool) -> list:
        """Clusters the dataset into expert subsets (scheduler_gnn.py:53-83):
        on train, fits the encoder on every subdomain and the classifier on
        their latents and saves both to the collection dir; on pred, loads
        them.  One partition takes every subdomain (:55-56)."""
        n = len(self.dataset)
        if num_partitions == 1:
            return [np.arange(n)]
        data = [self.dataset.get(i) for i in range(n)]
        path = self.collection_dir()
        if train:
            # every rank fits the same state; rank 0 alone saves it
            save = is_primary()
            if save:
                os.makedirs(path, exist_ok=True)
            self.encoder.train(data, save_model=save, path=path)
            latent = self.encoder.get_latent_space(data)
            print("Latent space shape:", latent.shape)
            self.classifier.train(latent, save_model=save, path=path)
        else:
            self.encoder.load_model(path)
            self.classifier.load_model(path)
            latent = self.encoder.get_latent_space(data)
        labels = self.classifier.cluster(latent)
        subsets = []
        for i in range(num_partitions):
            idx = np.where(labels == i)[0]
            print(f"Partition {i}: {len(idx)} samples")
            subsets.append(idx)
        return subsets

    def _route(self, x: list[dict]) -> np.ndarray:
        """Each subdomain's expert index (all 0 with one partition)."""
        if self.num_partitions == 1:
            return np.zeros(len(x), dtype=int)
        latent = self.encoder.get_latent_space(x)
        labels = np.asarray(self.classifier.cluster(latent), dtype=int)
        self._check_labels(labels)
        return labels

    def _check_labels(self, labels: np.ndarray) -> None:
        """Routing labels must be valid expert indices before any indexing:
        a -1 would silently pick the last expert, and a stale classifier
        may know more clusters than there are experts."""
        if len(labels) and (labels.min() < 0
                            or labels.max() >= self.num_partitions):
            raise ValueError(
                f"routing labels outside [0, {self.num_partitions}): "
                f"min={labels.min()}, max={labels.max()} — classifier and "
                "expert count disagree (stale routing model?)")

    # -- checkpoints -----------------------------------------------------
    def _load_models(self) -> list:
        """One model per partition, weights loaded, on the device, in eval
        mode (``.npz`` first, then ``.pth``)."""
        experts = []
        for i in range(self.num_partitions):
            npz, pth = self._ckpt_path(i), self._pth_path(i)
            expert = copy.deepcopy(self.model)
            if os.path.exists(npz):
                meta = ckpt.load_meta(npz)
                if meta.get("model") not in (None, type(self.model).__name__):
                    # architecture mismatches beyond the class (width/rank)
                    # already fail on param shapes; the class itself would
                    # silently apply the wrong operator
                    print(f"WARNING: checkpoint {npz} was trained as "
                          f"{meta['model']} but is being served as "
                          f"{type(self.model).__name__}")
                expert.from_jax_params(ckpt.load_params(npz))
            elif os.path.exists(pth):
                expert.import_pth(ckpt.load_pth_state_dict(pth))
            else:
                raise FileNotFoundError(
                    f"no checkpoint for partition {i}: tried {npz} and {pth}")
            experts.append(expert.to(self.device).eval())
        return experts

    def _model_spec(self) -> dict:
        """Model identity stamped into checkpoints: the class and every
        scalar config field (the constructor's arguments but the seed), as
        the JAX package stamps every scalar field of its model's dataclass."""
        spec = {"model": type(self.model).__name__}
        for f in inspect.signature(type(self.model).__init__).parameters:
            if f in ("self", "seed") or not hasattr(self.model, f):
                continue
            v = getattr(self.model, f)
            if isinstance(v, (int, float, str, bool, type(None))):
                spec[f"cfg_{f}"] = str(v)
        return spec

    def _save_model(self, i: int, model, export_pth: bool = True) -> None:
        """``partition_{i}.npz`` in the JAX package's layout, and ``.pth`` in
        the reference's (on rank 0 alone)."""
        if not is_primary():
            return
        os.makedirs(self.collection_dir(), exist_ok=True)
        ckpt.save_params(self._ckpt_path(i), model.to_jax_params(),
                         meta=self._model_spec())
        if export_pth and hasattr(model, "export_pth"):
            ckpt.save_pth_state_dict(self._pth_path(i), model.export_pth())

    # -- batching --------------------------------------------------------
    def _single_device(self) -> bool:
        return self.mesh.size == 1

    def _make_batches(self, raw_graphs: list[dict], batch_size: int,
                      hetero: bool = False, merged: bool = True):
        """Chunks the subset into host graphs: (member indices, graph), each
        chunk flattened into one block-diagonal graph
        (core/graph.py:merge_batch) — the single-device layout — or, with
        ``merged=False``, kept as a [B, ...] batch whose leading axis
        shards over a mesh.

        hetero=True sorts the graphs by node count and pads each batch only
        to its own bucket (``hetero_batches: true`` in the train config), so
        a skewed partition stops paying the largest graph's padding on every
        batch.
        """
        if hetero:
            order = sorted(range(len(raw_graphs)),
                           key=lambda i: -raw_graphs[i]["x"].shape[0])
            batches = []
            for start in range(0, len(order), batch_size):
                sel = order[start:start + batch_size]
                (_, _, chunk), = pad_and_bucket([raw_graphs[i] for i in sel],
                                                uniform=True)
                batches.append((sel, merge_batch(chunk)[0] if merged
                                else chunk))
            return batches
        (_, idxs, big_batch), = pad_and_bucket(raw_graphs, uniform=True)
        batches = []
        for start in range(0, len(idxs), batch_size):
            sl = slice(start, start + batch_size)
            chunk = big_batch.map(lambda a: a[sl])
            batches.append((idxs[sl],
                            merge_batch(chunk)[0] if merged else chunk))
        return batches

    # -- training --------------------------------------------------------
    def _state_path(self, i: int) -> str:
        return os.path.join(self.collection_dir(), f"partition_{i}_state.npz")

    def train(self, train_config: dict, subset_idx=None,
              start_from_pretrained: bool = False, seed: int = 0,
              lr_schedule: str = "step", resume: bool = False,
              layout: str | None = None):
        """Trains each partition's expert and checkpoints its best
        validation epoch; returns the reloaded experts.

        ``subset_idx`` holds real partition ids (checkpoints, loggers and
        seeds are keyed by them).  ``layout``: 'fused' (kernels B1/B2 on
        CUDA, their plain versions on the CPU) or 'merged'; by default
        ``_train_layout``'s choice.  On a mesh of several ranks the layout
        is the sharded step's instead, which ``FESR_STEP_IMPL`` picks
        (``_shard_impl``).  With ``FESR_PLOT_VAL`` set, each new best
        validation epoch writes a PNG of the first validation batch's
        prediction under ``logs/figures/{exp}``.
        """
        part_ids = (range(len(self.subset_indices)) if subset_idx is None
                    else [int(i) for i in subset_idx])
        multi = not self._single_device()
        if multi:
            layout = _shard_impl(self.model)
        else:
            layout = layout or _train_layout(self.model, self.device)
        pretrained = self._load_models() if start_from_pretrained else None
        dev = self.device

        for i in part_ids:
            subset = self.subset_indices[i]
            logger = MetricLogger(f"{self.name}_partition_{i}", self.log_dir,
                                  config=train_config)
            model = copy.deepcopy(self.model).to(dev)
            raw = [_as_raw_graph(self.dataset.get(int(j))) for j in subset]
            tr_idx, va_idx = train_val_split(len(raw), 0.2, seed)
            if len(va_idx) == 0:
                va_idx = tr_idx[-1:]
            if len(tr_idx) == 0:
                # 0/1-sample partition: nothing to train on — persist the
                # init (or pretrained) params so serving finds a checkpoint
                print(f"Partition {i}: {len(raw)} samples — too few to "
                      "train; saving untrained params")
                Trainer(model, lr=train_config["lr"]).init(seed + i)
                if pretrained is not None and i < len(pretrained):
                    model.load_state_dict(pretrained[i].state_dict())
                self._save_model(i, model)
                logger.finish()
                continue
            batch_size = max(1, min(train_config["batch_size"], len(tr_idx)))
            hetero = bool(train_config.get("hetero_batches", False))
            train_batches = self._make_batches([raw[j] for j in tr_idx],
                                               batch_size, hetero=hetero,
                                               merged=not multi)
            val_batches = self._make_batches([raw[j] for j in va_idx],
                                             batch_size, hetero=hetero,
                                             merged=not multi)
            fused_kw = {}
            if multi:
                # the group's val loss is the batched loss of its shards
                fused_kw = dict(fused_dtype=self.gemm_dtype)
            elif layout == "fused":
                # one block geometry across ALL this partition's batches
                both = train_batches + val_batches
                fbs, rows_blk, blk = make_fused_batches(
                    [g for _, g in both], model, device=dev)
                both = [(bidx, fb) for (bidx, _), fb in zip(both, fbs)]
                n_tr = len(train_batches)
                train_batches, val_batches = both[:n_tr], both[n_tr:]
                fused_kw = dict(fused_rows_blk=rows_blk, fused_blk=blk,
                                fused_dtype=self.gemm_dtype)
            else:
                train_batches = [(bidx, g.to_torch(dev))
                                 for bidx, g in train_batches]
                val_batches = [(bidx, g.to_torch(dev))
                               for bidx, g in val_batches]

            trainer = Trainer(model, lr=train_config["lr"],
                              layout="batched" if multi else layout,
                              **fused_kw)
            step, mesh = None, None
            if multi:
                mesh = self.mesh
                train_batches, val_batches, step = self._shard_batches(
                    trainer, layout, train_batches, val_batches)
            opt = trainer.init(seed + i)
            if pretrained is not None and i < len(pretrained):
                model.load_state_dict(pretrained[i].state_dict())
            start_epoch = 0
            resumed_best = np.inf
            if resume and os.path.exists(self._state_path(i)):
                # step-resume: params + optimizer state + epoch + best-val
                # (without best_loss the first post-resume val epoch would
                # overwrite the best checkpoint with a worse model)
                model.from_jax_params(ckpt.load_params(self._ckpt_path(i)))
                tree, extra = ckpt.load_tree_like(self._state_path(i),
                                                  trainer.state_tree(opt))
                trainer.load_state_tree(opt, tree)
                start_epoch = int(extra.get("epoch", 0)) + 1
                resumed_best = float(extra.get("best_loss", np.inf))
                print(f"Resuming partition {i} from epoch {start_epoch} "
                      f"(best val {resumed_best:g})")
            replicate(model, self.mesh)  # rank 0's weights on every rank

            schedule_name = train_config.get("lr_schedule", lr_schedule)
            if schedule_name == "plateau":
                sched = ReduceLROnPlateau(train_config["lr"])  # :140
            elif schedule_name == "cosine":
                sched = CosineLR(train_config["lr"], train_config["epochs"],
                                 train_config.get("min_lr", 0.0))
            elif schedule_name == "step":
                sched = StepLR(train_config["lr"],
                               train_config.get("step_size", 30),
                               train_config.get("gamma", 0.1))  # :392-394
            else:
                raise ValueError(f"unknown lr_schedule {schedule_name!r} "
                                 "(expected step | plateau | cosine)")

            best_loss = resumed_best
            epochs = train_config["epochs"]
            log_interval = train_config.get("log_interval", 10)
            val_interval = train_config.get("val_interval", 10)
            rng = np.random.default_rng(seed)
            last_good = _snapshot(model)
            batches = [b for _, b in train_batches]
            for epoch in range(start_epoch, epochs):
                order = rng.permutation(len(batches))
                train_loss = float(trainer.epoch(opt, batches, order,
                                                 step).mean())
                if not np.isfinite(train_loss):
                    # NaN guard: roll back to the last finite params and
                    # halve the LR (the reference has none)
                    print(f"Epoch {epoch}: non-finite loss, rolling back + "
                          "halving lr")
                    model.load_state_dict(last_good)
                    trainer.set_lr(opt, trainer.get_lr(opt) * 0.5)
                    continue
                last_good = _snapshot(model)
                logger.log({"train_loss": train_loss,
                            "lr": trainer.get_lr(opt)}, step=epoch)
                if epoch % log_interval == 0:
                    print(f"Epoch {epoch}: Train loss: {train_loss}")
                if epoch % val_interval == 0:
                    val_loss = float(np.mean([trainer.evaluate(b, mesh)
                                              for _, b in val_batches]))
                    logger.log({"val_loss": val_loss}, step=epoch)
                    if val_loss < best_loss:
                        best_loss = val_loss
                        self._save_model(i, model)
                        if is_primary():
                            ckpt.save_tree(self._state_path(i),
                                           trainer.state_tree(opt),
                                           extra={"epoch": epoch,
                                                  "best_loss": best_loss})
                        print(f"Epoch {epoch}: Validation loss: {val_loss}")
                        self._maybe_plot_val(trainer, val_batches, i, epoch)
                if schedule_name == "plateau":
                    new_lr = sched.update(train_loss)
                else:
                    new_lr = sched(epoch + 1)
                trainer.set_lr(opt, new_lr)
            if not np.isfinite(best_loss):
                self._save_model(i, model)
            logger.finish()
        self.mesh.barrier()  # rank 0's checkpoints are written
        self.experts = self._load_models()
        return self.experts

    def _shard_batches(self, trainer: Trainer, impl: str, train_batches,
                       val_batches):
        """The mesh's form of a partition's batches and its train step:
        each [B, ...] host batch padded to a multiple of the ranks (masked
        copies of its first graph) and this rank's block uploaded, with the
        explicit-collective step; or, for ``impl`` 'fused', this rank's
        merged group of each training batch, at one block geometry across
        the batches, with the fused shard step.  Returns (train, val,
        step)."""
        mesh = self.mesh

        def padded(batches):
            return [(bidx, pad_batch_to_multiple(b, mesh.size)[0])
                    for bidx, b in batches]

        train_batches, val_batches = padded(train_batches), padded(val_batches)
        val = [(bidx, shard_batch(b, mesh)) for bidx, b in val_batches]
        if impl != "fused":
            return ([(bidx, shard_batch(b, mesh)) for bidx, b in train_batches],
                    val, trainer.make_shard_map_step(mesh))

        def build(quantum):
            return [(bidx, *make_fused_shard_batches(
                b, trainer.model, mesh.size, quantum=quantum,
                expand_s=False, mesh=mesh)) for bidx, b in train_batches]

        built = build(256)
        blk = max(bk for *_, bk in built)
        if any(bk != blk for *_, bk in built):
            built = build(blk)
        return ([(bidx, fb) for bidx, fb, _, _ in built], val,
                trainer.make_fused_shard_map_step(mesh, 64, blk))

    def _maybe_plot_val(self, trainer, val_batches, partition: int,
                        epoch: int) -> None:
        """Validation prediction panels (scheduler_gnn.py:440-442 plots to
        wandb; here PNGs under ``logs/figures/{exp}``), with
        ``FESR_PLOT_VAL`` set.  A failed plot (matplotlib missing, say) is
        printed and training goes on, as in the JAX package."""
        if not os.environ.get("FESR_PLOT_VAL") or not is_primary():
            return
        try:
            from ..utils.plotting import plot_3d_prediction

            _, batch = val_batches[0]
            pred = trainer.predict(batch).cpu().numpy()
            # the fused layout's batch carries the merged graph it plots
            graph = batch["graph"] if isinstance(batch, dict) else batch
            pos, x, y = (graph.pos.cpu().numpy(), graph.x.cpu().numpy(),
                         graph.y.cpu().numpy())
            if pred.ndim == 3:  # a batched shard: its first graph
                pos, x, y, pred = pos[0], x[0], y[0], pred[0]
            plot_3d_prediction(
                pos, x, y, pred, save_mode="save_png",
                path=os.path.join(self.log_dir, "figures", self.name,
                                  f"val_p{partition}_e{epoch}"))
        except Exception as exc:  # plotting must never break training
            print(f"val plot skipped: {exc}")

    # -- prediction ------------------------------------------------------
    @torch.inference_mode()
    def predict(self, x: list[dict]):
        """Predicts all subdomains of one full sample.

        Returns (pred_y_list, ref_y_list, model_idx, weights_list) — the
        reference 4-tuple (scheduler_gnn.py:228, 311), with per-subdomain
        arrays trimmed back to real node counts; model_idx holds each
        subdomain's expert.

        Every dispatch covers one expert's edge-budgeted chunk: the
        subdomains are grouped by label (all 0 with one partition) and each
        group is cut into chunks of ``chunk_b``; a short tail chunk keeps
        the chunk shape by repeating its last subdomain, whose copies are
        dropped on write-back.  A chunk runs through its expert's fused
        layer, or, with ``FESR_FUSED_PREDICT=0``, through ``routed_apply``
        (the plain ``apply``).  On a mesh of several ranks ``chunk_b`` is a
        multiple of the ranks, each rank runs its block of every chunk, and
        the blocks are gathered, so every rank returns the whole result.
        """
        raw = [_as_raw_graph(d) for d in x]
        n_real = [g["x"].shape[0] for g in raw]
        ref_y_list = [np.asarray(d["y"]) for d in x]
        # raw-geometry mesh hash: chunk-level fused-operand cache key
        mesh_hex = self._hash_geometry(raw)
        labels = self._route(x)
        dev = self.device
        use_fused = (os.environ.get("FESR_FUSED_PREDICT", "1") != "0"
                     and fused_ok(self.model))
        (_, idxs, batch), = pad_and_bucket(raw, uniform=True)
        # one upload per request: chunks are gathered on the device
        g = batch.to_torch(dev)
        # pad_and_bucket emits receiver-sorted edges: the plain lane's
        # experts get the hint, as the JAX package's do
        plain_experts = None if use_fused else [
            with_edges_sorted(e) for e in self.experts]

        def fused_expert(expert, idx, ckey):
            x = g.x[torch.as_tensor(idx, device=dev)]
            b, n = x.shape[0], x.shape[1]
            # scatter blocks are graph-static: cached by the RAW mesh hash +
            # chunk identity.  On a hit only x is gathered and merge_batch is
            # skipped: the layer needs only merged.x, which in the
            # block-diagonal layout is a pure reshape of the chunk's x
            key = ("chunk",) + ckey + (b, n)
            entry = self._fused_cache.get(key)
            if entry is None:
                merged, _ = merge_batch(batch.map(lambda a: a[idx]))
                entry = self._cache_put(key, *self._fused_operands(
                    merged, merged.x.shape[0]))
            ea_b, sp, sm, rows_blk, blk = entry[0]
            return expert.apply_fused(x.reshape(b * n, -1), ea_b, sp, sm,
                                      rows_blk=rows_blk, blk=blk,
                                      gemm_dtype=self.gemm_dtype
                                      ).reshape(b, n, -1)

        lab = labels[idxs]
        mesh = self.mesh
        # chunk to an edge budget (bounds the per-dispatch transients); on
        # a mesh, to a multiple of the ranks
        chunk_b = max(1, min(len(idxs),
                             edge_budget() // max(batch.senders.shape[1], 1)))
        chunk_b = max(mesh.size, chunk_b // mesh.size * mesh.size)
        outs, rows = [], []
        for k in range(self.num_partitions):
            sel = np.flatnonzero(lab == k)
            for start in range(0, len(sel), chunk_b):
                idx = sel[start:start + chunk_b]
                real = len(idx)
                idx = np.concatenate([idx,
                                      np.repeat(idx[-1:], chunk_b - real)])
                mine = local_block(idx, mesh)  # this rank's block
                if use_fused:
                    ck = (mesh_hex, "r", k, start,
                          hashlib.blake2b(mine.tobytes(),
                                          digest_size=8).hexdigest())
                    out = fused_expert(self.experts[k], mine, ck)
                else:
                    idx_t = torch.as_tensor(mine, device=dev)
                    out = routed_apply(plain_experts, lab[mine],
                                       g.map(lambda a: a[idx_t]))
                out = mesh.all_gather(out)
                outs.append(out[:real])
                rows.append(idx[:real])
        # every subdomain sits in exactly one chunk: one scatter back
        preds = torch.cat(outs)[torch.as_tensor(
            np.argsort(np.concatenate(rows)), device=dev)]

        # node weights (scheduler_gnn.py:222-226) — batched over subdomains
        weights = compute_node_weight(preds, g.y, g.senders, g.receivers,
                                      g.edge_attr, g.edge_mask,
                                      g.node_mask).cpu().numpy()
        preds = preds.cpu().numpy()

        pred_y_list: list = [None] * len(x)
        weights_list: list = [None] * len(x)
        for pos, orig_idx in enumerate(idxs):
            pred_y_list[orig_idx] = preds[pos][: n_real[orig_idx]]
            weights_list[orig_idx] = weights[pos][: n_real[orig_idx]]
        return pred_y_list, ref_y_list, labels, weights_list


def _train_layout(model, device: torch.device) -> str:
    """The default training layout: 'fused' only on CUDA, for a model with
    a differentiable fused form (``apply_fused_ad``) whose
    ``fused_train_ok`` (else ``fused_ok``, else True) holds, and unless
    ``FESR_FUSED_TRAIN`` is '0' (the JAX package's gate, whose fused
    training runs on the TPU); 'merged' otherwise."""
    fused = (device.type == "cuda"
             and hasattr(model, "apply_fused_ad")
             and getattr(model, "fused_train_ok",
                         getattr(model, "fused_ok", True))
             and os.environ.get("FESR_FUSED_TRAIN", "1") != "0")
    return "fused" if fused else "merged"


def _shard_impl(model) -> str:
    """The sharded training step on a mesh of several ranks, by
    ``FESR_STEP_IMPL``: 'fused' for ``shard_map_fused`` where the model has
    a differentiable fused form whose ``fused_train_ok`` (else
    ``fused_ok``) holds (the JAX package's gate), else 'batched', the
    explicit-collective step (unset or ``shard_map``; the JAX package's
    default GSPMD step computes the same)."""
    impl = os.environ.get("FESR_STEP_IMPL", "shard_map")
    if impl not in ("shard_map", "shard_map_fused"):
        raise ValueError(f"FESR_STEP_IMPL={impl!r} (expected shard_map | "
                         "shard_map_fused)")
    fused = (impl == "shard_map_fused" and hasattr(model, "apply_fused_ad")
             and getattr(model, "fused_train_ok",
                         getattr(model, "fused_ok", True)))
    return "fused" if fused else "batched"


def _snapshot(model) -> dict:
    """A copy of the model's parameters on their device (the NaN guard's
    roll-back point)."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
