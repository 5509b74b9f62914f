"""PartitionScheduler — the orchestration layer.

Parity target: GNNPartitionScheduler (reference models/scheduler_gnn.py:
23-469).  This port trains and serves its experts on one device:

- ``train``: 80/20 split, merged batches, the fused training layout on the
  GPU (kernels B1/B2), Adam with the reference's LR schedules, a NaN guard
  that rolls back and halves the LR, best-val checkpointing to
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
Multi-device lanes raise ``NotImplementedError`` naming their ROADMAP.md
item.
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
from ..parallel.train import (CosineLR, ReduceLROnPlateau, StepLR, Trainer,
                              make_fused_batches, train_val_split)
from ..utils.device import resolve_device
from ..utils.logging import MetricLogger
from .serving import ServingLanes, _as_raw_graph, edge_budget, fused_ok


class PartitionScheduler(ServingLanes):
    def __init__(self, exp_name: str, num_partitions: int, dataset, model=None,
                 train: bool = True, encoder=None, classifier=None,
                 log_dir: str = "logs", device=None,
                 gemm_dtype: str = "bfloat16"):
        self.name = exp_name
        self.num_partitions = num_partitions
        self.model = model
        self.dataset = dataset
        self.log_dir = log_dir
        self.device = resolve_device(device)
        self.gemm_dtype = gemm_dtype
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
            os.makedirs(path, exist_ok=True)
            self.encoder.train(data, save_model=True, path=path)
            latent = self.encoder.get_latent_space(data)
            print("Latent space shape:", latent.shape)
            self.classifier.train(latent, save_model=True, path=path)
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
        the reference's."""
        os.makedirs(self.collection_dir(), exist_ok=True)
        ckpt.save_params(self._ckpt_path(i), model.to_jax_params(),
                         meta=self._model_spec())
        if export_pth:
            ckpt.save_pth_state_dict(self._pth_path(i), model.export_pth())

    # -- batching --------------------------------------------------------
    def _make_batches(self, raw_graphs: list[dict], batch_size: int,
                      hetero: bool = False):
        """Chunks the subset into merged host graphs: (member indices,
        graph), each chunk flattened into one block-diagonal graph
        (core/graph.py:merge_batch) — the single-device layout; the
        [B, ...] layout for a device mesh is ROADMAP.md queue A item 16.

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
                batches.append((sel, merge_batch(chunk)[0]))
            return batches
        (_, idxs, big_batch), = pad_and_bucket(raw_graphs, uniform=True)
        batches = []
        for start in range(0, len(idxs), batch_size):
            sl = slice(start, start + batch_size)
            batches.append((idxs[sl],
                            merge_batch(big_batch.map(lambda a: a[sl]))[0]))
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
        'fused' on CUDA and 'merged' on the CPU, as the JAX package trains
        fused on the TPU only.
        """
        if os.environ.get("FESR_PLOT_VAL"):
            raise NotImplementedError(
                "FESR_PLOT_VAL (validation prediction panels) is not ported "
                "yet (ROADMAP.md queue A item 17)")
        part_ids = (range(len(self.subset_indices)) if subset_idx is None
                    else [int(i) for i in subset_idx])
        layout = layout or ("fused" if self.device.type == "cuda" else "merged")
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
                                               batch_size, hetero=hetero)
            val_batches = self._make_batches([raw[j] for j in va_idx],
                                             batch_size, hetero=hetero)
            fused_kw = {}
            if layout == "fused":
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

            trainer = Trainer(model, lr=train_config["lr"], layout=layout,
                              **fused_kw)
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
                train_loss = float(trainer.epoch(opt, batches, order).mean())
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
                    val_loss = float(np.mean([trainer.evaluate(b)
                                              for _, b in val_batches]))
                    logger.log({"val_loss": val_loss}, step=epoch)
                    if val_loss < best_loss:
                        best_loss = val_loss
                        self._save_model(i, model)
                        ckpt.save_tree(self._state_path(i),
                                       trainer.state_tree(opt),
                                       extra={"epoch": epoch,
                                              "best_loss": best_loss})
                        print(f"Epoch {epoch}: Validation loss: {val_loss}")
                if schedule_name == "plateau":
                    new_lr = sched.update(train_loss)
                else:
                    new_lr = sched(epoch + 1)
                trainer.set_lr(opt, new_lr)
            if not np.isfinite(best_loss):
                self._save_model(i, model)
            logger.finish()
        self.experts = self._load_models()
        return self.experts

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
        (the plain ``apply``).
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
        # chunk to an edge budget (bounds the per-dispatch transients)
        chunk_b = max(1, min(len(idxs),
                             edge_budget() // max(batch.senders.shape[1], 1)))
        outs, rows = [], []
        for k in range(self.num_partitions):
            sel = np.flatnonzero(lab == k)
            for start in range(0, len(sel), chunk_b):
                idx = sel[start:start + chunk_b]
                real = len(idx)
                idx = np.concatenate([idx,
                                      np.repeat(idx[-1:], chunk_b - real)])
                if use_fused:
                    ck = (mesh_hex, "r", k, start,
                          hashlib.blake2b(idx.tobytes(),
                                          digest_size=8).hexdigest())
                    out = fused_expert(self.experts[k], idx, ck)
                else:
                    idx_t = torch.as_tensor(idx, device=dev)
                    out = routed_apply(plain_experts, lab[idx],
                                       g.map(lambda a: a[idx_t]))
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


def _snapshot(model) -> dict:
    """A copy of the model's parameters on their device (the NaN guard's
    roll-back point)."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
