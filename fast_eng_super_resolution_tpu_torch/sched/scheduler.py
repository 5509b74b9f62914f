"""PartitionScheduler — the orchestration layer.

Parity target: GNNPartitionScheduler (reference models/scheduler_gnn.py:
23-469).  This port trains and serves one expert on one device:

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

Routed experts and multi-device lanes raise ``NotImplementedError`` naming
their ROADMAP.md item.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from ..core import checkpoint as ckpt
from ..core.graph import merge_batch, pad_and_bucket
from ..ops.loss import compute_node_weight
from ..parallel.train import (CosineLR, ReduceLROnPlateau, StepLR, Trainer,
                              make_fused_batches, train_val_split)
from ..utils.device import resolve_device
from ..utils.logging import MetricLogger
from .serving import ServingLanes, _as_raw_graph, edge_budget


class PartitionScheduler(ServingLanes):
    def __init__(self, exp_name: str, num_partitions: int, dataset, model=None,
                 train: bool = True, encoder=None, classifier=None,
                 log_dir: str = "logs", device=None,
                 gemm_dtype: str = "bfloat16"):
        if num_partitions != 1 or encoder is not None or classifier is not None:
            raise NotImplementedError(
                "routed experts (n_clusters != 1) are not ported yet "
                "(ROADMAP.md queue A item 13)")
        self.name = exp_name
        self.num_partitions = num_partitions
        self.model = model
        self.dataset = dataset
        self.log_dir = log_dir
        self.device = resolve_device(device)
        self.gemm_dtype = gemm_dtype
        self._fused_cache: dict = {}  # graph-content -> fused operands
        # one expert: every subdomain is its subset (scheduler_gnn.py:55-56)
        self.subset_indices = [np.arange(len(dataset))]
        if not train:
            self.experts = self._load_models()

    # -- paths -----------------------------------------------------------
    def collection_dir(self) -> str:
        return os.path.join(self.log_dir, "models", f"collection_{self.name}")

    def _ckpt_path(self, i: int) -> str:
        return os.path.join(self.collection_dir(), f"partition_{i}.npz")

    def _pth_path(self, i: int) -> str:
        return os.path.join(self.collection_dir(), f"partition_{i}.pth")

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
        """Model identity stamped into checkpoints: the class and its scalar
        config, as the JAX package stamps its model's fields."""
        spec = {"model": type(self.model).__name__}
        for f in ("width", "ker_width", "depth", "ker_in", "in_width",
                  "out_width", "kernel_rank"):
            if hasattr(self.model, f):
                spec[f"cfg_{f}"] = str(getattr(self.model, f))
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
        arrays trimmed back to real node counts.
        """
        raw = [_as_raw_graph(d) for d in x]
        n_real = [g["x"].shape[0] for g in raw]
        ref_y_list = [np.asarray(d["y"]) for d in x]
        # raw-geometry mesh hash: chunk-level fused-operand cache key
        mesh_hex = self._hash_geometry(raw)
        labels = np.zeros(len(x), dtype=int)
        expert = self.experts[0]
        dev = self.device
        use_fused = os.environ.get("FESR_FUSED_PREDICT", "1") != "0"

        def fused_expert(chunk, ckey):
            b, n = chunk.x.shape[0], chunk.x.shape[1]
            # scatter blocks are graph-static: cached by the RAW mesh hash +
            # chunk identity.  On a hit, merge_batch is skipped too: the
            # layer needs only merged.x, which in the block-diagonal layout
            # is a pure reshape of chunk.x
            key = ("chunk",) + ckey + (b, n)
            entry = self._fused_cache.get(key)
            if entry is None:
                merged, _ = merge_batch(chunk)
                entry = self._cache_put(key, *self._fused_operands(
                    merged, merged.x.shape[0]))
            ea_b, sp, sm, rows_blk, blk = entry[0]
            xm = torch.as_tensor(chunk.x.reshape(b * n, -1), device=dev)
            return expert.apply_fused(xm, ea_b, sp, sm, rows_blk=rows_blk,
                                      blk=blk, gemm_dtype=self.gemm_dtype
                                      ).reshape(b, n, -1)

        def single_expert(chunk):
            b, n = chunk.x.shape[0], chunk.x.shape[1]
            merged, _ = merge_batch(chunk.to_torch(dev))
            out = expert.apply(merged.x, merged.senders, merged.receivers,
                               merged.edge_attr, edge_mask=merged.edge_mask)
            return out.reshape(b, n, -1)

        (_, idxs, batch), = pad_and_bucket(raw, uniform=True)
        real_b = batch.x.shape[0]

        def _chunked(apply_chunk):
            # chunk to an edge budget (bounds the per-dispatch transients);
            # a short tail chunk re-uses the full chunk shape
            b_total = batch.x.shape[0]
            chunk_b = max(1, min(b_total,
                                 edge_budget() // max(batch.senders.shape[1], 1)))
            outs = []
            start = 0
            while start < b_total:
                end = min(start + chunk_b, b_total)
                if end - start < chunk_b and start > 0:
                    start = b_total - chunk_b
                    end = b_total
                chunk = batch.map(lambda a: a[start:end])
                outs.append((start, apply_chunk(chunk, start, end)))
                start = end
            preds = torch.zeros((b_total,) + tuple(outs[0][1].shape[1:]),
                                dtype=torch.float32, device=dev)
            for s, o in outs:
                preds[s:s + o.shape[0]] = o
            return preds

        if use_fused:
            preds = _chunked(lambda c, s, e: fused_expert(c, (mesh_hex, "se", s, e)))
        else:
            preds = _chunked(lambda c, s, e: single_expert(c))
        preds = preds[:real_b]

        # node weights (scheduler_gnn.py:222-226) — batched over subdomains
        g = batch.to_torch(dev)
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
