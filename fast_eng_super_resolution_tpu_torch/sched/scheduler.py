"""PartitionScheduler — the orchestration layer, serving half.

Parity target: GNNPartitionScheduler (reference models/scheduler_gnn.py:
23-469).  This port serves one expert on one device: it loads the
partition checkpoint (``.npz`` in the JAX package's layout first, then the
reference's ``.pth``), predicts every subdomain of a sample in edge-budgeted
chunks through the fused edge-conv layer, and computes the per-subdomain
node weights (scheduler_gnn.py:204-311).  Training, routed experts and
multi-device lanes raise ``NotImplementedError`` naming their ROADMAP.md
item.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from ..core import checkpoint as ckpt
from ..core.graph import merge_batch, pad_and_bucket
from ..ops.loss import compute_node_weight
from ..utils.device import resolve_device
from .serving import ServingLanes, _as_raw_graph, edge_budget


class PartitionScheduler(ServingLanes):
    def __init__(self, exp_name: str, num_partitions: int, dataset, model=None,
                 train: bool = True, encoder=None, classifier=None,
                 log_dir: str = "logs", device=None,
                 gemm_dtype: str = "bfloat16"):
        if train:
            raise NotImplementedError(
                "training is not ported yet (ROADMAP.md queue A item 7)")
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
