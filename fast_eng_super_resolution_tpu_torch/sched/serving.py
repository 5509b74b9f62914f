"""Serving lanes for PartitionScheduler: the ordered lane-selection table, the
single-expert fused lane (``predict_full``) and the raw-geometry operand
cache it shares with the general ``predict`` path.

Reference analog: the inference half of GNNPartitionScheduler
(scheduler_gnn.py:204-347).  Of the JAX package's lanes only ``fast`` (and
the ``general`` fallback) exist here; the routed, coalesced and multi-device
lanes are ROADMAP.md queue A items 13 and 16.

The fused lane runs on the scheduler's device: on ``cuda`` every layer
launches the fused edge-conv kernel, on an explicit ``cpu`` its plain
version.  ``FESR_FUSED_PREDICT=0``, or a model without a fused kernel
(``fused_ok``), sends requests to ``predict`` with the non-fused ``apply``.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from ..core.graph import BucketSpec, merge_batch, pad_and_bucket
from ..ops.segment import masked_segment_sum


def _as_raw_graph(d: dict) -> dict:
    return dict(x=d["x"], y=d.get("y"), pos=d["pos"], senders=d["senders"],
                receivers=d["receivers"], edge_attr=d["edge_attr"],
                global_ids=d.get("global_node_ids"))


def fused_ok(model) -> bool:
    """Whether ``model`` serves through its fused kernel: it has
    ``apply_fused`` and its ``fused_ok`` (True if it has none) holds, as the
    JAX package's lanes and ``predict`` check."""
    return hasattr(model, "apply_fused") and getattr(model, "fused_ok", True)


def edge_budget() -> int:
    """Per-dispatch edge budget (``FESR_PREDICT_EDGE_BUDGET``, default
    300 000): larger requests chunk through ``predict``."""
    return int(os.environ.get("FESR_PREDICT_EDGE_BUDGET", 300_000))


class ServingLanes:
    """Mixin: serving-lane methods for PartitionScheduler.  Expects the host
    class to provide model/experts/device/gemm_dtype and the
    ``_fused_cache`` dict."""

    # -- serving caches ---------------------------------------------------
    @staticmethod
    def _hash_geometry(raw: list[dict], with_gids: bool = False) -> str:
        """Blake2b over the RAW (host numpy) graph geometry: cache keys never
        need device arrays brought back to the host."""
        names = ("senders", "receivers", "edge_attr") + (
            ("global_ids",) if with_gids else ())
        hsh = hashlib.blake2b(digest_size=16)
        for g in raw:
            for name in names:
                aa = np.asarray(g[name])
                hsh.update(aa.tobytes())
                hsh.update(str(aa.shape).encode())
        return hsh.hexdigest()

    def _cache_put(self, key, ops, nbytes: int):
        """Byte-budgeted FIFO insert into the fused-operand cache (one policy
        for every serving lane).  Default 2 GB of device memory,
        FESR_FUSED_CACHE_BYTES=0 disables caching.  Oversized entries are
        returned uncached (so a single huge mesh cannot evict-loop the cache
        to empty)."""
        budget = int(os.environ.get("FESR_FUSED_CACHE_BYTES", 2 << 30))
        entry = (ops, nbytes)
        if nbytes <= budget:
            self._fused_cache[key] = entry
            total = sum(nb for _, nb in self._fused_cache.values())
            while total > budget and len(self._fused_cache) > 1:
                old_key = next(iter(self._fused_cache))
                total -= self._fused_cache.pop(old_key)[1]
        return entry

    def _fused_operands(self, merged, n_nodes: int):
        """Device-resident fused operands of one merged graph: blocked edge
        attrs, senders_perm, the CompactS generators (the kernel never
        expands S), rows_blk, blk — and their byte count."""
        ea_b, sp, sm, rows_blk, blk = self.model.prepare_fused(
            np.asarray(merged.senders), np.asarray(merged.receivers),
            np.asarray(merged.edge_attr), n_nodes,
            np.asarray(merged.edge_mask), compact=True)
        dev = self.device
        ops = (torch.as_tensor(ea_b, device=dev),
               torch.as_tensor(sp, device=dev), sm.to(dev), rows_blk, blk)
        nbytes = (ea_b.nbytes + sp.nbytes + sm.slot_rows.nbytes
                  + sm.row_weight.nbytes)
        return ops, nbytes

    # -- prediction ------------------------------------------------------
    def _note_lane(self, lane: str, reason: str) -> None:
        """Records which serving lane a request took and why:
        ``scheduler.last_lane`` always holds the latest (lane, reason);
        FESR_LOG_LANES=1 prints per request."""
        self.last_lane = (lane, reason)
        if os.environ.get("FESR_LOG_LANES") == "1":
            print(f"serving lane: {lane} ({reason})")

    def _select_lane(self, x: list[dict], fused_env: str):
        """Ordered predicate table for serving-lane selection.

        Returns (lane, reason): 'general' = caller falls back to ``predict``
        + host overlap_average; 'fast' = single-expert fused one-dispatch
        lane.  The size and cache gates inside the lane may still demote to
        'general' — they call _note_lane with their own reason.
        """
        checks = [
            ("fused predict disabled (FESR_FUSED_PREDICT=0)",
             fused_env != "0"),
            ("request lacks global_node_ids (no device reconstruction)",
             all(d.get("global_node_ids") is not None for d in x)),
            ("request carries field_scale (host rescaling required)",
             all(d.get("field_scale") is None for d in x)),
        ]
        for reason, ok in checks:
            if not ok:
                return "general", reason
        if not fused_ok(self.model):
            return "general", "model has no fused kernel"
        return "fast", "single-expert fused one-dispatch lane"

    @torch.inference_mode()
    def predict_full(self, x: list[dict], num_nodes: int):
        """Single-dispatch serving path: fused predict AND overlap-average
        reconstruction on the device, one upload and one fetch.

        Returns (pred_full, ref_full) [num_nodes, C] numpy, or None when the
        lane's preconditions don't hold (caller falls back to ``predict`` +
        host ``overlap_average``; same math either way — the reconstruction
        is an exact segment mean, GraphDataset.py:1396).
        """
        fused_env = os.environ.get("FESR_FUSED_PREDICT", "1")
        lane, reason = self._select_lane(x, fused_env)
        self._note_lane(lane, reason)
        if lane == "general":
            return None
        raw = [_as_raw_graph(d) for d in x]
        spec = BucketSpec()
        b = len(raw)
        n_pad, e_pad = spec.bucket_for(
            max(g["x"].shape[0] for g in raw),
            max(g["senders"].shape[0] for g in raw))
        budget = edge_budget()
        if b * e_pad > budget:
            # big meshes chunk through the general path
            self._note_lane("general",
                            f"edge budget exceeded ({b * e_pad} > {budget})")
            return None

        entry = self._full_cache_entry(raw, num_nodes, b, n_pad, e_pad)
        ea_b, sp, sm, gid, w, rows_blk, blk = entry[0]
        xm, ym = self._pack_full_payload(raw, b, n_pad)
        dev = self.device
        out = self._serve_body(self.experts[0], torch.as_tensor(xm, device=dev),
                               torch.as_tensor(ym, device=dev), ea_b, sp, sm,
                               gid, w, rows_blk, blk, num_nodes,
                               self.gemm_dtype)
        if isinstance(out, tuple):  # pred/ref channel counts differ
            return out[0].cpu().numpy(), out[1].cpu().numpy()
        o = out.cpu().numpy()  # stacked [2, num_nodes, C] — ONE fetch
        return o[0], o[1]

    def _full_cache_entry(self, raw, num_nodes: int, b: int, n_pad: int,
                          e_pad: int):
        """Build-or-fetch the fused serving operands for one mesh geometry,
        keyed by the RAW (host numpy) geometry — per-subdomain shapes are
        hashed too, so node/edge counts are part of the identity."""
        key = ("full", self._hash_geometry(raw, with_gids=True), num_nodes,
               b * n_pad, e_pad)
        entry = self._fused_cache.get(key)
        if entry is None:
            (_, _, batch), = pad_and_bucket(raw, uniform=True)
            merged, _ = merge_batch(batch)
            (ea_b, sp, sm, rows_blk, blk), nbytes = self._fused_operands(
                merged, merged.x.shape[0])
            gids = np.asarray(merged.global_ids)
            nm = np.asarray(merged.node_mask)
            # padding / out-of-mesh rows scatter to a dump segment
            gid_dump = np.where(nm & (gids >= 0), gids,
                                np.int64(num_nodes)).astype(np.int64)
            dev = self.device
            ops = (ea_b, sp, sm, torch.as_tensor(gid_dump, device=dev),
                   torch.as_tensor(nm.astype(np.float32), device=dev),
                   rows_blk, blk)
            entry = self._cache_put(key, ops,
                                    nbytes + gid_dump.nbytes + nm.size * 4)
        return entry

    @staticmethod
    def _pack_full_payload(raw, b: int, n_pad: int):
        """Per-request payload packing, host side — identical layout to
        merge_batch(pad_and_bucket(raw)).x/.y (zeros in padded slots,
        original subdomain order), without re-padding the geometry."""
        c_in = raw[0]["x"].shape[1]
        y0 = raw[0]["y"]
        c_out = y0.shape[1] if y0 is not None else c_in
        xm = np.zeros((b * n_pad, c_in), np.float32)
        ym = np.zeros((b * n_pad, c_out), np.float32)
        for i, g in enumerate(raw):
            n_i = g["x"].shape[0]
            xm[i * n_pad: i * n_pad + n_i] = g["x"]
            if g["y"] is not None:
                ym[i * n_pad: i * n_pad + n_i] = g["y"]
        return xm, ym

    @staticmethod
    def _serve_body(model, xm, ym, ea_b, sp, sm, gid, w, rows_blk, blk,
                    num_nodes, gemm_dtype):
        """Fused forward + weighted segment-mean reconstruction over global
        node ids.  ``w`` is the 0/1 real-node mask, so the ``1e-30`` floor
        only keeps uncovered nodes (sum 0) at 0/1e-30 = 0."""
        pred = model.apply_fused(xm, ea_b, sp, sm, rows_blk=rows_blk, blk=blk,
                                 gemm_dtype=gemm_dtype)
        wc = w[:, None]
        accp = masked_segment_sum(pred * wc, gid, num_nodes + 1)
        accr = masked_segment_sum(ym * wc, gid, num_nodes + 1)
        ws = torch.clamp(masked_segment_sum(w, gid, num_nodes + 1), min=1e-30)
        pred_o = accp[:num_nodes] / ws[:num_nodes, None]
        ref_o = accr[:num_nodes] / ws[:num_nodes, None]
        if pred_o.shape == ref_o.shape:
            # one stacked output -> ONE device->host transfer per request
            return torch.stack([pred_o, ref_o])
        return (pred_o, ref_o)
