"""Serving lanes for PartitionScheduler: the ordered lane-selection table, the
single-expert fused lane (``predict_full``), the coalesced lane for R
requests on one geometry (``predict_full_batch``), the routed lane for
several experts, their data-parallel forms ``fast_mc`` and ``routed_mc`` on
a mesh of several ranks, and the raw-geometry operand cache they share with
the general ``predict`` path.

Reference analog: the inference half of GNNPartitionScheduler
(scheduler_gnn.py:204-347), whose multi-GPU worker splits the subdomains
over the ranks and merges on the host (:253-291, 313-347).  On a mesh each
rank serves its block of the request's subdomains, and one all-reduce of
the partial overlap sums completes the reconstruction on every rank.

The lanes run on the scheduler's device: on ``cuda`` every layer launches
the fused edge-conv kernel, on an explicit ``cpu`` its plain version.
``FESR_FUSED_PREDICT=0``, or a model without a fused kernel (``fused_ok``),
sends requests to ``predict`` with the non-fused ``apply``.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from ..core.graph import BucketSpec, merge_batch, pad_and_bucket
from ..ops.segment import masked_segment_sum
from ..parallel.mesh import local_block, pad_batch_to_multiple


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
    class to provide model/experts/num_partitions/device/gemm_dtype/mesh,
    ``_single_device``, ``_route`` (each subdomain's expert) and the
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
        + host overlap_average; 'routed' = multi-expert lane; 'fast' =
        single-expert fused one-dispatch lane; on a mesh of several ranks
        'routed_mc' and 'fast_mc', their data-parallel forms.  The size
        gates inside the lanes may still demote to 'general' — they call
        _note_lane with their own reason.  The routed lanes run the fused
        layer too, so a model without one serves routed requests through
        ``predict`` (the JAX package's routed lanes run the plain ``apply``
        and take them).
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
        if not self._single_device():
            n_dev = self.mesh.size
            if not fused_ok(self.model):
                return "general", ("multi-device mesh: non-fused requests "
                                   "serve through predict")
            if self.num_partitions > 1:
                return "routed_mc", (f"{self.num_partitions} experts x "
                                     f"{n_dev} devices, routed lane")
            return "fast_mc", f"{n_dev}-device fused lane"
        if not fused_ok(self.model):
            return "general", "model has no fused kernel"
        if self.num_partitions > 1:
            return "routed", f"{self.num_partitions} experts, routed lane"
        return "fast", "single-expert fused one-dispatch lane"

    @staticmethod
    def _request_shape(raw) -> tuple[int, int, int]:
        """(subdomains, padded nodes, padded edges) of a request: its one
        uniform bucket."""
        n_pad, e_pad = BucketSpec().bucket_for(
            max(g["x"].shape[0] for g in raw),
            max(g["senders"].shape[0] for g in raw))
        return len(raw), n_pad, e_pad

    @torch.inference_mode()
    def predict_full(self, x: list[dict], num_nodes: int):
        """Single-dispatch serving path: fused predict AND overlap-average
        reconstruction on the device, one upload and one fetch.

        Serves the 'fast' lane (one expert) and the 'routed' lane (several)
        alike: each label group of the request, merged into one
        block-diagonal graph, runs through its expert's ``apply_fused``
        (kernel B1 on the card), with the group operands cached by the raw
        geometry and the label assignment; a group that covers the whole
        request needs no gather or scatter.  The JAX package's routed lane
        runs the vmapped plain ``apply`` over the stacked experts instead,
        because a label-grouped Pallas program would recompile per label
        assignment; a CUDA kernel compiles once.  The math is the same conv
        and the same exact segment mean.

        On a mesh of several ranks ('fast_mc', 'routed_mc') the request's
        subdomains are padded to a multiple of the ranks (masked graphs
        that add nothing) and each rank serves its block the same way; the
        edge budget is per rank, and one all-reduce of the partial sums
        gives every rank the whole reconstruction.

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
        b, n_pad, e_pad = self._request_shape(raw)
        n_dev = self.mesh.size
        budget = edge_budget() * n_dev  # per device
        if b * e_pad > budget:
            # big meshes chunk through the general path
            self._note_lane("general", {
                "routed": "routed lane demoted (edge budget)",
                "fast": f"edge budget exceeded ({b * e_pad} > {budget})",
                "fast_mc": "multi-chip lane demoted (edge budget: "
                           f"{b * e_pad} > {budget})",
                "routed_mc": "routed multi-chip lane demoted (edge budget: "
                             f"{b * e_pad} > {budget})"}[lane])
            return None
        # routing is payload-dependent: computed per request on the host
        groups, gid, w = self._request_operands(raw, self._route(x),
                                                num_nodes, n_pad, e_pad)
        b_pad = -(-b // n_dev) * n_dev
        xm, ym = self._pack_full_payload(raw, b_pad, n_pad)
        xm, ym = (local_block(a.reshape(b_pad, n_pad, -1), self.mesh)
                  for a in (xm, ym))
        dev = self.device
        xb = torch.as_tensor(xm, device=dev)
        return _fetch(self._serve_body(
            groups, xb, torch.as_tensor(ym, device=dev).reshape(
                -1, ym.shape[-1]), gid, w, num_nodes))

    def _request_operands(self, raw, labels: np.ndarray, num_nodes: int,
                          n_pad: int, e_pad: int):
        """Build-or-fetch a request's device operands, keyed by the RAW
        (host numpy) geometry — per-subdomain shapes are hashed too, so
        node/edge counts are part of the identity — and the label
        assignment: per label present, (label, its subdomains' batch
        positions or None for the whole request, the fused operands of
        their merged graph), then the reconstruction operands.  On a mesh,
        those of this rank's block of the request padded to a multiple of
        the ranks (padding graphs take label 0 and weight 0)."""
        mesh = self.mesh
        key = ("full", self._hash_geometry(raw, with_gids=True), num_nodes,
               len(raw) * n_pad, e_pad, labels.tobytes(), mesh.rank,
               mesh.size)
        entry = self._fused_cache.get(key)
        if entry is None:
            (_, _, batch), = pad_and_bucket(raw, uniform=True)
            if mesh.size > 1:
                batch, _ = pad_batch_to_multiple(batch, mesh.size)
                labels = np.concatenate([labels, np.zeros(
                    batch.x.shape[0] - len(labels), labels.dtype)])
                batch, labels = local_block((batch, labels), mesh)
            b = batch.x.shape[0]
            whole, _ = merge_batch(batch)
            groups, nbytes = [], 0
            for k in np.unique(labels):
                idx = np.flatnonzero(labels == k)
                if len(idx) == b:
                    merged, idx_t = whole, None
                else:
                    merged, _ = merge_batch(batch.map(lambda a: a[idx]))
                    idx_t = torch.as_tensor(idx, device=self.device)
                ops, nb = self._fused_operands(merged, merged.x.shape[0])
                groups.append((int(k), idx_t, ops))
                nbytes += nb + idx.nbytes
            gid, w, nb = self._reconstruction_operands(whole, num_nodes)
            entry = self._cache_put(key, (groups, gid, w), nbytes + nb)
        return entry[0]

    def _reconstruction_operands(self, merged, num_nodes: int):
        """(global node id per row, 0/1 real-node weight per row, bytes) of
        a merged request on the device: padding and out-of-mesh rows
        scatter to a dump segment ``num_nodes``."""
        gids = np.asarray(merged.global_ids)
        nm = np.asarray(merged.node_mask)
        gid_dump = np.where(nm & (gids >= 0), gids,
                            np.int64(num_nodes)).astype(np.int64)
        dev = self.device
        return (torch.as_tensor(gid_dump, device=dev),
                torch.as_tensor(nm.astype(np.float32), device=dev),
                gid_dump.nbytes + nm.size * 4)

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

    @torch.inference_mode()
    def predict_full_batch(self, requests: list, num_nodes: int):
        """Coalesced serving: R requests on one geometry, one upload and one
        fetch.

        The R payloads go up as one [R, nodes, C] tensor; each request then
        runs the fast lane's fused forward and segment-mean reconstruction
        with the geometry operands shared, and the stacked outputs come back
        in one transfer.  Same preconditions as ``predict_full`` plus a
        shared geometry (senders/receivers/edge_attr/global_ids equal across
        requests, checked by raw-geometry hash); the budget is per request.
        Returns a list of (pred_full, ref_full) numpy pairs in request order,
        or None when the lane does not apply (caller serves per request).
        The JAX package pads R to a power of two to bound its recompiles;
        nothing is compiled per R here, so R is not padded.
        """
        if not requests:
            return []
        fused_env = os.environ.get("FESR_FUSED_PREDICT", "1")
        lane, reason = self._select_lane(
            [d for r in requests for d in r], fused_env)
        if lane != "fast":
            self._note_lane(
                "per-request",
                reason if lane == "general"
                else "routed scheduler: coalescing unsupported, "
                     "serving per-request")
            return None
        self._note_lane("coalesced", f"{len(requests)} requests, one dispatch")
        raws = [[_as_raw_graph(d) for d in r] for r in requests]
        h0 = self._hash_geometry(raws[0], with_gids=True)
        if any(self._hash_geometry(r, with_gids=True) != h0
               for r in raws[1:]):
            self._note_lane("per-request", "request geometries differ")
            return None
        b, n_pad, e_pad = self._request_shape(raws[0])
        if b * e_pad > edge_budget():
            self._note_lane("general", "edge budget exceeded")
            return None
        groups, gid, w = self._request_operands(
            raws[0], np.zeros(b, dtype=int), num_nodes, n_pad, e_pad)
        packed = [self._pack_full_payload(r, b, n_pad) for r in raws]
        dev = self.device
        xb = torch.as_tensor(np.stack([p[0] for p in packed]),
                             device=dev).reshape(len(raws), b, n_pad, -1)
        yb = torch.as_tensor(np.stack([p[1] for p in packed]), device=dev)
        outs = [self._serve_body(groups, xm, ym, gid, w, num_nodes)
                for xm, ym in zip(xb, yb)]
        if isinstance(outs[0], tuple):  # pred/ref channel counts differ
            preds = torch.stack([o[0] for o in outs]).cpu().numpy()
            refs = torch.stack([o[1] for o in outs]).cpu().numpy()
            return list(zip(preds, refs))
        o = torch.stack(outs).cpu().numpy()  # [R, 2, num_nodes, C] — ONE fetch
        return [(o[i, 0], o[i, 1]) for i in range(len(requests))]

    def _serve_body(self, groups, xb, ym, gid, w, num_nodes):
        """Each label group's fused forward over the payload ``xb``
        [B, n_pad, C], then the weighted segment-mean reconstruction (over
        the mesh's ranks, whose payloads are their blocks)."""
        b, n_pad, c_in = xb.shape
        pred = None
        for k, idx, (ea_b, sp, sm, rows_blk, blk) in groups:
            xg = xb if idx is None else xb[idx]
            out = self.experts[k].apply_fused(
                xg.reshape(-1, c_in), ea_b, sp, sm, rows_blk=rows_blk,
                blk=blk, gemm_dtype=self.gemm_dtype)
            if idx is None:  # one expert serves the whole request
                pred = out
                continue
            if pred is None:
                pred = out.new_zeros((b, n_pad, out.shape[-1]))
            pred[idx] = out.reshape(len(idx), n_pad, -1)
        return self._reconstruct(pred.reshape(b * n_pad, -1), ym, gid, w,
                                 num_nodes, self.mesh)

    @staticmethod
    def _reconstruct(pred, ym, gid, w, num_nodes, mesh=None):
        """Weighted segment mean of the merged rows ``pred`` and ``ym`` over
        global node ids; with a ``mesh``, of every rank's rows (the partial
        sums all-reduced).  ``w`` is the 0/1 real-node mask, so the
        ``1e-30`` floor only keeps uncovered nodes (sum 0) at 0/1e-30 = 0."""
        wc = w[:, None]
        acc = masked_segment_sum(torch.cat([pred * wc, ym * wc, wc], 1), gid,
                                 num_nodes + 1)
        if mesh is not None:
            acc = mesh.all_reduce(acc, "sum")
        c = pred.shape[1]
        accp, accr = acc[:, :c], acc[:, c:-1]
        ws = torch.clamp(acc[:, -1], min=1e-30)
        pred_o = accp[:num_nodes] / ws[:num_nodes, None]
        ref_o = accr[:num_nodes] / ws[:num_nodes, None]
        if pred_o.shape == ref_o.shape:
            # one stacked output -> ONE device->host transfer per request
            return torch.stack([pred_o, ref_o])
        return (pred_o, ref_o)


def _fetch(out):
    """(pred_full, ref_full) numpy from a lane's device output."""
    if isinstance(out, tuple):  # pred/ref channel counts differ
        return out[0].cpu().numpy(), out[1].cpu().numpy()
    o = out.cpu().numpy()  # stacked [2, num_nodes, C] — ONE fetch
    return o[0], o[1]
