"""Fixed-shape subdomain graph structures.

The reference stores each subdomain as a variable-size ``torch_geometric.data.Data``
(x, y, pos, edge_index, edge_attr; see reference dataset/GraphDataset.py:214-227,
772-797) and loops over them in Python.  The framework's unit of work is a
*padded* graph (``Graph``) and a *batch of padded graphs* (``GraphBatch``)
bucketed to a small set of (N_max, E_max) sizes.

Conventions
-----------
- ``senders[e]`` -> ``receivers[e]`` is a directed edge; messages flow from the
  sender (source) to the receiver (target), matching PyG's default
  ``flow='source_to_target'`` used by the reference models
  (reference models/model.py:521-529).
- Padded nodes live at the tail of the node axis with ``node_mask == False``.
- Padded edges have ``senders == receivers == N_pad - 1`` (a padded node) and
  ``edge_mask == False``; their ``edge_attr`` is 1.0 so divisions stay finite.
- ``global_ids`` maps each local node to its index in the full mesh (the
  analogue of the reference's "GlobalPointIds" array,
  reference dataset/GraphDataset.py:601-609); padded nodes carry -1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class Graph:
    """One padded subdomain graph (all arrays fixed-shape).

    Leaves are numpy arrays on the host and torch tensors on a device
    (``to_torch``).

    Attributes:
      x:          [N, C_in]  input node features (interpolated low-res field).
      y:          [N, C_out] target node features (high-res field) or zeros.
      pos:        [N, 3]     node coordinates.
      senders:    [E]        int32 edge source indices.
      receivers:  [E]        int32 edge target indices.
      edge_attr:  [E, A]     edge features (A=1: edge length, GraphDataset.py:866).
      node_mask:  [N]        bool, True for real nodes.
      edge_mask:  [E]        bool, True for real edges.
      global_ids: [N]        int32 index into the full mesh, -1 for padding.
    """

    x: np.ndarray
    y: np.ndarray
    pos: np.ndarray
    senders: np.ndarray
    receivers: np.ndarray
    edge_attr: np.ndarray
    node_mask: np.ndarray
    edge_mask: np.ndarray
    global_ids: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.x.shape[-2]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[-1]

    @property
    def num_real_nodes(self):
        """The int32 count of real nodes along the last axis (a numpy
        array on the host, a tensor on a device)."""
        if isinstance(self.node_mask, torch.Tensor):
            return self.node_mask.to(torch.int32).sum(dim=-1,
                                                      dtype=torch.int32)
        return np.sum(np.asarray(self.node_mask).astype(np.int32), axis=-1,
                      dtype=np.int32)

    def map(self, fn) -> "Graph":
        """A Graph with ``fn`` applied to every leaf."""
        return Graph(**{f.name: fn(getattr(self, f.name))
                        for f in dataclasses.fields(self)})

    def to_torch(self, device) -> "Graph":
        """Every leaf as a torch tensor on ``device`` (int32 indices stay
        int32, masks stay bool)."""
        return self.map(lambda a: torch.as_tensor(np.asarray(a), device=device))


# A GraphBatch is simply a Graph whose arrays carry a leading batch axis [B, ...].
GraphBatch = Graph


def pad_graph(
    x: np.ndarray,
    y: Optional[np.ndarray],
    pos: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_attr: np.ndarray,
    n_pad: int,
    e_pad: int,
    global_ids: Optional[np.ndarray] = None,
    out_channels: Optional[int] = None,
) -> Graph:
    """Pads one variable-size graph to (n_pad, e_pad) static shapes (host-side)."""
    n, c_in = x.shape
    e = senders.shape[0]
    if n > n_pad:
        raise ValueError(f"graph has {n} nodes > n_pad={n_pad}")
    if e > e_pad:
        raise ValueError(f"graph has {e} edges > e_pad={e_pad}")
    if e < e_pad and n >= n_pad:
        raise ValueError(
            f"padded edges need a padded node: n == n_pad == {n_pad} would "
            "alias a real node (size buckets via BucketSpec.bucket_for, "
            "which reserves one)")
    if edge_attr.ndim == 1:
        edge_attr = edge_attr[:, None]
    # sort edges by receiver: padded edges (receiver = n_pad-1) land at the
    # tail, so segment ids are globally ascending — the fused conv layer
    # groups them into receiver blocks without a sort
    receivers = np.asarray(receivers)
    if not (len(receivers) and np.all(receivers[:-1] <= receivers[1:])):
        # native extract paths already emit receiver-major edges; only
        # reorder when the input isn't sorted (saves 3 big gathers at 1M+)
        order = np.argsort(receivers, kind="stable")
        senders = np.asarray(senders)[order]
        receivers = receivers[order]
        edge_attr = np.asarray(edge_attr)[order]
    a = edge_attr.shape[1]
    c_out = y.shape[1] if y is not None else (out_channels or c_in)

    xp = np.zeros((n_pad, c_in), np.float32)
    xp[:n] = x
    yp = np.zeros((n_pad, c_out), np.float32)
    if y is not None:
        yp[:n] = y
    pp = np.zeros((n_pad, 3), np.float32)
    pp[:n] = pos
    pad_node = max(n_pad - 1, 0)
    sp = np.full((e_pad,), pad_node, np.int32)
    sp[:e] = senders
    rp = np.full((e_pad,), pad_node, np.int32)
    rp[:e] = receivers
    ap = np.ones((e_pad, a), np.float32)
    ap[:e] = edge_attr
    nm = np.zeros((n_pad,), bool)
    nm[:n] = True
    em = np.zeros((e_pad,), bool)
    em[:e] = True
    gi = np.full((n_pad,), -1, np.int32)
    gi[:n] = np.arange(n, dtype=np.int32) if global_ids is None else global_ids
    return Graph(x=xp, y=yp, pos=pp, senders=sp, receivers=rp, edge_attr=ap,
                 node_mask=nm, edge_mask=em, global_ids=gi)


def stack_graphs(graphs: Sequence[Graph]) -> GraphBatch:
    """Stacks equally-padded Graphs into a host GraphBatch with a leading [B]
    axis (numpy; ``GraphBatch.to_torch`` moves it to a device)."""
    return Graph(**{f.name: np.stack([np.asarray(getattr(g, f.name))
                                      for g in graphs], axis=0)
                    for f in dataclasses.fields(Graph)})


def merge_batch(batch: GraphBatch) -> tuple[Graph, np.ndarray]:
    """Flattens a [B, ...] GraphBatch into ONE block-diagonal Graph.

    Local node indices get per-graph offsets, so a single segment-sum /
    gather pass covers the whole batch.  ``graph_ids`` ([B*N]) lets callers
    recover per-graph reductions with one more segment op.

    Host-polymorphic: a numpy batch stays numpy, a torch batch stays on its
    device.
    """
    on_host = isinstance(batch.senders, np.ndarray)
    b, n = batch.x.shape[0], batch.x.shape[1]
    e = batch.senders.shape[1]
    if on_host:
        off = (np.arange(b, dtype=batch.senders.dtype) * n)[:, None]
        graph_ids = np.repeat(np.arange(b, dtype=np.int32), n)
    else:
        dev = batch.senders.device
        off = (torch.arange(b, dtype=batch.senders.dtype, device=dev) * n)[:, None]
        graph_ids = torch.arange(b, dtype=torch.int32,
                                 device=dev).repeat_interleave(n)
    merged = Graph(
        x=batch.x.reshape(b * n, -1),
        y=batch.y.reshape(b * n, -1),
        pos=batch.pos.reshape(b * n, -1),
        senders=(batch.senders + off).reshape(-1),
        receivers=(batch.receivers + off).reshape(-1),
        edge_attr=batch.edge_attr.reshape(b * e, -1),
        node_mask=batch.node_mask.reshape(-1),
        edge_mask=batch.edge_mask.reshape(-1),
        global_ids=batch.global_ids.reshape(-1),
    )
    return merged, graph_ids


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Size bucketing policy: quantize (N, E) to a small set of shapes.

    The reference re-runs Python per variable-size subdomain
    (scheduler_gnn.py:217-226); here each distinct bucket is one padded
    shape, shared by every graph that falls in it.
    """

    node_multiple: int = 256
    edge_multiple: int = 1024
    min_nodes: int = 256
    min_edges: int = 1024

    def bucket_for(self, n: int, e: int) -> tuple[int, int]:
        # n+1: guarantee at least one PADDED node, because padded edges
        # point at node n_pad-1 — at n == n_pad that would alias a real
        # node and consumers without an edge_mask would scatter spurious
        # messages into it (module-docstring invariant)
        return (
            max(_round_up(n + 1, self.node_multiple), self.min_nodes),
            max(_round_up(e, self.edge_multiple), self.min_edges),
        )


def pad_and_bucket(
    raw_graphs: Sequence[dict],
    spec: BucketSpec = BucketSpec(),
    uniform: bool = True,
) -> list[tuple[tuple[int, int], list[int], GraphBatch]]:
    """Pads a list of raw graphs (dicts of numpy arrays) into batched buckets.

    Args:
      raw_graphs: each dict has keys x, y, pos, senders, receivers, edge_attr and
        optionally global_ids.
      spec: bucketing policy.
      uniform: if True, everything lands in a single bucket sized by the largest
        graph (some padding waste) — the right default for meshes
        partitioned into near-equal subdomains (METIS balance, GraphDataset.py:561).

    Returns:
      list of (bucket_key, member_indices, GraphBatch), the batches on the host.
    """
    if not raw_graphs:
        return []
    sizes = [(g["x"].shape[0], g["senders"].shape[0]) for g in raw_graphs]
    if uniform:
        n_max = max(s[0] for s in sizes)
        e_max = max(s[1] for s in sizes)
        keys = [spec.bucket_for(n_max, e_max)] * len(raw_graphs)
    else:
        keys = [spec.bucket_for(n, e) for n, e in sizes]

    buckets: dict[tuple[int, int], list[int]] = {}
    for i, k in enumerate(keys):
        buckets.setdefault(k, []).append(i)

    out = []
    for key, idxs in sorted(buckets.items()):
        n_pad, e_pad = key
        gs = [
            pad_graph(
                raw_graphs[i]["x"], raw_graphs[i].get("y"), raw_graphs[i]["pos"],
                raw_graphs[i]["senders"], raw_graphs[i]["receivers"],
                raw_graphs[i]["edge_attr"], n_pad, e_pad,
                global_ids=raw_graphs[i].get("global_ids"),
            )
            for i in idxs
        ]
        out.append((key, idxs, stack_graphs(gs)))
    return out
