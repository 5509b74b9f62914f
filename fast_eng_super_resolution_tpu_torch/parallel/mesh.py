"""Data-parallel mesh helpers over ``torch.distributed``.

Parity target: the JAX package's ``parallel/mesh.py``, which places one
program's batch on a ``Mesh``'s ``data`` axis.  The port runs one process per
device (``utils.env.init_distributed``; the reference's DDP layout,
scheduler_gnn.py:104-114, 316-318): a ``Mesh`` is this process's view of the
group (its size, its rank, its device), ``shard_batch`` keeps the rank's
block of the leading axis, as ``P('data')`` splits it (rank r gets rows
``[r*per, (r+1)*per)``), and ``replicate`` broadcasts rank 0's copy.  Without
a process group the mesh is one device, and its collectives are identities.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..data.pipeline import _tree_map
from ..utils.device import resolve_device

DATA_AXIS = "data"
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group (the default
    process group): ``size`` ranks, this one ``rank`` on ``device``, over
    ``backend`` (None: no group, one device, collectives are identities).
    Collectives take and return tensors on ``device``; over gloo a card's
    tensor goes through a host copy (gloo reduces on the host)."""

    size: int
    rank: int
    device: torch.device
    backend: str | None = None
    axis: str = DATA_AXIS

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """A private contiguous copy of ``t`` where the backend works."""
        t = t.detach()
        if self.backend == "gloo" and t.is_cuda:
            return t.cpu()
        return t.clone(memory_format=torch.contiguous_format)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The ``op`` ('sum' | 'max') of ``t`` over the ranks (a new tensor
        on ``t``'s device; ``t`` itself without a process group)."""
        if self.backend is None:
            return t
        buf = self._staged(t)
        dist.all_reduce(buf, op=_OPS[op])
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on each), concatenated along
        dim 0 in rank order."""
        if self.backend is None:
            return t
        buf = self._staged(t)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf)
        return torch.cat(parts).to(t.device)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrites ``t`` in place with rank ``src``'s."""
        if self.backend is not None:
            buf = self._staged(t)
            dist.broadcast(buf, src)
            with torch.no_grad():
                t.copy_(buf)
        return t

    def barrier(self) -> None:
        if self.backend is not None:
            dist.barrier()


def make_mesh(devices=None, axis: str = DATA_AXIS) -> Mesh:
    """The data-parallel mesh of this process: the process group's world
    when one is up, else one device.  ``devices``: this rank's device (or a
    list holding it alone); None is the rank's card (``resolve_device``)."""
    if isinstance(devices, (list, tuple)):
        if len(devices) != 1:
            raise ValueError(f"{len(devices)} devices for one process: the "
                             "port runs one process per device (torchrun)")
        devices = devices[0]
    dev = resolve_device(devices)
    if dist.is_available() and dist.is_initialized():
        return Mesh(dist.get_world_size(), dist.get_rank(), dev,
                    dist.get_backend(), axis)
    return Mesh(1, 0, dev, None, axis)


def local_block(tree, mesh: Mesh):
    """This rank's contiguous block of every leaf's leading axis (numpy or
    torch, where it lies): rows ``[rank*per, (rank+1)*per)``."""
    def block(a):
        b = a.shape[0]
        if b % mesh.size:
            raise ValueError(f"leading axis {b} does not divide over "
                             f"{mesh.size} ranks (pad_batch_to_multiple)")
        per = b // mesh.size
        return a[mesh.rank * per:(mesh.rank + 1) * per]

    return _tree_map(block, tree)


def shard_batch(batch, mesh: Mesh):
    """This rank's block of a batch (a ``Graph`` with a leading [B] axis, or
    a dict/list tree of arrays) as torch tensors on the rank's device."""
    return _tree_map(lambda a: torch.as_tensor(a, device=mesh.device),
                     local_block(batch, mesh))


def replicate(tree, mesh: Mesh):
    """``tree`` (an ``nn.Module``, or a tree of arrays) on the rank's device
    with rank 0's values; a module is moved and overwritten in place."""
    if isinstance(tree, torch.nn.Module):
        tree.to(mesh.device)
        for t in list(tree.parameters()) + list(tree.buffers()):
            mesh.broadcast_(t.data)
        return tree
    return _tree_map(lambda a: mesh.broadcast_(
        torch.as_tensor(a, device=mesh.device).clone()), tree)


def pad_batch_to_multiple(batch, multiple: int):
    """(batch, real count): pads a host ``Graph`` batch's leading axis to a
    multiple of ``multiple`` with copies of graph 0 whose node and edge
    masks are all False, so they add nothing to losses or reconstructions
    (host numpy, the same bits as the JAX package's)."""
    b = batch.x.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return batch, b

    def pad_leaf(x):
        x = np.asarray(x)
        return np.concatenate([x, np.repeat(x[:1], rem, axis=0)], axis=0)

    padded = batch.map(pad_leaf)
    keep = np.concatenate([np.ones((b,), bool), np.zeros((rem,), bool)])
    return dataclasses.replace(padded,
                               node_mask=padded.node_mask & keep[:, None],
                               edge_mask=padded.edge_mask & keep[:, None]), b
