"""Host->device ingestion pipeline: overlap ETL with device compute.

Parity target: the JAX package's ``data/pipeline.py``.  A bounded-queue
prefetcher: a worker thread uploads host batches (numpy or torch leaves in
dicts, lists, tuples or ``Graph``s) ``size`` ahead of use, so the device
does not wait on ETL.  On CUDA each upload runs on a side stream from pinned
host copies, and the consumer's stream waits on the upload's event before
the batch is handed over; on the CPU the leaves become tensors in place.
This replaces the reference's synchronous per-subdomain h5 reads inside the
training loop (scheduler_gnn.py:148-151).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..utils.device import resolve_device

_SENTINEL = object()


def _tree_map(fn, tree):
    """``fn`` over every array leaf (numpy or torch) of dicts, lists,
    tuples and ``Graph``-like objects (those with ``map``); other leaves
    pass through."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    if hasattr(tree, "map"):
        return tree.map(fn)
    return tree


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def prefetch_to_device(batch_iter: Iterable, size: int = 2, device=None,
                       sharding=None) -> Iterator:
    """Yields ``batch_iter``'s batches on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for), keeping ``size`` in flight.  With ``sharding``
    (a ``parallel.mesh.Mesh``) it yields this rank's block of each batch's
    leading axis on the rank's device, cut on the host before the upload.
    An error of the producer is raised on the consumer's side; a consumer
    that stops early stops the producer."""
    if sharding is not None:
        from ..parallel.mesh import local_block

        dev = sharding.device
        batch_iter = (local_block(b, sharding) for b in batch_iter)
    else:
        dev = resolve_device(device)
    side = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None

    def upload(batch):
        if side is None:
            return _tree_map(torch.as_tensor, batch), None
        pinned = _tree_map(lambda a: torch.as_tensor(a).pin_memory(), batch)
        with torch.cuda.stream(side):
            out = _tree_map(lambda t: t.to(dev, non_blocking=True), pinned)
            event = torch.cuda.Event()
            event.record(side)
        # the pinned copies stay referenced until the event has been waited
        return out, (event, pinned)

    q: queue.Queue = queue.Queue(maxsize=size)
    err: list[BaseException] = []
    stop = threading.Event()

    def producer():
        try:
            for batch in batch_iter:
                item = upload(batch)
                # timed put + stop flag: if the consumer abandons the
                # generator, the thread exits instead of blocking forever
                # on a full queue with device batches held
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            # the sentinel must reach the consumer (a dropped sentinel
            # deadlocks q.get()); timed puts honour the stop flag when the
            # consumer is gone instead
            while not stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.2)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            batch, sync = item
            if sync is not None:
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(sync[0])
                # the side stream's allocations are used on this stream now
                for leaf in _leaves(batch):
                    leaf.record_stream(stream)
            yield batch
    finally:
        stop.set()
        while not q.empty():  # release held device batches
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)
    if err:
        raise err[0]


class ThreadedLoader:
    """Parallel host ETL: maps ``load_fn`` over keys with worker threads,
    preserving order, bounded in-flight work."""

    def __init__(self, keys: list, load_fn: Callable, num_workers: int = 4,
                 ahead: int = 8):
        self.keys = keys
        self.load_fn = load_fn
        self.num_workers = num_workers
        self.ahead = ahead

    def __iter__(self):
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.num_workers) as pool:
            # deque + popleft: consumed futures (and their loaded results)
            # are dropped, so memory stays bounded by ``ahead`` instead of
            # growing with the dataset
            futures: deque = deque()
            it = iter(self.keys)
            for _ in range(self.ahead):
                k = next(it, _SENTINEL)
                if k is _SENTINEL:
                    break
                futures.append(pool.submit(self.load_fn, k))
            while futures:
                result = futures.popleft().result()
                k = next(it, _SENTINEL)
                if k is not _SENTINEL:
                    futures.append(pool.submit(self.load_fn, k))
                yield result
