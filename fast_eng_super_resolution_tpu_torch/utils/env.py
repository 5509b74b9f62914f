"""Process-group bring-up: one process per device over ``torch.distributed``.

Parity target: the JAX package's ``utils/env.py`` (``maybe_init_distributed``),
which calls ``jax.distributed.initialize`` so that one program's mesh spans
every host.  The port follows PyTorch's idiom instead, the reference's own
DDP layout (scheduler_gnn.py:104-114, 316-318): one process per device,
launched by ``torchrun --nproc-per-node=N`` (or by hand with the ``FESR_*``
variables below), each on its own card, NCCL between cards.  The JAX
package's ``setup_compilation_cache`` is XLA's and has no counterpart here:
the port's compiled kernels are cached by ``ops.fused_conv`` under
``_build/``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .device import resolve_device


def init_distributed(rank: int, world_size: int, init_method: str,
                     backend: str | None = None, device=None,
                     local_rank: int | None = None) -> torch.device:
    """Joins the process group as ``rank`` of ``world_size`` and returns
    this rank's device.

    ``device`` None is the rank's own card, ``cuda:local_rank`` (by default
    ``rank`` modulo the cards of the host), made the current CUDA device;
    without CUDA that raises, as every entry point's default does.  The
    backend is NCCL on a card and gloo on the CPU (``device="cpu"``); gloo
    on a card only when ``backend="gloo"`` is asked for (its collectives
    then run through host copies, ``parallel.mesh.Mesh``).  NCCL is never
    replaced by gloo: asking for it off a card raises.
    """
    if device is None:
        resolve_device(None)   # raises without CUDA
        local = (rank % torch.cuda.device_count() if local_rank is None
                 else int(local_rank))
        dev = torch.device("cuda", local)
    else:
        dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r} (expected nccl | gloo)")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, got {dev}; ask for "
                         "backend='gloo' to run on the CPU")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank))
    return dev


def maybe_init_distributed(backend: str | None = None, device=None) -> bool:
    """Env-gated bring-up: with ``FESR_MULTIHOST=1`` joins the process group
    (``init_distributed``) unless one exists; returns whether a group is up.

    The group is read from the ``FESR_*`` variables, the JAX package's
    names, or else from torchrun's:

      FESR_COORDINATOR    the rendezvous, ``host:port`` or an init method
                          (``tcp://host:port``); else torchrun's
                          MASTER_ADDR/MASTER_PORT (``env://``)
      FESR_NUM_PROCESSES  the world size (else WORLD_SIZE)
      FESR_PROCESS_ID     this process's rank (else RANK)

    and the card is ``cuda:LOCAL_RANK`` (torchrun's; else the rank modulo
    the host's cards).  A process launched into a world of several
    (``WORLD_SIZE`` > 1) without ``FESR_MULTIHOST=1`` raises rather than
    train or serve alone beside its siblings.
    """
    env = os.environ
    if env.get("FESR_MULTIHOST") != "1":
        if int(env.get("WORLD_SIZE", "1")) > 1:
            raise RuntimeError(
                f"launched as one of WORLD_SIZE={env['WORLD_SIZE']} "
                "processes without FESR_MULTIHOST=1: set it to join them")
        return False
    if dist.is_initialized():
        return True
    coord = env.get("FESR_COORDINATOR")
    if coord:
        init_method = coord if "://" in coord else f"tcp://{coord}"
    elif env.get("MASTER_ADDR"):
        init_method = "env://"
    else:
        raise ValueError("FESR_MULTIHOST=1 needs FESR_COORDINATOR (or "
                         "torchrun's MASTER_ADDR/MASTER_PORT)")
    world = int(env.get("FESR_NUM_PROCESSES", env.get("WORLD_SIZE", "1")))
    rank = int(env.get("FESR_PROCESS_ID", env.get("RANK", "0")))
    local = env.get("LOCAL_RANK")
    init_distributed(rank, world, init_method, backend, device,
                     None if local is None else int(local))
    return True


def finalize_distributed() -> None:
    """Leaves the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on rank 0 of the process group, and without one: the process
    that writes checkpoints, ``.vtu`` files and logs."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0
