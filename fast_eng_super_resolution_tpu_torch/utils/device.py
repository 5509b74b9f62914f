"""Device resolution for the port's entry points.

The port serves on an NVIDIA GPU.  Every entry point takes ``device=`` and
passes it through here: ``None`` means the GPU, and only an explicit ``"cpu"``
selects the CPU, where the hand-written kernels run their plain PyTorch
versions.  There is no silent CPU fallback: without CUDA, the default raises.
In a process group (``utils.env.init_distributed``) the default is the
rank's own card, the current CUDA device, not card 0.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` -> CPU; raises when CUDA is asked for
    (explicitly or by default) and the machine has none.  In a process
    group, ``None`` and a bare ``cuda`` are the rank's card
    (``cuda:<current device>``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if (dev.type == "cuda" and dev.index is None and dist.is_available()
            and dist.is_initialized()):
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    return dev
