"""Device resolution for the port's entry points.

The port serves on an NVIDIA GPU.  Every entry point takes ``device=`` and
passes it through here: ``None`` means the GPU, and only an explicit ``"cpu"``
selects the CPU, where the hand-written kernels run their plain PyTorch
versions.  There is no silent CPU fallback: without CUDA, the default raises.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` -> CPU; raises when CUDA is asked for
    (explicitly or by default) and the machine has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    return dev
