"""Model factory — mirrors the reference's ``init_model`` surface
(reference utils.py:29-43).  ``'neuralop'`` maps width->width,
ker_width=width, depth=num_layers (utils.py:41); ``'teecnet'`` takes
num_layers (default 4).  As in the JAX package, the conv ``mode`` is not read
from the config: it is a model constructor argument.  The other model names
of the JAX package are not ported yet and raise."""

from __future__ import annotations

from .kernelnn import KernelNN
from .teecnet import TEECNet

GRID_MODELS = ("fno", "fno1d", "fno3d", "deeponet")

_NOT_PORTED = {
    "graphsage": "ROADMAP.md queue A item 14",
    **{name: "ROADMAP.md queue A item 14" for name in GRID_MODELS},
}


def init_model(type: str, in_channels: int, out_channels: int,
               seed: int = 0, **kwargs):
    """Returns a model (``nn.Module``) initialized from ``seed``."""
    if type == "neuralop":
        return KernelNN(
            width=kwargs["width"],
            ker_width=kwargs["width"],
            depth=kwargs["num_layers"],
            ker_in=1,
            in_width=in_channels,
            out_width=out_channels,
            kernel_rank=kwargs.get("kernel_rank"),
            seed=seed,
        )
    if type == "teecnet":
        return TEECNet(in_channels=in_channels, width=kwargs["width"],
                       out_channels=out_channels,
                       num_layers=kwargs.get("num_layers", 4), seed=seed)
    if type in _NOT_PORTED:
        raise NotImplementedError(
            f"model {type!r} is not ported yet ({_NOT_PORTED[type]})")
    raise ValueError(f"Invalid model type: {type}")
