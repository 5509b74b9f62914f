"""Model factory — mirrors the reference's ``init_model`` surface
(reference utils.py:29-43).  ``'neuralop'`` maps width->width,
ker_width=width, depth=num_layers (utils.py:41); ``'teecnet'`` takes
num_layers (default 4).  As in the JAX package, the conv ``mode`` is not read
from the config: it is a model constructor argument.

The grid family keeps the JAX package's quirks: ``'fno'`` binds
``in_channels``/``out_channels`` positionally onto FNO2d's ``modes1/modes2``
(reference utils.py:30-31 against model.py:64), so the shipped configs build
the same network, with ``in_feats`` 256 unless the config names it;
``'fno1d'`` and ``'fno3d'`` read ``modes``; ``'deeponet'`` needs
``trunk_size`` (utils.py:37), which no reference config has.  GraphSAGE is
not ported yet and raises."""

from __future__ import annotations

from .deeponet import DeepONet
from .fno import FNO1d, FNO2d, FNO3d
from .kernelnn import KernelNN
from .teecnet import TEECNet

GRAPH_MODELS = ("teecnet", "graphsage", "neuralop")
GRID_MODELS = ("fno", "fno1d", "fno3d", "deeponet")

_NOT_PORTED = {"graphsage": "ROADMAP.md queue A item 14 (ii)"}


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
    if type == "fno":
        return FNO2d(modes1=in_channels, modes2=out_channels,
                     width=kwargs["width"],
                     in_feats=kwargs.get("in_feats", 256), seed=seed)
    if type == "fno1d":
        return FNO1d(modes1=int(kwargs.get("modes", 16)),
                     width=kwargs["width"],
                     in_feats=kwargs.get("in_feats", in_channels),
                     padding=int(kwargs.get("padding", 0)), seed=seed)
    if type == "fno3d":
        # modes: an int, or [m1, m2, m3]
        modes = kwargs.get("modes", 8)
        m1, m2, m3 = (modes if isinstance(modes, (list, tuple))
                      else (modes, modes, modes))
        return FNO3d(modes1=int(m1), modes2=int(m2), modes3=int(m3),
                     width=kwargs["width"],
                     in_feats=kwargs.get("in_feats", in_channels),
                     padding=int(kwargs.get("padding", 6)), seed=seed)
    if type == "deeponet":
        if "trunk_size" not in kwargs:
            raise KeyError(
                "model 'deeponet' requires exp_config key 'trunk_size' "
                "(same requirement as reference utils.py:37)")
        return DeepONet(branch_input_dim=in_channels,
                        trunk_input_dim=kwargs["trunk_size"],
                        hidden_dim=kwargs["width"], output_dim=out_channels,
                        seed=seed)
    if type in _NOT_PORTED:
        raise NotImplementedError(
            f"model {type!r} is not ported yet ({_NOT_PORTED[type]})")
    raise ValueError(f"Invalid model type: {type}")
