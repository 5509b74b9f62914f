"""Power-series (Taylor-expansion) edge kernels, as ``nn.Module``s.

Port of the JAX package's ``models/powerseries.py`` (parity target:
reference models/model.py:318-362, PowerSeriesConv and PowerSeriesKernel).
The reference defines this kernel family but leaves it disconnected from
TEECNet (model.py:402, 427 are commented out); the JAX package makes it
TEECNet's ``kernel_type='powerseries'``.  Between layers the reference's
BatchNorm is kept in its eval-mode form: identity with a learned affine.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_HIDDEN = 16  # the hidden width of the kernel stack (model.py:354-360)


class PowerSeriesConv(nn.Module):
    """PowerSeriesConv.forward (model.py:333-342):
    out = r_0 xc + sum_{i>=1} r_i tanh(xc^(i+1)), xc = linear(x)."""

    def __init__(self, c_in: int, c_out: int, num_powers: int):
        super().__init__()
        self.num_powers = num_powers
        self.linear = nn.utils.skip_init(nn.Linear, c_in, c_out)
        self.root_param = nn.Parameter(torch.empty(num_powers))

    def init_params(self, generator: torch.Generator) -> None:
        """xavier_uniform on the weight, U(-1, 1) on root_param
        (model.py:327-331); the bias keeps torch Linear's default
        U(-1/sqrt(c_in), 1/sqrt(c_in))."""
        c_out, c_in = self.linear.weight.shape
        bound = math.sqrt(6.0 / (c_in + c_out))
        with torch.no_grad():
            self.linear.weight.uniform_(-bound, bound, generator=generator)
            self.linear.bias.uniform_(-1.0 / math.sqrt(c_in),
                                      1.0 / math.sqrt(c_in),
                                      generator=generator)
            self.root_param.uniform_(-1.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = self.linear(x)
        out = self.root_param[0] * xc
        for i in range(1, self.num_powers):
            # an integer power by repeated products, as jnp.power with a
            # Python int computes it
            out = out + self.root_param[i] * torch.tanh(xc ** (i + 1))
        return out


class PowerSeriesKernel(nn.Module):
    """Edge attributes -> per-edge features (model.py:345-362): conv0,
    ``num_layers`` hidden convs each followed by the affine, conv_out."""

    def __init__(self, in_channel: int, out_channel: int, num_layers: int,
                 num_powers: int):
        super().__init__()
        self.conv0 = PowerSeriesConv(in_channel, _HIDDEN, num_powers)
        self.convs = nn.ModuleList([PowerSeriesConv(_HIDDEN, _HIDDEN, num_powers)
                                    for _ in range(num_layers)])
        self.conv_out = PowerSeriesConv(_HIDDEN, out_channel, num_powers)
        self.norm_scale = nn.Parameter(torch.ones(_HIDDEN))
        self.norm_bias = nn.Parameter(torch.zeros(_HIDDEN))

    def init_params(self, generator: torch.Generator) -> None:
        for conv in (self.conv0, *self.convs, self.conv_out):
            conv.init_params(generator)
        with torch.no_grad():
            self.norm_scale.fill_(1.0)
            self.norm_bias.zero_()

    def forward(self, edge_attr: torch.Tensor) -> torch.Tensor:
        h = self.conv0(edge_attr)
        for conv in self.convs:
            h = conv(h) * self.norm_scale + self.norm_bias
        return self.conv_out(h)
