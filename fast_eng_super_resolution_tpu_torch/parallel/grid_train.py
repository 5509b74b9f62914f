"""Dense-tensor trainer for the grid model family (FNO1d/2d/3d, DeepONet).

Parity target: the JAX package's ``parallel/grid_train.py``: the mean
squared error of the model's output, projected by an optional Linear
(``proj``) when the target has another width, over [B, *S, C] batches, with
Adam at optax's defaults and the learning rate set from the host (StepLR).
The JAX package runs an epoch as one scanned device program over an index
order [S, B]; here an epoch is S eager steps, each batch an index gather of
the data uploaded once to the device, and the per-step losses stay on the
device until the caller reads them.  The parameters move to and from the
JAX package's ``{"model": ..., "proj": ...}`` tree (``GridNet``), so a
checkpoint of either package serves on the other.

Data parallelism: with a ``mesh`` of several ranks each rank steps on its
equal block of every batch (``shard_grid_epoch``) and the gradients are
averaged over the ranks.  The loss is a plain mean over equal blocks, so
the average of the blocks' gradients is the batch's gradient, and every
rank takes the single-device step on the whole batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..models.common import jax_tree, linear_init, load_jax_tree
from .mesh import Mesh, local_block
from .train import Trainer, _all_reduce_grads


class GridNet(nn.Module):
    """The trained function: ``model``, then ``proj`` when set."""

    def __init__(self, model: nn.Module, proj: nn.Linear | None = None):
        super().__init__()
        self.model = model
        self.proj = proj

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.model(x)
        return out if self.proj is None else self.proj(out)

    def jax_key(self, name: str) -> tuple[str, bool]:
        """``model.*`` by the model's own keys under ``model/``; ``proj``
        as a linear layer (w [in, out])."""
        head, rest = name.split(".", 1)
        if head == "model":
            key, transposed = self.model.jax_key(rest)
            return f"model/{key}", transposed
        return ("proj/w", True) if rest == "weight" else ("proj/b", False)

    def from_jax_params(self, params: dict) -> "GridNet":
        """Loads a ``{"model", "proj"?}`` tree in place (an optimizer over
        the parameters stays valid); ``proj`` is made or dropped when the
        tree's differs."""
        shape = np.shape(params["proj"]["w"]) if "proj" in params else None
        have = (None if self.proj is None
                else (self.proj.in_features, self.proj.out_features))
        if shape != have:
            self.proj = None if shape is None else nn.Linear(
                *shape, device=next(self.model.parameters()).device)
        load_jax_tree(self, params)
        return self

    def to_jax_params(self) -> dict:
        return jax_tree(self)


@dataclasses.dataclass
class GridTrainer:
    """Steps, evaluates and predicts ``model`` (trained in place, with the
    ``proj`` that ``init`` adds in ``net``) on the model's device."""

    model: nn.Module
    lr: float
    out_channels: int | None = None  # project the output to this width

    def __post_init__(self):
        self.net = GridNet(self.model)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def init(self, seed: int, sample_x) -> torch.optim.Adam:
        """Draws the model's parameters anew from ``seed`` (on the CPU, so a
        seed gives the same weights on every device), adds ``proj`` when the
        model's output width (of one sample of ``sample_x``) differs from
        ``out_channels``, and returns a fresh Adam."""
        dev = self.device
        g = torch.Generator().manual_seed(int(seed))
        self.model.cpu().init_params(g)
        self.model.to(dev)
        self.net.proj = None
        if self.out_channels is not None:
            with torch.no_grad():
                out_dim = self.model(torch.as_tensor(
                    np.asarray(sample_x[:1]), device=dev)).shape[-1]
            if out_dim != self.out_channels:
                proj = nn.utils.skip_init(nn.Linear, out_dim,
                                          self.out_channels)
                linear_init(proj, g)
                self.net.proj = proj.to(dev)
        return self.optimizer()

    def optimizer(self) -> torch.optim.Adam:
        return torch.optim.Adam(self.net.parameters(), lr=self.lr,
                                betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)

    def loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return ((self.net(x) - y) ** 2).mean()

    def step(self, opt: torch.optim.Optimizer, x: torch.Tensor,
             y: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
        """One Adam step; returns the loss before it (a 0-d device tensor).
        With a ``mesh``, ``x``/``y`` are this rank's equal block of the
        batch: the gradients and the loss are averaged over the ranks."""
        opt.zero_grad(set_to_none=True)
        loss = self.loss(x, y)
        loss.backward()
        if mesh is not None and mesh.backend is not None:
            params = [p for p in self.net.parameters() if p.grad is not None]
            _all_reduce_grads(params, mesh)
            for p in params:
                p.grad.div_(mesh.size)
            loss = mesh.all_reduce(loss.detach(), "sum") / mesh.size
        opt.step()
        return loss.detach()

    def epoch(self, opt: torch.optim.Optimizer, x: torch.Tensor,
              y: torch.Tensor, order, mesh: Mesh | None = None
              ) -> torch.Tensor:
        """A step per row of ``order`` ([n_batches, batch_size] sample
        indices into the device arrays ``x``/``y``; on a ``mesh``, this
        rank's columns); returns the losses [S] on the device."""
        order = torch.as_tensor(np.asarray(order), dtype=torch.long,
                                device=x.device)
        return torch.stack([self.step(opt, x[sel], y[sel], mesh)
                            for sel in order])

    def epoch_stacked(self, opt: torch.optim.Optimizer, xb: torch.Tensor,
                      yb: torch.Tensor, mesh: Mesh | None = None
                      ) -> torch.Tensor:
        """A step per leading index of the pre-batched [S, B, ...] arrays
        (on a ``mesh``, this rank's [S, B / size, ...] from
        ``shard_grid_epoch``)."""
        return torch.stack([self.step(opt, a, b, mesh)
                            for a, b in zip(xb, yb)])

    @torch.no_grad()
    def evaluate(self, x: torch.Tensor, y: torch.Tensor) -> float:
        return float(self.loss(x, y))

    @torch.no_grad()
    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)

    set_lr = staticmethod(Trainer.set_lr)


def shard_grid_epoch(xb, yb, mesh: Mesh):
    """This rank's block of the per-step batch axis (axis 1) of the [S, B,
    ...] epoch arrays, on the rank's device (B must divide over the
    ranks)."""
    def shard(a):
        a = torch.as_tensor(a)
        return local_block(a.transpose(0, 1), mesh).transpose(0, 1).to(
            mesh.device).contiguous()

    return shard(xb), shard(yb)
