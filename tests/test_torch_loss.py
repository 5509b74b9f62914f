"""Port of ops/loss.py: the gradient weight, the composite training loss and
their gradients with respect to the prediction, against the JAX package's
functions and ``jax.grad`` on the same padded graph."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_random_graph
from fast_eng_super_resolution_tpu.core.graph import pad_graph
from fast_eng_super_resolution_tpu.ops import loss as jloss
from fast_eng_super_resolution_tpu_torch.ops import loss as tloss

# float32 on both sides; the sums run in different orders -> 1e-5 relative
TOL = 1e-5


def _case(seed, masks):
    rng = np.random.default_rng(seed)
    g = make_random_graph(rng, n=60, e=400)
    if masks:
        g = pad_graph(g["x"], g["y"], g["pos"], g["senders"], g["receivers"],
                      g["edge_attr"], 64, 512)
        g = {k: np.asarray(getattr(g, k)) for k in
             ("x", "y", "senders", "receivers", "edge_attr", "node_mask",
              "edge_mask")}
    else:
        g = dict(g, node_mask=None, edge_mask=None)
    pred = (g["y"] + 0.3 * rng.normal(size=g["y"].shape)).astype(np.float32)
    return pred, g


def _args(g, to):
    return [to(g[k]) if g[k] is not None else None
            for k in ("y", "senders", "receivers", "edge_attr", "edge_mask",
                      "node_mask")]


def _compare(jfn, tfn, pred, g):
    ref, ref_grad = jax.value_and_grad(
        lambda p: jfn(p, *_args(g, jnp.asarray)))(jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    got = tfn(p, *_args(g, torch.as_tensor))
    got.backward()
    got = float(got.detach())
    assert abs(got - float(ref)) <= TOL * max(abs(float(ref)), 1e-6)
    ref_grad = np.asarray(ref_grad)
    err = np.abs(p.grad.numpy() - ref_grad).max() / np.abs(ref_grad).max()
    assert err < TOL, err


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("min_weight", [None, 0.0])
def test_gradient_weight_scalar_and_grad_match_jax(min_weight, masks):
    pred, g = _case(0, masks)
    kw = dict(min_weight=min_weight)
    _compare(lambda *a: jloss.gradient_weight_scalar(*a, **kw),
             lambda *a: tloss.gradient_weight_scalar(*a, **kw), pred, g)


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("kind", ["gradient", "mse"])
def test_training_loss_and_grad_match_jax(kind, masks):
    pred, g = _case(1, masks)
    _compare(lambda *a: jloss.training_loss(*a, kind=kind),
             lambda *a: tloss.training_loss(*a, kind=kind), pred, g)


@pytest.mark.parametrize("masks", [False, True])
def test_gradient_based_and_linf_match_jax(masks):
    pred, g = _case(2, masks)
    _compare(jloss.gradient_based_loss, tloss.gradient_based_loss, pred, g)
    _compare(lambda p, y, *a: jloss.linf_loss(p, y, a[-1]),
             lambda p, y, *a: tloss.linf_loss(p, y, a[-1]), pred, g)


def test_unported_loss_options_raise(monkeypatch):
    pred, g = _case(3, False)
    with pytest.raises(ValueError, match="unknown loss kind"):
        tloss.training_loss(torch.as_tensor(pred), *_args(g, torch.as_tensor),
                            kind="l1")
    monkeypatch.setenv("FESR_LOSS_VJP", "custom")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tloss.gradient_weight_scalar(torch.as_tensor(pred),
                                     *_args(g, torch.as_tensor))
