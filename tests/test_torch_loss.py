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
    """kind='l1' still raises; ``FESR_LOSS_VJP=custom`` (once refused) now
    returns the JAX package's custom-path value."""
    pred, g = _case(3, False)
    with pytest.raises(ValueError, match="unknown loss kind"):
        tloss.training_loss(torch.as_tensor(pred), *_args(g, torch.as_tensor),
                            kind="l1")
    monkeypatch.setenv("FESR_LOSS_VJP", "custom")
    got = float(tloss.gradient_weight_scalar(torch.as_tensor(pred),
                                             *_args(g, torch.as_tensor)))
    ref = float(jloss.gradient_weight_scalar(jnp.asarray(pred),
                                             *_args(g, jnp.asarray)))
    assert abs(got - ref) <= 1e-4 * max(abs(ref), 1.0)


def _custom_inputs(seed=0):
    """tests/test_ops.py's custom-VJP case: 64 nodes, 256 random edges,
    4 channels, random masks."""
    rng = np.random.default_rng(seed)
    n, e, c = 64, 256, 4
    return dict(pred=rng.normal(size=(n, c)).astype(np.float32),
                tgt=rng.normal(size=(n, c)).astype(np.float32),
                s=rng.integers(0, n, e).astype(np.int32),
                r=rng.integers(0, n, e).astype(np.int32),
                ea=(0.5 + rng.random((e, 1))).astype(np.float32),
                em=rng.random(e) > 0.2, nm=rng.random(n) > 0.1)


def _weight_and_grads(side: str, impl: str, d: dict, em, nm, to: str, mw,
                      monkeypatch):
    """(value, d/dpred, d/dtarget) of ``gradient_weight_scalar`` under
    ``FESR_LOSS_VJP=impl`` on the JAX side or the port's (numpy out)."""
    monkeypatch.setenv("FESR_LOSS_VJP", impl)
    em_ = None if em is None else d["em"]
    nm_ = None if nm is None else d["nm"]
    if side == "jax":
        f = lambda p, t: jloss.gradient_weight_scalar(  # noqa: E731
            p, t, jnp.asarray(d["s"]), jnp.asarray(d["r"]),
            jnp.asarray(d["ea"]), None if em_ is None else jnp.asarray(em_),
            None if nm_ is None else jnp.asarray(nm_), 1.0, to, mw)
        v, (gp, gt) = jax.value_and_grad(f, argnums=(0, 1))(
            jnp.asarray(d["pred"]), jnp.asarray(d["tgt"]))
        return float(v), np.asarray(gp), np.asarray(gt)
    p = torch.tensor(d["pred"], requires_grad=True)
    t = torch.tensor(d["tgt"], requires_grad=True)
    v = tloss.gradient_weight_scalar(
        p, t, torch.as_tensor(d["s"]), torch.as_tensor(d["r"]),
        torch.as_tensor(d["ea"]),
        None if em_ is None else torch.as_tensor(em_),
        None if nm_ is None else torch.as_tensor(nm_), 1.0, to, mw)
    v.backward()
    return float(v.detach()), p.grad.numpy(), t.grad.numpy()


# the four mask / scatter / min_weight cases of tests/test_ops.py:253-254
CUSTOM_CASES = [("em", "nm", "receivers", 0.0), (None, None, "senders", None),
                ("em", None, "receivers", None), (None, "nm", "senders", 0.0)]


@pytest.mark.parametrize("em,nm,to,mw", CUSTOM_CASES)
def test_custom_loss_vjp_matches_jax_custom(em, nm, to, mw, monkeypatch):
    """``FESR_LOSS_VJP=custom``: the port's ``GradientWeightScalar`` against
    JAX's custom-VJP path and against the port's autograd path: the value
    within 1e-4 relative, both gradients within 1e-5 in relative L2 (the
    JAX package's own bounds, tests/test_ops.py:230-272)."""
    d = _custom_inputs()
    ref = _weight_and_grads("jax", "custom", d, em, nm, to, mw, monkeypatch)
    got = _weight_and_grads("port", "custom", d, em, nm, to, mw, monkeypatch)
    auto = _weight_and_grads("port", "xla", d, em, nm, to, mw, monkeypatch)
    for other in (got, auto):
        assert abs(other[0] - ref[0]) <= 1e-4 * max(abs(ref[0]), 1.0)
    for want, g, a in zip(ref[1:], got[1:], auto[1:]):
        denom = max(np.linalg.norm(want), 1e-12)
        assert np.linalg.norm(g - want) / denom < 1e-5
        assert np.linalg.norm(a - want) / denom < 1e-5
    np.testing.assert_array_equal(got[2], -got[1])


def test_custom_loss_vjp_ties_follow_jax_custom(monkeypatch):
    """At ties the custom path gives the first argmax channel and the clamp
    boundary the whole gradient, where autograd splits it: two equal channel
    maxima on every edge of node 1, whose weight sits exactly at
    ``max_weight``.  The port's custom gradient equals JAX's custom one and
    differs from the port's autograd one."""
    d = dict(pred=np.array([[2.0, 2.0], [0.0, 0.0], [1.0, 0.5],
                            [0.5, 0.25]], np.float32),
             tgt=np.zeros((4, 2), np.float32),
             s=np.array([0, 2, 3], np.int32), r=np.array([1, 1, 2], np.int32),
             ea=np.array([[4.0], [2.0], [1.0]], np.float32),
             em=np.ones(3, bool), nm=np.ones(4, bool))
    # edge 0: g = (2, 2)/4 -> tie at 0.5; edge 1: g = (1, 0.5)/2 -> 0.5;
    # node 1's weight 0.5 + 0.5 = 1.0 = max_weight exactly
    for mw in (None, 0.0):
        ref = _weight_and_grads("jax", "custom", d, "em", "nm", "receivers",
                                mw, monkeypatch)
        got = _weight_and_grads("port", "custom", d, "em", "nm", "receivers",
                                mw, monkeypatch)
        auto = _weight_and_grads("port", "xla", d, "em", "nm", "receivers",
                                 mw, monkeypatch)
        assert got[0] == ref[0] == auto[0]
        for want, g in zip(ref[1:], got[1:]):
            np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-7)
        # the first channel of node 0 takes edge 0's whole gradient
        assert got[1][0, 0] == 0.25 and got[1][0, 1] == 0.0
        assert not np.allclose(auto[1], got[1])
