"""The port's ``ops/message_passing.py`` takes its parameters in the JAX
package's order: a call copied from JAX with positional arguments binds
each argument as JAX binds it, and ``edges_sorted`` (a hint) is accepted
where JAX's is and changes no bit.  The models carry the JAX models'
``edges_sorted`` field, and the plain serving lane sets it."""

import inspect

import numpy as np
import pytest
import torch

from fast_eng_super_resolution_tpu.models.kernelnn import KernelNN as JKernelNN
from fast_eng_super_resolution_tpu.models.teecnet import TEECNet as JTEECNet
from fast_eng_super_resolution_tpu.ops import message_passing as jmp
from fast_eng_super_resolution_tpu_torch.models.common import with_edges_sorted
from fast_eng_super_resolution_tpu_torch.models.kernelnn import KernelNN
from fast_eng_super_resolution_tpu_torch.models.teecnet import TEECNet
from fast_eng_super_resolution_tpu_torch.ops import message_passing as mp


@pytest.mark.parametrize("name", ["precompute_edge_kernel",
                                  "edge_conditioned_conv"])
def test_parameters_in_jax_order(name):
    want = list(inspect.signature(getattr(jmp, name)).parameters)
    got = list(inspect.signature(getattr(mp, name)).parameters)
    assert got == want


def _graph(seed=0, n=40, e=200, w=6):
    rng = np.random.default_rng(seed)
    recv = np.sort(rng.integers(0, n, e))
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    return dict(x=t(rng.normal(size=(n, w)).astype(np.float32)),
                senders=t(rng.integers(0, n, e).astype(np.int32)),
                receivers=t(recv.astype(np.int32)),
                edge_attr=t(rng.random((e, 1)).astype(np.float32)),
                mask=t(rng.random(e) > 0.2))


@pytest.mark.parametrize("mode,kernel_dtype",
                         [("edge3d", "bfloat16"), ("lut", None),
                          ("factored", None)])
def test_precompute_edge_kernel_jax_positional_call(mode, kernel_dtype):
    """JAX's positional order (mode, kernel_dtype, lut_knots, edge_mask)
    gives the keyword call's bits."""
    m = KernelNN(6, 6, 2, in_width=6, out_width=6)
    g = _graph()
    pos = mp.precompute_edge_kernel(m.edge_mlp, g["edge_attr"], torch.relu,
                                    mode, kernel_dtype, 64, g["mask"])
    kw = mp.precompute_edge_kernel(m.edge_mlp, g["edge_attr"], torch.relu,
                                   mode=mode, edge_mask=g["mask"],
                                   kernel_dtype=kernel_dtype, lut_knots=64)
    assert pos[0] == kw[0] == mode
    a = pos[1] if isinstance(pos[1], tuple) else (pos[1],)
    b = kw[1] if isinstance(kw[1], tuple) else (kw[1],)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    if kernel_dtype:
        assert a[0].dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["edge3d", "factored", "lut"])
def test_edges_sorted_changes_no_bit(mode):
    m = KernelNN(6, 6, 2, in_width=6, out_width=6)
    g = _graph(1)
    outs = [mp.edge_conditioned_conv(
        g["x"], g["senders"], g["receivers"], g["edge_attr"], m.edge_mlp,
        m.root, m.bias, g["mask"], torch.relu, "mean", mode, None, None,
        None, flag, 64) for flag in (False, True)]
    assert torch.equal(outs[0], outs[1])
    for model in (KernelNN(6, 6, 2, in_width=6, out_width=6, mode=mode),
                  TEECNet(6, 6, 6, num_layers=2, mode=mode)):
        args = (g["x"], g["senders"], g["receivers"], g["edge_attr"],
                g["mask"])
        with torch.no_grad():
            assert torch.equal(model.apply(*args),
                               with_edges_sorted(model).apply(*args))


def test_models_carry_edges_sorted_as_jax():
    """The field's name and default follow JAX's models; the serving view
    sets it on a copy that shares the parameters."""
    for jcls, cls in ((JKernelNN, KernelNN), (JTEECNet, TEECNet)):
        jdefault = {f.name: f.default
                    for f in jcls.__dataclass_fields__.values()}
        assert jdefault["edges_sorted"] is False
        assert inspect.signature(cls).parameters["edges_sorted"].default is False
    m = KernelNN(6, 6, 2, in_width=6, out_width=6)
    view = with_edges_sorted(m)
    assert view.edges_sorted and not m.edges_sorted
    assert view.fc1.weight is m.fc1.weight
    plain = torch.nn.Linear(2, 2)
    assert with_edges_sorted(plain) is plain
