"""Port of core/graph.py: padding, bucketing and merging give the JAX
package's arrays exactly (same values, same dtypes)."""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import make_random_graph
from fast_eng_super_resolution_tpu.core import graph as jg
from fast_eng_super_resolution_tpu_torch.core import graph as tg


def _assert_same(a, b):
    for f in dataclasses.fields(tg.Graph):
        x, y = np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))
        np.testing.assert_array_equal(x, y, err_msg=f.name)
        assert x.dtype == y.dtype, f.name


@pytest.mark.parametrize("uniform", [True, False])
def test_pad_and_bucket_and_merge_match_jax(uniform):
    rng = np.random.default_rng(0)
    raws = [make_random_graph(rng, n=n, e=e) for n, e in
            ((50, 300), (255, 1024), (300, 2000))]
    raws[1]["global_ids"] = np.arange(255, dtype=np.int64) * 3
    spec = tg.BucketSpec(node_multiple=128, edge_multiple=512,
                         min_nodes=128, min_edges=512)
    jspec = jg.BucketSpec(node_multiple=128, edge_multiple=512,
                          min_nodes=128, min_edges=512)
    got = tg.pad_and_bucket(raws, spec, uniform=uniform)
    ref = jg.pad_and_bucket(raws, jspec, uniform=uniform, to_device=False)
    assert len(got) == len(ref)
    for (gk, gi, gb), (rk, ri, rb) in zip(got, ref):
        assert gk == rk and list(gi) == list(ri)
        _assert_same(gb, rb)
        gm, gids = tg.merge_batch(gb)
        rm, rids = jg.merge_batch(rb)
        _assert_same(gm, rm)
        np.testing.assert_array_equal(gids, rids)
        # the device form of merge_batch gives the same arrays
        tm, tids = tg.merge_batch(gb.to_torch("cpu"))
        assert isinstance(tm.senders, torch.Tensor)
        _assert_same(tm.map(lambda t: t.numpy()), gm)
        np.testing.assert_array_equal(tids.numpy(), gids)


def test_bucket_spec_and_pad_invariants():
    for n, e in ((0, 0), (255, 1000), (256, 1025), (1000, 9000)):
        assert tg.BucketSpec().bucket_for(n, e) == jg.BucketSpec().bucket_for(n, e)
        n_pad, _ = tg.BucketSpec().bucket_for(n, e)
        assert n_pad > n  # always one padded node
    rng = np.random.default_rng(1)
    raw = make_random_graph(rng, n=40, e=200)
    g = tg.pad_graph(raw["x"], raw["y"], raw["pos"], raw["senders"],
                     raw["receivers"], raw["edge_attr"], 64, 256)
    r = jg.pad_graph(raw["x"], raw["y"], raw["pos"], raw["senders"],
                     raw["receivers"], raw["edge_attr"], 64, 256)
    _assert_same(g, r)
    assert np.all(np.diff(g.receivers[:200]) >= 0)  # real edges receiver-sorted
    assert np.all(g.senders[200:] == 63) and np.all(g.receivers[200:] == 63)
    assert np.all(g.edge_attr[200:] == 1.0)
    with pytest.raises(ValueError, match="padded edges need a padded node"):
        tg.pad_graph(raw["x"], raw["y"], raw["pos"], raw["senders"],
                     raw["receivers"], raw["edge_attr"], 40, 256)


def test_num_real_nodes_matches_jax():
    """``Graph.num_real_nodes``: the int32 count of real nodes along the
    last axis, as JAX's property gives it, for one graph and for a
    [B, ...] batch, on the host and as torch tensors."""
    rng = np.random.default_rng(2)
    raws = [make_random_graph(rng, n=n, e=4 * n) for n in (50, 90, 120)]
    spec = dict(node_multiple=128, edge_multiple=512, min_nodes=128,
                min_edges=512)
    (_, _, batch), = tg.pad_and_bucket(raws, tg.BucketSpec(**spec))
    (_, _, jbatch), = jg.pad_and_bucket(raws, jg.BucketSpec(**spec),
                                        to_device=False)
    jsingle = jg.Graph(**{f.name: np.asarray(getattr(jbatch, f.name))[1]
                          for f in dataclasses.fields(jg.Graph)})
    for got, ref in ((batch, jbatch), (batch.map(lambda a: a[1]), jsingle)):
        want = np.asarray(ref.num_real_nodes)
        host = got.num_real_nodes
        dev = got.to_torch("cpu").num_real_nodes
        assert host.dtype == np.int32 and dev.dtype == torch.int32
        np.testing.assert_array_equal(host, want)
        np.testing.assert_array_equal(dev.numpy(), want)
    np.testing.assert_array_equal(batch.num_real_nodes, [50, 90, 120])
