"""Routed serving (two experts) and the coalesced lane on the CPU against the
JAX package: the routed ``predict`` (label-grouped fused chunks, and the
general path's routed ``apply``), the routed one-dispatch lane with its
edge-budget demotion, and ``predict_full_batch``.

Both packages serve the same collection: the JAX package fits and saves the
PCA encoder and the k-means classifier (``.joblib``, read by the port
through joblib) and writes both experts' checkpoints, which the port loads
through ``from_jax_params``.  The small duct at three cases routes mesh 0's
four subdomains to both experts.  The JAX side reaches its fused paths with
``FESR_FUSED_PREDICT=force`` (Pallas in interpret mode) on one device.

Tolerances, relative to the max: float32 on both sides, sums in other
orders through depth 2 and an overlap average, 1e-4; the default bf16 GEMM
inputs on both fused paths (or on the port's only, against JAX's float32
routed lane), 2e-2, JAX's own tolerance for its routed fused predict
against its XLA one (tests/test_scheduler.py).
"""

import os

import numpy as np
import pytest

import jax

from fast_eng_super_resolution_tpu.core import checkpoint as jckpt
from fast_eng_super_resolution_tpu.core.graph import BucketSpec
from fast_eng_super_resolution_tpu.data.dataset import SyntheticDataset as JSynthetic
from fast_eng_super_resolution_tpu.models.registry import init_model as jinit
from fast_eng_super_resolution_tpu.ops import fused_conv as jfc
from fast_eng_super_resolution_tpu.sched import classifiers as jcls
from fast_eng_super_resolution_tpu.sched import encoders as jenc
from fast_eng_super_resolution_tpu.sched.scheduler import PartitionScheduler as JSched
from fast_eng_super_resolution_tpu_torch.data.reconstruct import overlap_average
from fast_eng_super_resolution_tpu_torch.models.registry import init_model
from fast_eng_super_resolution_tpu_torch.sched import (PartitionScheduler,
                                                       routing_from_jax)

DS_KW = dict(sub_size=4, n_high=(16, 8, 8), n_low=(8, 4, 4), num_cases=3)
MODEL_KW = dict(width=8, num_layers=2)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return JSynthetic(root=str(tmp_path_factory.mktemp("jds")), **DS_KW)


@pytest.fixture(scope="module")
def log_dir(dataset, tmp_path_factory):
    """A routed collection ("routed": the JAX package's encoder and
    classifier state, two experts) and a single-expert one ("single")."""
    d = str(tmp_path_factory.mktemp("logs"))
    JSched("routed", 2, dataset, jinit("neuralop", 4, 4, **MODEL_KW),
           train=True, encoder=jenc.PCAEncoder(n_components=2),
           classifier=jcls.KMeansClassifier(2), log_dir=d, use_mesh=False)
    model = jinit("neuralop", 4, 4, **MODEL_KW)
    for exp, i in (("routed", 0), ("routed", 1), ("single", 0)):
        params = jax.tree_util.tree_map(
            np.asarray, model.init(jax.random.PRNGKey(3 + i)))
        jckpt.save_params(os.path.join(d, "models", f"collection_{exp}",
                                       f"partition_{i}.npz"),
                          params, meta={"model": "KernelNN"})
    return d


@pytest.fixture
def jax_fused_f32(monkeypatch):
    """Runs the JAX fused layer with float32 GEMM inputs (its serving paths
    pass no gemm_dtype, so the default bf16 is swapped here)."""
    orig = jfc.fused_edge_conv

    def f32(*args, **kwargs):
        kwargs["gemm_dtype"] = "float32"
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfc, "fused_edge_conv", f32)


def _schedulers(dataset, log_dir, exp="routed", gemm_dtype="float32"):
    n = 2 if exp == "routed" else 1
    kw = {}
    if n == 2:
        kw = dict(encoder=jenc.PCAEncoder(n_components=2),
                  classifier=jcls.KMeansClassifier(2))
    js = JSched(exp, n, dataset, jinit("neuralop", 4, 4, **MODEL_KW),
                train=False, log_dir=log_dir, use_mesh=False, **kw)
    if n == 2:  # the port's copies; loading the saved state overwrites them
        kw = dict(zip(("encoder", "classifier"),
                      routing_from_jax(js.encoder, js.classifier)))
    ts = PartitionScheduler(exp, n, dataset,
                            init_model("neuralop", 4, 4, **MODEL_KW),
                            train=False, log_dir=log_dir, device="cpu",
                            gemm_dtype=gemm_dtype, **kw)
    return js, ts


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _e_pad(x):
    return BucketSpec().bucket_for(max(d["x"].shape[0] for d in x),
                                   max(d["senders"].shape[0] for d in x))[1]


@pytest.mark.parametrize("chunk", [None, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routed_predict_matches_jax(dtype, chunk, dataset, log_dir,
                                    monkeypatch, request):
    """The fused routed predict (label groups cut into chunks of ``chunk``
    subdomains, a short group padded by repeating its last subdomain)."""
    if dtype == "float32":
        request.getfixturevalue("jax_fused_f32")
    monkeypatch.setenv("FESR_FUSED_PREDICT", "force")
    js, ts = _schedulers(dataset, log_dir, gemm_dtype=dtype)
    for idx in (0, 1):
        x = dataset.get_one_full_sample(idx)
        if chunk is not None:
            monkeypatch.setenv("FESR_PREDICT_EDGE_BUDGET",
                               str(chunk * _e_pad(x)))
        jp, jr, jm, jw = js.predict(x)
        tp, tr, tm, tw = ts.predict(x)
        np.testing.assert_array_equal(tm, jm)
        if idx == 0:
            assert sorted(set(tm)) == [0, 1]  # both experts serve mesh 0
        for a, b in zip(tp, jp):
            assert _rel(a, b) < TOL[dtype]
        for a, b in zip(tr, jr):
            np.testing.assert_array_equal(a, np.asarray(b))
        for a, b in zip(tw, jw):
            assert _rel(a, b) < TOL[dtype]


def test_general_routed_predict_matches_jax(dataset, log_dir, monkeypatch):
    """``FESR_FUSED_PREDICT=0``: the stacked-expert vmapped ``apply`` of the
    JAX package against the port's ``routed_apply``, float32."""
    monkeypatch.setenv("FESR_FUSED_PREDICT", "0")
    js, ts = _schedulers(dataset, log_dir)
    x = dataset.get_one_full_sample(0)
    jp, _, jm, jw = js.predict(x)
    tp, _, tm, tw = ts.predict(x)
    np.testing.assert_array_equal(tm, jm)
    for a, b in zip(tp + tw, jp + jw):
        assert _rel(a, b) < TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routed_lane_matches_jax(dtype, dataset, log_dir, monkeypatch):
    """``predict_full`` on a routed scheduler: JAX's routed lane (its XLA
    ``apply``, float32) against the port's (the fused layer per label
    group)."""
    monkeypatch.setenv("FESR_FUSED_PREDICT", "force")
    js, ts = _schedulers(dataset, log_dir, gemm_dtype=dtype)
    for idx in (0, 1):
        x = dataset.get_one_full_sample(idx)
        n = len(dataset.full_mesh(idx)["points"])
        jpred, jref = js.predict_full(x, n)
        tpred, tref = ts.predict_full(x, n)
        assert ts.last_lane == js.last_lane == ("routed",
                                                "2 experts, routed lane")
        assert np.isfinite(tpred).all() and tpred.shape == jpred.shape
        assert _rel(tpred, jpred) < TOL[dtype]
        assert _rel(tref, jref) < 1e-6
        # warm: the cached group operands give the same bits
        np.testing.assert_array_equal(ts.predict_full(x, n)[0], tpred)


def test_routed_lane_demotes_over_budget(dataset, log_dir, monkeypatch):
    monkeypatch.setenv("FESR_FUSED_PREDICT", "force")
    x = dataset.get_one_full_sample(0)
    monkeypatch.setenv("FESR_PREDICT_EDGE_BUDGET", str(_e_pad(x)))
    js, ts = _schedulers(dataset, log_dir)
    n = len(dataset.full_mesh(0)["points"])
    assert js.predict_full(x, n) is None
    assert ts.predict_full(x, n) is None
    assert ts.last_lane == js.last_lane == (
        "general", "routed lane demoted (edge budget)")


def test_fused_routed_predict_matches_general(dataset, log_dir, monkeypatch):
    """The port's fused routed predict against its general one
    (``routed_apply``), and its routed lane against the general predict
    plus the host overlap average, all float32."""
    _, ts = _schedulers(dataset, log_dir)
    x = dataset.get_one_full_sample(0)
    n = len(dataset.full_mesh(0)["points"])
    fp, fr, fm, fw = ts.predict(x)
    lane = ts.predict_full(x, n)
    monkeypatch.setenv("FESR_FUSED_PREDICT", "0")
    gp, gr, gm, gw = ts.predict(x)
    np.testing.assert_array_equal(fm, gm)
    for a, b in zip(fp + fw, gp + gw):
        assert _rel(a, b) < TOL["float32"]
    for a, b in zip(fr, gr):
        np.testing.assert_array_equal(a, b)
    gids = [d["global_node_ids"] for d in x]
    assert _rel(lane[0], overlap_average(gp, gids, n)) < TOL["float32"]
    assert _rel(lane[1], overlap_average(gr, gids, n)) < 1e-6


def test_predict_full_batch(dataset, log_dir, jax_fused_f32, monkeypatch):
    """R = 3 payloads on one geometry equal 3 single ``predict_full`` calls
    bit for bit and JAX's coalesced lane within 1e-4; differing geometry, a
    routed scheduler, a disabled fused path and the edge budget each give
    None with the JAX package's lane and reason."""
    monkeypatch.setenv("FESR_FUSED_PREDICT", "force")
    js, ts = _schedulers(dataset, log_dir, exp="single")
    x = dataset.get_one_full_sample(0)
    n = len(dataset.full_mesh(0)["points"])
    reqs = [[dict(d, x=np.asarray(d["x"]) * (1.0 + 0.1 * i),
                  y=np.asarray(d["y"]) * (1.0 - 0.05 * i)) for d in x]
            for i in range(3)]
    got = ts.predict_full_batch(reqs, n)
    assert ts.last_lane == ("coalesced", "3 requests, one dispatch")
    want = js.predict_full_batch(reqs, n)
    assert len(got) == len(want) == 3
    for i, ((pb, rb), (jpb, jrb)) in enumerate(zip(got, want)):
        ps, rs = ts.predict_full(reqs[i], n)
        np.testing.assert_array_equal(pb, ps)
        np.testing.assert_array_equal(rb, rs)
        assert _rel(pb, jpb) < TOL["float32"]
        assert _rel(rb, jrb) < 1e-6
    assert ts.predict_full_batch([], n) == []

    def both_refuse(requests, scheds=(js, ts)):
        for s in scheds:
            assert s.predict_full_batch(requests, n) is None
        assert scheds[0].last_lane == scheds[1].last_lane
        return scheds[1].last_lane

    other = [dict(d, edge_attr=np.asarray(d["edge_attr"]) * 1.5)
             for d in reqs[0]]
    assert both_refuse([reqs[0], other]) == ("per-request",
                                             "request geometries differ")
    assert both_refuse(reqs, _schedulers(dataset, log_dir)) == (
        "per-request",
        "routed scheduler: coalescing unsupported, serving per-request")
    monkeypatch.setenv("FESR_PREDICT_EDGE_BUDGET", "10")
    assert both_refuse(reqs) == ("general", "edge budget exceeded")
    monkeypatch.setenv("FESR_FUSED_PREDICT", "0")
    assert both_refuse(reqs) == (
        "per-request", "fused predict disabled (FESR_FUSED_PREDICT=0)")
