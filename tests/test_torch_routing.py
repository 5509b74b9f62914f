"""The port's routing modules on the CPU against the JAX package: encoders
(PCA, Spectrum, DMD, VAE), classifiers (k-means, mean shift, GMM,
Wasserstein k-means), their ``.npz`` state and the JAX package's
``.joblib`` state, the scheduler's expert subsets, the routed ``apply``
and the label check.

PCA, Spectrum, DMD and the classifiers are numpy copies of numpy code, so
their latents and labels must be equal, not close.  The VAE is JAX + optax
there and torch here: its encode/decode must agree within 1e-5 on the
same weights and the same eps (float32 MLPs of width 16, sums in other
orders).
"""

import ast
import os
import sys

import numpy as np
import pytest
import torch

import jax

from fast_eng_super_resolution_tpu.data.dataset import SyntheticDataset as JSynthetic
from fast_eng_super_resolution_tpu.models.registry import init_model as jinit
from fast_eng_super_resolution_tpu.sched import classifiers as jcls
from fast_eng_super_resolution_tpu.sched import encoders as jenc
from fast_eng_super_resolution_tpu.sched.scheduler import PartitionScheduler as JSched
from fast_eng_super_resolution_tpu_torch.core.graph import pad_graph, stack_graphs
from fast_eng_super_resolution_tpu_torch.models.registry import init_model
from fast_eng_super_resolution_tpu_torch.parallel.dispatch import routed_apply
from fast_eng_super_resolution_tpu_torch.sched import (PartitionScheduler,
                                                       routing_from_jax)
from fast_eng_super_resolution_tpu_torch.sched import classifiers as tcls
from fast_eng_super_resolution_tpu_torch.sched import encoders as tenc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DS_KW = dict(sub_size=4, n_high=(16, 8, 8), n_low=(8, 4, 4), num_cases=3)
VAE_KW = dict(input_dim=4, hidden_dim=16, num_layers=2, epochs=1, seed=3)
VAE_TOL = 1e-5
CLASSIFIERS = ("kmeans", "mean_shift", "gmm", "wasserstein")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return JSynthetic(root=str(tmp_path_factory.mktemp("jds")), **DS_KW)


@pytest.fixture(scope="module")
def subdomains(dataset):
    return [dataset.get(i) for i in range(len(dataset))]


def _blobs(seed=0, k=3, n=60, d=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 3
    return centers[np.repeat(np.arange(k), n // k)] + 0.3 * rng.normal(size=(n, d))


@pytest.mark.parametrize("name", CLASSIFIERS)
def test_classifier_labels_equal_jax(name, tmp_path):
    x, new = _blobs(0), _blobs(1)
    ref = jcls.init_classifier(name, n_clusters=3, max_iter=50)
    got = tcls.init_classifier(name, n_clusters=3, max_iter=50)
    ref.train(x)
    got.train(x)
    np.testing.assert_array_equal(got.cluster(x), ref.cluster(x))
    np.testing.assert_array_equal(got.cluster(new), ref.cluster(new))
    assert got.n_clusters == ref.n_clusters
    # the fitted state carried across routes new points as JAX does
    _, copied = routing_from_jax(jenc.DMDEncoder(2), ref)
    assert type(copied) is type(got)
    np.testing.assert_array_equal(copied.cluster(new), ref.cluster(new))
    # .npz state round-trips under the reference's file stems
    got._save_model(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == sorted(f + ".npz" for f in got.files)
    back = tcls.init_classifier(name, n_clusters=3)
    back.load_model(str(tmp_path))
    np.testing.assert_array_equal(back.cluster(new), got.cluster(new))


@pytest.mark.parametrize("name", ["pca", "spectrum", "dmd"])
def test_encoder_latents_equal_jax(name, subdomains, tmp_path):
    kw = dict(grid_resolution=(8, 8, 8)) if name == "spectrum" else {}
    ref = jenc.init_encoder(name, n_components=2, **kw)
    got = tenc.init_encoder(name, n_components=2, **kw)
    train, serve = subdomains[:8], subdomains[4:]
    ref.train(train)
    got.train(train, save_model=True, path=str(tmp_path))
    want = ref.get_latent_space(serve)
    np.testing.assert_array_equal(got.get_latent_space(serve), want)
    copied, _ = routing_from_jax(ref, jcls.KMeansClassifier(2))
    np.testing.assert_array_equal(copied.get_latent_space(serve), want)
    if name == "pca":  # the only stateful one of the three
        assert os.listdir(tmp_path) == ["pca_encoder.npz"]
        back = tenc.init_encoder(name, n_components=5)
        back.load_model(str(tmp_path))
        np.testing.assert_array_equal(back.get_latent_space(serve), want)


def test_vae_matches_jax_on_carried_params(subdomains, tmp_path):
    ref = jenc.VAEEncoder(n_components=2, **VAE_KW)
    ref.train(subdomains[:3])
    got, _ = routing_from_jax(ref, jcls.KMeansClassifier(2))
    x = np.asarray(subdomains[0]["x"], np.float32)
    eps = np.random.default_rng(5).normal(size=(x.shape[0], 2)).astype(np.float32)
    mu, logvar = ref._encode(ref.params, x)
    z = mu + eps * np.exp(0.5 * np.asarray(logvar))
    x_hat = np.asarray(ref._decode(ref.params, z))
    with torch.no_grad():
        tmu, tlogvar = got.net.encode(torch.as_tensor(x))
        tz = tmu + torch.as_tensor(eps) * torch.exp(0.5 * tlogvar)
        tx_hat = got.net.decode(tz).numpy()
    for a, b in ((tmu.numpy(), mu), (tlogvar.numpy(), logvar), (tz.numpy(), z),
                 (tx_hat, x_hat)):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= VAE_TOL * max(np.abs(b).max(), 1.0)
    # the pooled latent with a given eps (and with eps = 0: the pooled mu)
    lat = got.get_latent_space(subdomains[:1], eps=[eps])
    np.testing.assert_allclose(lat[0], np.asarray(z).mean(0), rtol=0,
                               atol=VAE_TOL)
    zero = got.get_latent_space(subdomains[:1],
                                eps=[np.zeros_like(eps)])
    np.testing.assert_allclose(zero[0], np.asarray(mu).mean(0), rtol=0,
                               atol=VAE_TOL)
    # the port's own training: seeded, finite, and its state round-trips
    own = tenc.VAEEncoder(n_components=2, **VAE_KW)
    own.train(subdomains[:3], save_model=True, path=str(tmp_path))
    again = tenc.VAEEncoder(n_components=2, **VAE_KW)
    again.train(subdomains[:3])
    lat = own.get_latent_space(subdomains[:4])
    assert lat.shape == (4, 2) and np.isfinite(lat).all()
    np.testing.assert_array_equal(again.get_latent_space(subdomains[:4]), lat)
    back = tenc.VAEEncoder(n_components=2, **VAE_KW)
    back.load_model(str(tmp_path))
    np.testing.assert_array_equal(back.get_latent_space(subdomains[:4]), lat)


def test_reads_jax_joblib_state(subdomains, tmp_path, monkeypatch):
    """A collection the JAX package wrote (``.joblib``) is read through
    joblib; without joblib the error names the file; with no state at all
    the error names both files tried."""
    path = str(tmp_path)
    data = subdomains[:8]
    enc, clf = jenc.PCAEncoder(n_components=2), jcls.KMeansClassifier(2)
    enc.train(data, save_model=True, path=path)
    clf.train(enc.get_latent_space(data), save_model=True, path=path)
    vae = jenc.VAEEncoder(n_components=2, **VAE_KW)
    vae.train(data[:2], save_model=True, path=path)
    got_enc, got_clf = tenc.PCAEncoder(2), tcls.KMeansClassifier(2)
    got_enc.load_model(path)
    got_clf.load_model(path)
    lat = got_enc.get_latent_space(data)
    np.testing.assert_array_equal(lat, enc.get_latent_space(data))
    np.testing.assert_array_equal(got_clf.cluster(lat),
                                  clf.cluster(enc.get_latent_space(data)))
    got_vae = tenc.VAEEncoder(n_components=2, **VAE_KW)
    got_vae.load_model(path)
    x = np.asarray(data[0]["x"], np.float32)
    with torch.no_grad():
        mu = got_vae.net.encode(torch.as_tensor(x))[0].numpy()
    ref_mu = np.asarray(vae._encode(vae.params, x)[0])
    assert np.abs(mu - ref_mu).max() <= VAE_TOL * max(np.abs(ref_mu).max(), 1)
    monkeypatch.setitem(sys.modules, "joblib", None)
    with pytest.raises(RuntimeError, match="pca_encoder.joblib.*re-save"):
        tenc.PCAEncoder(2).load_model(path)
    with pytest.raises(FileNotFoundError, match="gmm_classifier"):
        tcls.GaussianMixtureClassifier(2).load_model(path)


def test_no_port_module_imports_joblib_at_module_level():
    port = os.path.join(REPO, "fast_eng_super_resolution_tpu_torch")
    found = []
    for root, _, names in os.walk(port):
        for f in names:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(root, f)).read())
            for node in tree.body:  # top-level statements only
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import)
                        else [node.module or ""]
                        if isinstance(node, ast.ImportFrom) else [])
                found += [(f, m) for m in mods if m.split(".")[0] == "joblib"]
    assert not found, found


def test_subset_indices_equal_jax(dataset, tmp_path, capsys):
    model_kw = dict(width=8, num_layers=2)
    ref = JSched("r", 2, dataset, jinit("neuralop", 4, 4, **model_kw),
                 train=True, encoder=jenc.PCAEncoder(n_components=2),
                 classifier=jcls.KMeansClassifier(2),
                 log_dir=str(tmp_path / "jax"), use_mesh=False)
    capsys.readouterr()
    got = PartitionScheduler("r", 2, dataset,
                             init_model("neuralop", 4, 4, **model_kw),
                             train=True, encoder=tenc.PCAEncoder(2),
                             classifier=tcls.KMeansClassifier(2),
                             log_dir=str(tmp_path / "port"), device="cpu")
    out = capsys.readouterr().out
    assert len(got.subset_indices) == 2
    for a, b in zip(got.subset_indices, ref.subset_indices):
        np.testing.assert_array_equal(a, b)
    assert all(a.size for a in got.subset_indices)  # both experts get data
    for i, sub in enumerate(got.get_sub_dataset()):
        assert f"Partition {i}: {len(sub)} samples" in out
        assert [sub.get(j)["x"].shape for j in range(len(sub))] == [
            dataset.get(int(k))["x"].shape for k in got.subset_indices[i]]
    coll = tmp_path / "port" / "models" / "collection_r"
    assert sorted(os.listdir(coll)) == ["kmeans_classifier.npz",
                                        "kmeans_scaler.npz", "pca_encoder.npz"]
    # serving loads the saved state (and both experts) and finds the same
    # subsets
    for i in range(2):
        got._save_model(i, got.model)
    served = PartitionScheduler("r", 2, dataset, got.model, train=False,
                                encoder=tenc.PCAEncoder(2),
                                classifier=tcls.KMeansClassifier(2),
                                log_dir=str(tmp_path / "port"), device="cpu")
    assert len(served.experts) == 2
    for a, b in zip(served.subset_indices, ref.subset_indices):
        np.testing.assert_array_equal(a, b)


def test_routed_apply_equals_each_graph_through_its_expert(subdomains):
    """``routed_apply`` on a batch equals graph b through
    ``experts[labels[b]].apply`` alone, for every label pattern."""
    experts = [init_model("neuralop", 4, 4, width=8, num_layers=2, seed=s)
               for s in (1, 2, 3)]
    raw = subdomains[:5]
    n_pad = max(d["x"].shape[0] for d in raw) + 7
    e_pad = max(d["senders"].shape[0] for d in raw) + 9
    graphs = [pad_graph(d["x"], d["y"], d["pos"], d["senders"], d["receivers"],
                        d["edge_attr"], n_pad, e_pad) for d in raw]
    batch = stack_graphs(graphs)
    with torch.no_grad():
        for labels in ([0, 1, 2, 1, 0], [2, 2, 2, 2, 2], [1, 0, 0, 0, 0]):
            got = routed_apply(experts, np.array(labels),
                               batch.to_torch("cpu"))
            assert got.shape == (5, n_pad, 4)
            for g, k, out in zip(graphs, labels, got):
                t = g.to_torch("cpu")
                want = experts[k].apply(t.x, t.senders, t.receivers,
                                        t.edge_attr, edge_mask=t.edge_mask)
                torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)


def test_check_labels_raises(dataset, tmp_path):
    sched = PartitionScheduler("c", 2, dataset,
                               init_model("neuralop", 4, 4, width=8,
                                          num_layers=2),
                               train=True, encoder=tenc.DMDEncoder(2),
                               classifier=tcls.KMeansClassifier(2),
                               log_dir=str(tmp_path), device="cpu")
    sched._check_labels(np.array([0, 1, 1, 0]))
    sched._check_labels(np.array([], dtype=int))
    for bad in ([0, -1, 1], [0, 2, 1]):
        with pytest.raises(ValueError, match=r"outside \[0, 2\)"):
            sched._check_labels(np.array(bad))
    # a stale classifier with more clusters than experts is refused before
    # any expert is indexed
    sched.classifier = tcls.KMeansClassifier(3)
    sched.classifier.train(sched.encoder.get_latent_space(
        [dataset.get(i) for i in range(len(dataset))]))
    with pytest.raises(ValueError, match="stale routing model"):
        sched._route([dataset.get(i) for i in range(len(dataset))])
