"""Latent-space classifiers (clusterers) for expert routing.

Parity target: the JAX package's ``sched/classifiers.py`` (numpy, so this is
a copy of its algorithms), itself the reference's models/classifier.py
without sklearn:

- KMeansClassifier (:33-54): StandardScaler + k-means (k-means++ init,
  Lloyd) from a seeded ``np.random.Generator``.
- MeanShiftClassifier (:57-80): flat-kernel mean shift with auto bandwidth,
  cluster_all semantics (every point assigned to the nearest mode).
- GaussianMixtureClassifier (:83-104): full-covariance EM.
- WassersteinKMeansClassifier (:107-236): k-means++ and Lloyd under the 1D
  Wasserstein distance (the mean absolute difference of sorted values).

State persists as ``.npz`` under the reference's file names
(``kmeans_classifier.npz``, ``kmeans_scaler.npz``, ...).  A collection the
JAX package wrote holds ``.joblib`` files instead; they are read through
joblib where it is installed (``core.checkpoint.load_state``).
"""

from __future__ import annotations

import inspect
import os

import numpy as np

from ..core.checkpoint import load_state, save_state


class StandardScaler:
    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        self.mean_ = x.mean(axis=0)
        self.scale_ = x.std(axis=0)
        self.scale_ = np.where(self.scale_ > 0, self.scale_, 1.0)
        return (x - self.mean_) / self.scale_

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean_) / self.scale_


class Classifier:
    files = ("classifier", "scaler")  # file stems in the collection dir

    def __init__(self, n_clusters: int | None):
        self.n_clusters = n_clusters
        self.scaler = StandardScaler()

    def train(self, data, save_model: bool = False, path: str | None = None):
        raise NotImplementedError

    def cluster(self, data) -> np.ndarray:
        raise NotImplementedError

    def _save_model(self, path: str):
        save_state(os.path.join(path, self.files[0]), self._state())
        save_state(os.path.join(path, self.files[1]),
                   {"mean": self.scaler.mean_, "scale": self.scaler.scale_})

    def load_model(self, path: str):
        self._set_state(load_state(os.path.join(path, self.files[0])))
        d = load_state(os.path.join(path, self.files[1]))
        self.scaler.mean_ = np.asarray(d["mean"])
        self.scaler.scale_ = np.asarray(d["scale"])

    def _state(self) -> dict:
        raise NotImplementedError

    def _set_state(self, state: dict):
        raise NotImplementedError


def _kmeans_pp_init(x: np.ndarray, k: int, rng: np.random.Generator,
                    dist_fn) -> np.ndarray:
    centers = [x[rng.integers(len(x))]]
    for _ in range(1, k):
        d = np.min(np.stack([dist_fn(x, c[None]) for c in centers], 1), axis=1) ** 2
        if d.sum() <= 0.0:
            # all points coincide with a center (duplicate latents or
            # k >= distinct points): D^2 sampling is undefined, pick uniformly
            centers.append(x[rng.integers(len(x))])
            continue
        probs = d / d.sum()
        idx = min(np.searchsorted(np.cumsum(probs), rng.random()), len(x) - 1)
        centers.append(x[idx])
    return np.stack(centers)


def _euclidean(x: np.ndarray, c: np.ndarray) -> np.ndarray:
    return np.linalg.norm(x[:, None, :] - c[None, :, :], axis=2)


def _lloyd(x: np.ndarray, centers: np.ndarray, dist_fn, max_iter: int,
           tol: float, rng: np.random.Generator):
    for _ in range(max_iter):
        labels = np.argmin(dist_fn(x, centers), axis=1)
        new_centers = []
        for i in range(len(centers)):
            members = x[labels == i]
            new_centers.append(members.mean(axis=0) if len(members)
                               else x[rng.integers(len(x))])  # reseed (:197-198)
        new_centers = np.stack(new_centers)
        shift = np.linalg.norm(centers - new_centers)
        centers = new_centers
        if shift < tol:
            break
    return centers, np.argmin(dist_fn(x, centers), axis=1)


class KMeansClassifier(Classifier):
    files = ("kmeans_classifier", "kmeans_scaler")  # classifier.py:45-46

    def __init__(self, n_clusters: int, random_state: int = 0, max_iter: int = 300,
                 tol: float = 1e-4, n_init: int = 10):
        super().__init__(n_clusters)
        self.random_state, self.max_iter, self.tol, self.n_init = (
            random_state, max_iter, tol, n_init)
        self.centers_: np.ndarray | None = None

    def _fit(self, x: np.ndarray):
        rng = np.random.default_rng(self.random_state)
        best, best_inertia = None, np.inf
        for _ in range(self.n_init):
            c0 = _kmeans_pp_init(x, self.n_clusters, rng, _euclidean)
            centers, labels = _lloyd(x, c0, _euclidean, self.max_iter, self.tol, rng)
            inertia = np.sum((x - centers[labels]) ** 2)
            if inertia < best_inertia:
                best, best_inertia = centers, inertia
        self.centers_ = best

    def train(self, data, save_model: bool = False, path: str | None = None):
        x = self.scaler.fit_transform(np.asarray(data, np.float64))
        self._fit(x)
        if save_model:
            self._save_model(path)

    def cluster(self, data) -> np.ndarray:
        x = self.scaler.transform(np.asarray(data, np.float64))
        return np.argmin(_euclidean(x, self.centers_), axis=1)

    def _state(self):
        return {"centers": self.centers_, "n_clusters": self.n_clusters}

    def _set_state(self, s):
        self.centers_ = np.asarray(s["centers"])
        self.n_clusters = int(s["n_clusters"])


class MeanShiftClassifier(Classifier):
    files = ("mean_shift_classifier", "mean_shift_scaler")  # :71-72

    def __init__(self, bandwidth: float | None = None, max_iter: int = 300,
                 tol: float = 1e-3):
        super().__init__(n_clusters=None)
        self.bandwidth, self.max_iter, self.tol = bandwidth, max_iter, tol
        self.modes_: np.ndarray | None = None

    @staticmethod
    def _estimate_bandwidth(x: np.ndarray, quantile: float = 0.3) -> float:
        if len(x) < 2:  # no pairwise distances to estimate from
            return 1.0
        d = _euclidean(x, x)
        k = max(1, int(quantile * len(x)))
        knn = np.sort(d, axis=1)[:, 1:k + 1]
        return float(np.mean(knn.max(axis=1))) or 1.0

    def train(self, data, save_model: bool = False, path: str | None = None):
        x = self.scaler.fit_transform(np.asarray(data, np.float64))
        bw = self.bandwidth or self._estimate_bandwidth(x)
        pts = x.copy()
        for _ in range(self.max_iter):
            d = _euclidean(pts, x)
            w = (d <= bw).astype(np.float64)
            new = (w @ x) / np.maximum(w.sum(axis=1, keepdims=True), 1e-30)
            if np.linalg.norm(new - pts) < self.tol:
                pts = new
                break
            pts = new
        # merge modes closer than bandwidth/2
        modes: list[np.ndarray] = []
        for p in pts:
            if not any(np.linalg.norm(p - m) < bw / 2 for m in modes):
                modes.append(p)
        self.modes_ = np.stack(modes)
        self.n_clusters = len(modes)  # classifier.py:65-66
        if save_model:
            self._save_model(path)

    def cluster(self, data) -> np.ndarray:
        x = self.scaler.transform(np.asarray(data, np.float64))
        return np.argmin(_euclidean(x, self.modes_), axis=1)  # cluster_all=True

    def _state(self):
        return {"modes": self.modes_, "n_clusters": self.n_clusters}

    def _set_state(self, s):
        self.modes_ = np.asarray(s["modes"])
        self.n_clusters = int(s["n_clusters"])


class GaussianMixtureClassifier(Classifier):
    files = ("gmm_classifier", "gmm_scaler")  # :95-96

    def __init__(self, n_clusters: int, random_state: int = 0, max_iter: int = 100,
                 tol: float = 1e-3, reg: float = 1e-6):
        super().__init__(n_clusters)
        self.random_state, self.max_iter, self.tol, self.reg = (
            random_state, max_iter, tol, reg)

    def _log_prob(self, x):
        k, d = self.means_.shape
        out = np.zeros((len(x), k))
        for i in range(k):
            diff = x - self.means_[i]
            cov = self.covs_[i] + self.reg * np.eye(d)
            sign, logdet = np.linalg.slogdet(cov)
            sol = np.linalg.solve(cov, diff.T).T
            out[:, i] = -0.5 * (np.sum(diff * sol, 1) + logdet + d * np.log(2 * np.pi))
        return out + np.log(self.weights_ + 1e-300)

    def train(self, data, save_model: bool = False, path: str | None = None):
        x = self.scaler.fit_transform(np.asarray(data, np.float64))
        k, d = self.n_clusters, x.shape[1]
        km = KMeansClassifier(k, random_state=self.random_state, n_init=1)
        km.scaler.fit_transform(x)  # identity-ish rescale; reuse centers only
        km._fit(km.scaler.transform(x))
        self.means_ = km.centers_ * km.scaler.scale_ + km.scaler.mean_
        self.covs_ = np.stack([np.cov(x.T) + self.reg * np.eye(d)] * k)
        self.weights_ = np.full(k, 1.0 / k)
        prev_ll = -np.inf
        for _ in range(self.max_iter):
            lp = self._log_prob(x)
            mx = lp.max(axis=1, keepdims=True)
            resp = np.exp(lp - mx)
            resp /= resp.sum(axis=1, keepdims=True)
            ll = float(np.mean(mx[:, 0] + np.log(np.exp(lp - mx).sum(1))))
            nk = resp.sum(axis=0) + 1e-10
            self.weights_ = nk / len(x)
            self.means_ = (resp.T @ x) / nk[:, None]
            for i in range(k):
                diff = x - self.means_[i]
                self.covs_[i] = (resp[:, i][:, None] * diff).T @ diff / nk[i]
            if abs(ll - prev_ll) < self.tol:
                break
            prev_ll = ll
        if save_model:
            self._save_model(path)

    def cluster(self, data) -> np.ndarray:
        x = self.scaler.transform(np.asarray(data, np.float64))
        return np.argmin(-self._log_prob(x), axis=1)

    def _state(self):
        return {"means": self.means_, "covs": self.covs_, "weights": self.weights_,
                "n_clusters": self.n_clusters}

    def _set_state(self, s):
        self.means_, self.covs_, self.weights_ = (
            np.asarray(s[k]) for k in ("means", "covs", "weights"))
        self.n_clusters = int(s["n_clusters"])


def wasserstein_1d_matrix(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """W1 distances between each row of x and each center (rows as 1D samples).

    For equal-length unweighted samples, scipy's wasserstein_distance(u, v)
    equals mean(|sort(u) - sort(v)|); this vectorizes the reference's
    per-pair loop (classifier.py:167-186) into one broadcast.
    """
    xs = np.sort(x, axis=1)
    cs = np.sort(centers, axis=1)
    return np.mean(np.abs(xs[:, None, :] - cs[None, :, :]), axis=2)


class WassersteinKMeansClassifier(KMeansClassifier):
    files = ("wasserstein_kmeans_classifier",
             "wasserstein_kmeans_scaler")  # :119-120

    def _fit(self, x: np.ndarray):
        rng = np.random.default_rng(self.random_state)
        c0 = _kmeans_pp_init(x, self.n_clusters, rng, wasserstein_1d_matrix)
        # Lloyd with W1 assignment + coordinate-mean update (classifier.py:191-203)
        self.centers_, _ = _lloyd(x, c0, wasserstein_1d_matrix,
                                  self.max_iter, self.tol, rng)

    def cluster(self, data) -> np.ndarray:
        x = self.scaler.transform(np.asarray(data, np.float64))
        return np.argmin(wasserstein_1d_matrix(x, self.centers_), axis=1)


CLASSIFIERS = {"kmeans": KMeansClassifier, "mean_shift": MeanShiftClassifier,
               "gmm": GaussianMixtureClassifier,
               "wasserstein": WassersteinKMeansClassifier}


def init_classifier(type: str, n_clusters: int, **kwargs) -> Classifier:
    """Classifier factory (reference utils.py:66-74 + 'gmm').

    Exp-config keys matching a constructor parameter (random_state,
    max_iter, bandwidth, n_init, ...) are forwarded; the rest of the config
    dict is ignored."""
    cls = CLASSIFIERS.get(type)
    if cls is None:
        raise ValueError(f"Invalid classifier type: {type}")
    accepted = set(inspect.signature(cls.__init__).parameters) - {
        "self", "n_clusters"}
    kw = {k: v for k, v in kwargs.items() if k in accepted}
    if cls is MeanShiftClassifier:  # no n_clusters (mode-seeking)
        return cls(**kw)
    return cls(n_clusters=n_clusters, **kw)


def classifier_from_jax(clf) -> Classifier:
    """The port's copy of a JAX-package classifier (same class name): its
    hyperparameters, fitted arrays and scaler, as numpy."""
    cls = {c.__name__: c for c in CLASSIFIERS.values()}[type(clf).__name__]
    out = cls.__new__(cls)
    out.__dict__.update({k: v for k, v in vars(clf).items() if k != "scaler"})
    out.scaler = StandardScaler()
    out.scaler.__dict__.update(vars(clf.scaler))
    return out
