"""Subdomain encoders: flow fields -> latent vectors for expert routing.

Parity target: the JAX package's ``sched/encoders.py``, itself the
reference's models/encoder.py:

- PCAEncoder (:96-160): each subdomain's node features truncated (or
  zero-padded) to the fit-time length, then an exact SVD fit/transform —
  numpy, copied.  The length is applied per row, so a subdomain's latent
  does not depend on which other subdomains share the request.
- VAEEncoder (TBVAE, :25-201): an MLP VAE trained per subdomain on MSE + KLD
  with Adam.  The JAX package writes it in JAX and optax; here it is an
  ``nn.Module`` trained with ``torch.optim.Adam``, every random draw (init,
  dropout, eps) from a ``torch.Generator`` seeded from ``seed``.  The draws
  differ from jax.random's; weights carry across through the JAX package's
  parameter tree (``encoder_from_jax``).
- SpectrumEncoder (:204-364): turbulent-kinetic-energy spectrum latents
  (scattered nodes -> regular grid -> 3D FFT -> shell sums) — numpy, copied.
- DMDEncoder: the leading singular values of each subdomain's feature
  matrix (the reference leaves the class empty, :367-385) — numpy, copied.

Every encoder runs on the host: routing is per subdomain and tiny beside
the experts.  State persists as ``.npz`` (``pca_encoder.npz``,
``vae_encoder.npz``); a JAX-written ``.joblib`` is read through joblib where
it is installed (``core.checkpoint.load_state``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ..core.checkpoint import flatten_params, load_state, save_state, unflatten_params
from ..models.common import linear_init


def _collect_node_features(dataset) -> list[np.ndarray]:
    out = []
    for data in dataset:
        x = data["x"] if isinstance(data, dict) else np.asarray(data.x)
        out.append(np.asarray(x, np.float32))
    return out


class Encoder:
    def __init__(self, n_components: int, **kwargs):
        self.n_components = n_components

    def train(self, dataset, save_model: bool = False, path: str | None = None):
        pass

    def get_latent_space(self, dataset) -> np.ndarray:
        raise NotImplementedError

    def load_model(self, path: str):
        pass


class PCAEncoder(Encoder):
    def __init__(self, n_components: int, **kwargs):
        super().__init__(n_components)
        self.mean_: np.ndarray | None = None
        self.components_: np.ndarray | None = None
        self.min_length: int | None = None

    def _flatten(self, feats: list[np.ndarray]) -> np.ndarray:
        """At train time the row length is the batch minimum (reference
        behavior, encoder.py:134-139).  At transform time it is the fit-time
        min_length, applied per row (truncate long, zero-pad short)."""
        if self.min_length is None:
            min_len = min(f.shape[0] for f in feats)
        else:
            min_len = self.min_length
        rows = []
        for f in feats:
            row = f[:min_len]
            if row.shape[0] < min_len:
                row = np.pad(row, ((0, min_len - row.shape[0]), (0, 0)))
            rows.append(row.reshape(-1))
        return np.stack(rows), min_len

    def train(self, dataset, save_model: bool = False, path: str | None = None):
        feats = _collect_node_features(dataset)
        mat, self.min_length = self._flatten(feats)
        self.mean_ = mat.mean(axis=0)
        centered = mat - self.mean_
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
        self.components_ = vt[: self.n_components]
        if save_model:
            self._save_model(path)

    def get_latent_space(self, dataset) -> np.ndarray:
        feats = _collect_node_features(dataset)
        mat, _ = self._flatten(feats)
        width = self.mean_.shape[0]
        if mat.shape[1] != width:  # different subdomain sizes at predict time
            if mat.shape[1] > width:
                mat = mat[:, :width]
            else:
                mat = np.pad(mat, ((0, 0), (0, width - mat.shape[1])))
        return (mat - self.mean_) @ self.components_.T

    def _save_model(self, path: str):
        save_state(os.path.join(path, "pca_encoder"),  # encoder.py:141
                   {"mean": self.mean_, "components": self.components_,
                    "min_length": self.min_length,
                    "n_components": self.n_components})

    def load_model(self, path: str):
        d = load_state(os.path.join(path, "pca_encoder"))
        self.mean_ = np.asarray(d["mean"])
        self.components_ = np.asarray(d["components"])
        self.min_length = int(d["min_length"])
        self.n_components = int(d["n_components"])


class TBVAE(nn.Module):
    """The reference's TBVAE (encoder.py:25-93): an encoder MLP
    [input_dim, hidden x num_layers] with ReLU, linear heads for mu and
    logvar, and a decoder MLP [n_components, hidden x num_layers,
    input_dim]; inverted dropout after each hidden ReLU while training."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int,
                 n_components: int, generator: torch.Generator):
        super().__init__()
        skip = nn.utils.skip_init

        def mlp(sizes):
            return nn.ModuleList(skip(nn.Linear, a, b)
                                 for a, b in zip(sizes[:-1], sizes[1:]))

        h = hidden_dim
        self.enc = mlp([input_dim] + [h] * num_layers)
        self.mu = skip(nn.Linear, h, n_components)
        self.logvar = skip(nn.Linear, h, n_components)
        self.dec = mlp([n_components] + [h] * num_layers + [input_dim])
        for layer in (*self.enc, self.mu, self.logvar, *self.dec):
            linear_init(layer, generator)

    @staticmethod
    def _dropout(h, rate: float, generator):
        keep = 1.0 - rate
        mask = torch.rand(h.shape, generator=generator) < keep
        return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype))

    def encode(self, x, dropout: float = 0.0, generator=None):
        h = x
        for layer in self.enc:
            h = torch.relu(layer(h))
            if dropout > 0.0 and generator is not None:
                h = self._dropout(h, dropout, generator)
        return self.mu(h), self.logvar(h)

    def decode(self, z, dropout: float = 0.0, generator=None):
        h = z
        for layer in self.dec[:-1]:
            h = torch.relu(layer(h))
            if dropout > 0.0 and generator is not None:
                h = self._dropout(h, dropout, generator)
        return self.dec[-1](h)

    def jax_tree(self) -> dict:
        """The parameters as the JAX package's tree ({"w": [in, out], "b"}
        per layer)."""
        def lin(layer):
            return {"w": layer.weight.detach().numpy().T.copy(),
                    "b": layer.bias.detach().numpy().copy()}

        return {"enc": [lin(layer) for layer in self.enc], "mu": lin(self.mu),
                "logvar": lin(self.logvar),
                "dec": [lin(layer) for layer in self.dec]}

    def load_jax_tree(self, tree: dict) -> None:
        pairs = (list(zip(self.enc, tree["enc"]))
                 + [(self.mu, tree["mu"]), (self.logvar, tree["logvar"])]
                 + list(zip(self.dec, tree["dec"])))
        with torch.no_grad():
            for layer, p in pairs:
                layer.weight.copy_(torch.tensor(np.asarray(p["w"], np.float32).T))
                layer.bias.copy_(torch.tensor(np.asarray(p["b"], np.float32)))


class VAEEncoder(Encoder):
    """TBVAE latents: each subdomain's latent is the mean over its nodes of
    the reparameterized z = mu + eps * exp(logvar / 2) (encoder.py:189-201)."""

    def __init__(self, n_components: int, input_dim: int = 4, hidden_dim: int = 128,
                 num_layers: int = 3, dropout: float = 0.5, lr: float = 1e-3,
                 epochs: int = 30, seed: int = 0, **kwargs):
        super().__init__(n_components)
        self.input_dim, self.hidden_dim = input_dim, hidden_dim
        self.num_layers, self.dropout = num_layers, dropout
        self.lr, self.epochs, self.seed = lr, epochs, seed
        self.net: TBVAE | None = None

    def _build(self) -> TBVAE:
        return TBVAE(self.input_dim, self.hidden_dim, self.num_layers,
                     self.n_components, torch.Generator().manual_seed(self.seed))

    def train(self, dataset, save_model: bool = False, path: str | None = None):
        feats = [torch.as_tensor(x) for x in _collect_node_features(dataset)]
        self.net = net = self._build()
        opt = torch.optim.Adam(net.parameters(), lr=self.lr)
        g = torch.Generator().manual_seed(self.seed + 1)
        for _ in range(self.epochs):
            for x in feats:
                mu, logvar = net.encode(x, self.dropout, g)
                z = mu + torch.randn(mu.shape, generator=g) * torch.exp(0.5 * logvar)
                x_hat = net.decode(z, self.dropout, g)
                mse = torch.sum((x_hat - x) ** 2)  # reduction='sum' (:171)
                kld = -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar))
                opt.zero_grad()
                (mse + kld).backward()
                opt.step()
        if save_model:
            save_state(os.path.join(path, "vae_encoder"), net.jax_tree())

    @torch.no_grad()
    def get_latent_space(self, dataset, eps=None) -> np.ndarray:
        """[n_subdomains, n_components]: each subdomain's pooled latent.

        ``eps`` (one [n_nodes, n_components] array per subdomain) replaces
        the normal draws — zeros give the pooled mean mu; by default they
        come from a generator seeded with ``seed + 2`` on every call."""
        feats = _collect_node_features(dataset)
        g = torch.Generator().manual_seed(self.seed + 2)
        out = np.zeros((len(feats), self.n_components), np.float32)
        for i, x in enumerate(feats):
            mu, logvar = self.net.encode(torch.as_tensor(x))
            e = (torch.randn(mu.shape, generator=g) if eps is None
                 else torch.as_tensor(np.asarray(eps[i], np.float32)))
            z = mu + e * torch.exp(0.5 * logvar)
            out[i] = (z.sum(0) / max(len(x), 1)).numpy()
        return out

    def load_params(self, tree: dict) -> None:
        """Takes the JAX package's parameter tree (numpy leaves)."""
        self.net = self._build()
        self.net.load_jax_tree(tree)

    def load_model(self, path: str):
        self.load_params(load_state(os.path.join(path, "vae_encoder")))


class SpectrumEncoder(Encoder):
    """TKE-spectrum latents (encoder.py:204-364)."""

    def __init__(self, n_components: int, domain_size=0.03, grid_resolution=(16, 16, 16),
                 **kwargs):
        super().__init__(n_components)
        self.domain_size = domain_size
        self.grid_resolution = tuple(grid_resolution)

    @staticmethod
    def compute_tke_spectrum_2d(u: np.ndarray) -> np.ndarray:
        """2D variant (encoder.py:214-269), vectorized shell integration."""
        nx, ny = u.shape[:2]
        uf = np.fft.fft2(u[..., 0] if u.ndim == 3 else u, axes=(0, 1))
        ef = 0.5 * (uf * np.conj(uf)).real
        kx = np.fft.fftfreq(nx, d=1.0 / nx)
        ky = np.fft.fftfreq(ny, d=1.0 / ny)
        rk = np.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)
        k_index = np.round(rk).astype(np.int64)
        spectrum = np.bincount(k_index.ravel(), weights=ef.ravel(), minlength=nx)[:nx]
        spectrum = np.log(spectrum[1:] + 1e-8)
        rng = spectrum.max() - spectrum.min()
        return (spectrum - spectrum.min()) / (rng if rng > 0 else 1.0)

    def compute_tke_spectrum_3d(self, points: np.ndarray, physics: np.ndarray) -> np.ndarray:
        """3D variant (encoder.py:271-319): scatter -> grid -> FFT -> shells."""
        from ..ops.interpolate import gaussian_interpolate_host

        nx, ny, nz = self.grid_resolution
        lo, hi = points.min(axis=0), points.max(axis=0)
        axes = [np.linspace(lo[d], hi[d], n) for d, n in enumerate((nx, ny, nz))]
        gx, gy, gz = np.meshgrid(*axes, indexing="ij")
        grid_pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
        spacing = float(np.max((hi - lo) / np.maximum(np.array([nx, ny, nz]) - 1, 1)))
        vals = gaussian_interpolate_host(points, physics.reshape(-1, 1), grid_pts,
                                         radius=2.0 * spacing).reshape(nx, ny, nz)
        uf = np.fft.fftn(vals, axes=(0, 1, 2))
        ef = 0.5 * (uf * np.conj(uf)).real
        ks = [np.fft.fftfreq(n, d=1.0 / n) for n in (nx, ny, nz)]
        rk = np.sqrt(ks[0][:, None, None] ** 2 + ks[1][None, :, None] ** 2
                     + ks[2][None, None, :] ** 2)
        k_index = np.round(rk).astype(np.int64)
        nbins = nx // 2
        keep = k_index < nbins
        spectrum = np.bincount(k_index[keep], weights=ef[keep], minlength=nbins)[:nbins]
        spectrum = np.log(spectrum[1:] + 1e-8)
        rng = spectrum.max() - spectrum.min()
        return (spectrum - spectrum.min()) / (rng if rng > 0 else 1.0)

    def get_latent_space(self, dataset) -> np.ndarray:
        out = []
        for data in dataset:
            if isinstance(data, dict):
                pos, phys = data["pos"], data["y"][:, :1]
            else:
                pos, phys = np.asarray(data.pos), np.asarray(data.y)[:, :1]
            out.append(self.compute_tke_spectrum_3d(pos, phys))
        return np.stack(out)


class DMDEncoder(Encoder):
    """Dynamic-mode-decomposition latents: the leading singular values of
    the per-subdomain feature matrix, normalized by the first (a
    stationary-snapshot specialization; the reference's class is empty)."""

    def get_latent_space(self, dataset) -> np.ndarray:
        out = []
        for data in dataset:
            x = data["x"] if isinstance(data, dict) else np.asarray(data.x)
            s = np.linalg.svd(np.asarray(x, np.float64), compute_uv=False)
            v = np.zeros(self.n_components)
            v[: min(len(s), self.n_components)] = s[: self.n_components]
            out.append(v / (v[0] + 1e-12))
        return np.stack(out)


def init_encoder(type: str, n_components: int, **kwargs) -> Encoder:
    """Encoder factory (reference utils.py:55-63 + 'dmd')."""
    if type == "pca":
        return PCAEncoder(n_components=n_components)
    elif type == "vae":
        return VAEEncoder(n_components=n_components, **kwargs)
    elif type == "spectrum":
        return SpectrumEncoder(n_components=n_components, **kwargs)
    elif type == "dmd":
        return DMDEncoder(n_components=n_components)
    else:
        raise ValueError(f"Invalid encoder type: {type}")


def encoder_from_jax(enc) -> Encoder:
    """The port's copy of a JAX-package encoder (same class name): its
    hyperparameters and fitted arrays as numpy, and for the VAE its
    parameter tree loaded into a ``TBVAE``."""
    cls = {c.__name__: c for c in (PCAEncoder, VAEEncoder, SpectrumEncoder,
                                   DMDEncoder)}[type(enc).__name__]
    out = cls.__new__(cls)
    out.__dict__.update({k: v for k, v in vars(enc).items()
                         if not k.startswith("_") and k != "params"})
    if cls is VAEEncoder:
        out.net = None
        if enc.params is not None:
            out.load_params(unflatten_params(flatten_params(enc.params)))
    return out
