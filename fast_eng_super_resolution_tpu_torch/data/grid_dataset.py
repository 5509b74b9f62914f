"""Regular-grid datasets of the grid model family (FNO1d/2d/3d, DeepONet):
the one-step super-resolution pairs and the rollout lane's trajectories.

A numpy/scipy copy of the JAX package's ``data/grid_dataset.py``: the same
generators draw the same numbers from the same seeded RNG, and the cache files (``root/processed/<name>.npz``) carry the
same JSON ``params`` stamp, so a cache written by either package is served
by the other and the arrays are bit-identical for one seed.  The module
needs no torch.  Besides the one-step pairs below it holds the trajectory
datasets of the rollout lane (``ns_rollout``, ``advected_rollout``,
``advected3d_rollout``), cached the same way.

The reference's FNO path consumed JHTDB turbulence cutouts (reference
dataset/MatDataset.py:21-39) whose processing lived out of its repo; these
are the self-contained equivalents, each a coarse solve upsampled to the
fine grid (input) against the fine solve (target):

- ``TurbulenceGridDataset``: random-phase k^-5/3 velocity snapshots and
  their spectral truncation.  With random phases the truncated modes are
  independent of the kept ones, so the identity is the best held-out map:
  a pipeline and throughput workload only.
- ``AdvectedScalarDataset`` / ``AdvectedScalar3DDataset``: a scalar
  advected semi-Lagrangianly by one low-mode solenoidal flow on both grids
  from one initial condition, so the fine filaments are a deterministic
  function of resolved inputs (learnable).
- ``DarcyFlowDataset``: steady Darcy flow on a thresholded Gaussian random
  field (scipy sparse solve).
- ``NavierStokesDataset`` / ``NSSpacetimeDataset``: pseudo-spectral 2D
  vorticity, the final state or a trajectory over (t, x, y).
- ``BurgersDataset``: 1D viscous Burgers with shocks.
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np


def synth_turbulence_2d(n: int, rng: np.random.Generator,
                        slope: float = -5.0 / 3.0) -> np.ndarray:
    """One [n, n, 2] solenoidal velocity snapshot with k^slope spectrum."""
    kx = np.fft.fftfreq(n, 1.0 / n)
    ky = np.fft.fftfreq(n, 1.0 / n)
    k2 = kx[:, None] ** 2 + ky[None, :] ** 2
    k = np.sqrt(np.maximum(k2, 1e-12))
    amp = np.where(k2 > 0, k ** ((slope - 1.0) / 2.0), 0.0)
    phase = np.exp(2j * np.pi * rng.random((n, n)))
    psi_hat = amp * phase  # stream function -> automatically divergence-free u
    psi = np.fft.ifft2(psi_hat).real
    u = np.gradient(psi, axis=1)
    v = -np.gradient(psi, axis=0)
    field = np.stack([u, v], axis=-1)
    return (field / (np.abs(field).max() + 1e-12)).astype(np.float32)


def spectral_downsample(field: np.ndarray, factor: int) -> np.ndarray:
    """Low-pass filter + upsample back: the coarse-solution surrogate."""
    n = field.shape[0]
    keep = n // (2 * factor)
    out = np.empty_like(field)
    for c in range(field.shape[-1]):
        f_hat = np.fft.fft2(field[..., c])
        mask = np.zeros((n, n))
        mask[:keep, :keep] = mask[:keep, -keep:] = 1
        mask[-keep:, :keep] = mask[-keep:, -keep:] = 1
        out[..., c] = np.fft.ifft2(f_hat * mask).real
    return out.astype(np.float32)


def _bilinear_sample(field: np.ndarray, xq: np.ndarray, yq: np.ndarray) -> np.ndarray:
    """Periodic bilinear interpolation of ``field`` [n, n] at fractional
    grid coordinates (xq, yq) — the semi-Lagrangian back-trace lookup."""
    n = field.shape[0]
    x0 = np.floor(xq).astype(np.int64)
    y0 = np.floor(yq).astype(np.int64)
    fx = xq - x0
    fy = yq - y0
    x0 %= n
    y0 %= n
    x1 = (x0 + 1) % n
    y1 = (y0 + 1) % n
    return (field[x0, y0] * (1 - fx) * (1 - fy) + field[x1, y0] * fx * (1 - fy)
            + field[x0, y1] * (1 - fx) * fy + field[x1, y1] * fx * fy)


def _check_coarse_nyquist(n: int, factor: int, max_mode: int,
                          ndim: int = 2) -> None:
    """The learnability precondition of the low-mode tasks is that the
    coarse grid exactly represents every excited mode: subsampling the fine
    IC/velocity IS the coarse one.  A coarse grid of m = n//factor points
    resolves real modes up to m//2 exclusive of aliasing only when
    m > 2*max_mode; below that, subsampling aliases mode +-max_mode onto a
    lower mode and the coarse run silently evolves a DIFFERENT flow."""
    m = n // factor
    if m <= 2 * max_mode:
        shape = "x".join([str(m)] * ndim)
        raise ValueError(
            f"coarse grid {shape} (resolution {n} / downsample {factor}) "
            f"aliases the excited modes |k| <= {max_mode}; need "
            f"resolution // downsample > {2 * max_mode} (lower max_mode or "
            "the downsample factor)")


def _solenoidal_low_mode_velocity(n: int, rng: np.random.Generator,
                                  max_mode: int = 3) -> np.ndarray:
    """Steady large-scale incompressible velocity from a few random low
    Fourier modes of a stream function.  Only modes <= max_mode are excited,
    so the SAME flow is exactly representable on the coarse grid — the
    fine-scale scalar structure is then fully determined by resolved
    quantities (what makes advection learnable, unlike random phases)."""
    psi_hat = np.zeros((n, n), np.complex128)
    for kx in range(-max_mode, max_mode + 1):
        for ky in range(-max_mode, max_mode + 1):
            if kx == 0 and ky == 0:
                continue
            amp = rng.normal() + 1j * rng.normal()
            psi_hat[kx % n, ky % n] = amp / (kx * kx + ky * ky)
    psi = np.fft.ifft2(psi_hat).real
    psi /= np.abs(psi).max() + 1e-12
    u = np.gradient(psi, axis=1)
    v = -np.gradient(psi, axis=0)
    return np.stack([u, v], axis=-1) * n  # grid units / unit time


def advected_scalar_pair(n: int, rng: np.random.Generator, factor: int = 4,
                         steps: int = 40, dt: float = 0.02,
                         max_mode: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """One (coarse-run upsampled, fine-run) scalar pair from the SAME initial
    condition and the SAME resolved velocity field.

    A smooth scalar blob field is advected by a steady low-mode solenoidal
    flow with semi-Lagrangian stepping (unconditionally stable) at two
    resolutions; the fine run develops filaments the coarse run cannot
    represent, but those filaments are a deterministic function of the
    coarse-resolvable flow and initial condition — a genuinely learnable
    super-resolution target (unlike random-phase spectra, see module
    docstring CAVEAT).  Returns (x, y), each [n, n, 1] float32.
    """
    _check_coarse_nyquist(n, factor, max_mode)
    # shared smooth initial condition: a few Gaussian blobs
    grid = np.arange(n)
    gx, gy = np.meshgrid(grid, grid, indexing="ij")
    theta0 = np.zeros((n, n))
    for _ in range(4):
        cx, cy = rng.random(2) * n
        s = (0.05 + 0.05 * rng.random()) * n
        dx = np.minimum(np.abs(gx - cx), n - np.abs(gx - cx))
        dy = np.minimum(np.abs(gy - cy), n - np.abs(gy - cy))
        theta0 += rng.random() * np.exp(-(dx ** 2 + dy ** 2) / (2 * s * s))
    vel = _solenoidal_low_mode_velocity(n, rng, max_mode=max_mode)

    def run(field, velocity, m, nsteps):
        xq0, yq0 = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
        f = field.copy()
        for _ in range(nsteps):
            xq = xq0 - velocity[..., 0] * dt
            yq = yq0 - velocity[..., 1] * dt
            f = _bilinear_sample(f, xq, yq)
        return f

    fine = run(theta0, vel, n, steps)
    m = n // factor
    theta0_c = theta0[::factor, ::factor]
    vel_c = vel[::factor, ::factor] / factor  # grid-unit velocity rescales
    coarse = run(theta0_c, vel_c, m, steps)
    # bilinear upsample the coarse result back to the fine grid
    xq = np.arange(n) / factor
    gxq, gyq = np.meshgrid(xq, xq, indexing="ij")
    up = _bilinear_sample(coarse, gxq, gyq)
    scale = np.abs(fine).max() + 1e-12
    return (up[..., None] / scale).astype(np.float32), \
           (fine[..., None] / scale).astype(np.float32)


class _CachedGridDataset:
    """Shared base for the grid-family datasets: generate ``num_samples``
    pairs from one seeded RNG, cache as npz under ``root/processed``, serve
    dict samples (``__getitem__`` -> {'x': [n, n, Cin], 'y': [n, n, Cout]}).

    The cache is keyed by the FULL generation-parameter set: the params are
    stored inside the npz and verified on load, and any mismatch (changed
    nu, resolution, sample count, ...) regenerates instead of silently
    serving stale physics under the new config's name.  Legacy caches
    written before the parameter record existed are accepted with a warning
    (delete the npz to force regeneration)."""

    _filename: str = ""  # subclasses set the cache filename

    def __init__(self, root: str, params: dict, pair_fn) -> None:
        self.root = root
        path = os.path.join(root, "processed", self._filename)
        stamp = json.dumps(params, sort_keys=True)
        x = y = None
        if os.path.exists(path):
            with np.load(path) as z:
                if "params" not in z:
                    warnings.warn(
                        f"{path}: legacy cache without a generation-parameter "
                        "record — serving as-is; delete the file to "
                        "regenerate under the current config")
                    x, y = z["x"], z["y"]
                elif str(z["params"]) == stamp:
                    x, y = z["x"], z["y"]
                # params present but different -> fall through and regenerate
        if x is None:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            rng = np.random.default_rng(params["seed"])
            xs, ys = [], []
            for _ in range(params["num_samples"]):
                lo, hi = pair_fn(rng)
                xs.append(lo)
                ys.append(hi)
            x, y = np.stack(xs), np.stack(ys)
            np.savez(path, x=x, y=y, params=np.array(stamp))
        self.x, self.y = x, y

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"x": self.x[i], "y": self.y[i]}


class AdvectedScalarDataset(_CachedGridDataset):
    """Learnable grid super-resolution workload: coarse-run vs fine-run
    advected scalars (see advected_scalar_pair).  Same access API as
    TurbulenceGridDataset; cached under root/processed."""

    _filename = "advected_data.npz"

    def __init__(self, root: str, num_samples: int = 32, resolution: int = 64,
                 downsample: int = 4, steps: int = 40, seed: int = 0, **kwargs):
        params = dict(num_samples=num_samples, resolution=resolution,
                      downsample=downsample, steps=steps, seed=seed)
        super().__init__(root, params, lambda rng: advected_scalar_pair(
            resolution, rng, factor=downsample, steps=steps))


def _trilinear_sample(field: np.ndarray, xq: np.ndarray, yq: np.ndarray,
                      zq: np.ndarray) -> np.ndarray:
    """Periodic trilinear interpolation of ``field`` [n, n, n] at fractional
    grid coordinates — the 3D semi-Lagrangian back-trace lookup."""
    n = field.shape[0]
    x0 = np.floor(xq).astype(np.int64)
    y0 = np.floor(yq).astype(np.int64)
    z0 = np.floor(zq).astype(np.int64)
    fx = xq - x0
    fy = yq - y0
    fz = zq - z0
    x0 %= n
    y0 %= n
    z0 %= n
    x1 = (x0 + 1) % n
    y1 = (y0 + 1) % n
    z1 = (z0 + 1) % n
    c00 = field[x0, y0, z0] * (1 - fx) + field[x1, y0, z0] * fx
    c10 = field[x0, y1, z0] * (1 - fx) + field[x1, y1, z0] * fx
    c01 = field[x0, y0, z1] * (1 - fx) + field[x1, y0, z1] * fx
    c11 = field[x0, y1, z1] * (1 - fx) + field[x1, y1, z1] * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _solenoidal_low_mode_velocity_3d(n: int, rng: np.random.Generator,
                                     max_mode: int = 2) -> np.ndarray:
    """Steady incompressible 3D velocity u = curl(A) from a random low-mode
    vector potential A — divergence-free by construction, and exciting only
    modes |k| <= max_mode per axis so the SAME flow is exactly representable
    on the coarse grid (the learnability precondition, see the 2D analog)."""
    a_hat = np.zeros((3, n, n, n), np.complex128)
    for kx in range(-max_mode, max_mode + 1):
        for ky in range(-max_mode, max_mode + 1):
            for kz in range(-max_mode, max_mode + 1):
                if kx == ky == kz == 0:
                    continue
                k2 = kx * kx + ky * ky + kz * kz
                for c in range(3):
                    a_hat[c, kx % n, ky % n, kz % n] = (
                        rng.normal() + 1j * rng.normal()) / k2
    # u_hat = i k x A_hat (curl in Fourier space); k in index units
    k = np.fft.fftfreq(n, 1.0 / n)
    kx = k[:, None, None]
    ky = k[None, :, None]
    kz = k[None, None, :]
    u_hat = np.stack([
        1j * (ky * a_hat[2] - kz * a_hat[1]),
        1j * (kz * a_hat[0] - kx * a_hat[2]),
        1j * (kx * a_hat[1] - ky * a_hat[0]),
    ])
    u = np.fft.ifftn(u_hat, axes=(1, 2, 3)).real
    u = np.moveaxis(u, 0, -1)  # [n, n, n, 3]
    # max-|u| of 0.3 n grid units/time: a few-cell displacement per dt=0.02
    # step, same regime as the 2D task
    return u * (0.3 * n / (np.abs(u).max() + 1e-12))


def advected_scalar3d_pair(n: int, rng: np.random.Generator, factor: int = 2,
                           steps: int = 30, dt: float = 0.02,
                           max_mode: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """One 3D (coarse-run upsampled, fine-run) advected-scalar pair.

    The volumetric extension of ``advected_scalar_pair``: Gaussian-blob
    scalar advected by a steady low-mode solenoidal flow with 3D
    semi-Lagrangian stepping at two resolutions sharing the same IC and the
    same coarse-resolvable velocity.  Returns (x, y), each [n, n, n, 1].
    """
    _check_coarse_nyquist(n, factor, max_mode, ndim=3)
    grid = np.arange(n)
    gx, gy, gz = np.meshgrid(grid, grid, grid, indexing="ij")
    theta0 = np.zeros((n, n, n))
    for _ in range(4):
        cx, cy, cz = rng.random(3) * n
        s = (0.06 + 0.06 * rng.random()) * n
        dx = np.minimum(np.abs(gx - cx), n - np.abs(gx - cx))
        dy = np.minimum(np.abs(gy - cy), n - np.abs(gy - cy))
        dz = np.minimum(np.abs(gz - cz), n - np.abs(gz - cz))
        theta0 += rng.random() * np.exp(
            -(dx ** 2 + dy ** 2 + dz ** 2) / (2 * s * s))
    vel = _solenoidal_low_mode_velocity_3d(n, rng, max_mode=max_mode)

    def run(field, velocity, m, nsteps):
        q0 = np.meshgrid(np.arange(m), np.arange(m), np.arange(m),
                         indexing="ij")
        f = field.copy()
        for _ in range(nsteps):
            f = _trilinear_sample(f,
                                  q0[0] - velocity[..., 0] * dt,
                                  q0[1] - velocity[..., 1] * dt,
                                  q0[2] - velocity[..., 2] * dt)
        return f

    fine = run(theta0, vel, n, steps)
    theta0_c = theta0[::factor, ::factor, ::factor]
    vel_c = vel[::factor, ::factor, ::factor] / factor
    coarse = run(theta0_c, vel_c, n // factor, steps)
    xq = np.arange(n) / factor
    gxq, gyq, gzq = np.meshgrid(xq, xq, xq, indexing="ij")
    up = _trilinear_sample(coarse, gxq, gyq, gzq)
    scale = np.abs(fine).max() + 1e-12
    return (up[..., None] / scale).astype(np.float32), \
           (fine[..., None] / scale).astype(np.float32)


class AdvectedScalar3DDataset(_CachedGridDataset):
    """Volumetric advected-scalar super-resolution workload for FNO3d (see
    advected_scalar3d_pair).  Same access API as the 2D grid datasets;
    samples are {'x': [n, n, n, 1], 'y': [n, n, n, 1]}."""

    _filename = "advected3d_data.npz"

    def __init__(self, root: str, num_samples: int = 32, resolution: int = 32,
                 downsample: int = 2, steps: int = 30, max_mode: int = 2,
                 seed: int = 0, **kwargs):
        params = dict(num_samples=num_samples, resolution=resolution,
                      downsample=downsample, steps=steps, max_mode=max_mode,
                      seed=seed)
        super().__init__(root, params, lambda rng: advected_scalar3d_pair(
            resolution, rng, factor=downsample, steps=steps,
            max_mode=max_mode))


def _grf_threshold_coeff(n: int, rng: np.random.Generator,
                         tau: float = 3.0, alpha: float = 2.0,
                         hi: float = 12.0, lo: float = 3.0) -> np.ndarray:
    """Piecewise-constant permeability field: a Gaussian random field with
    covariance ``(-lap + tau^2)^(-alpha)`` (spectral synthesis on the
    periodic grid), mean-centered and thresholded — the standard Darcy
    coefficient construction (values ``hi`` where the GRF is positive,
    ``lo`` elsewhere).

    Sampling a covariance-C field filters white noise by C^(1/2), i.e. the
    spectral filter carries exponent ``-alpha/2`` (filtering scales the
    covariance by filt^2) — exponent ``-alpha`` here would realize the much
    smoother ``(-lap + tau^2)^(-2 alpha)`` statistics and silently make the
    task easier than the canonical benchmark."""
    grf = _grf_sample(n, rng, tau=tau, alpha=alpha)
    grf -= grf.mean()
    return np.where(grf >= 0.0, hi, lo).astype(np.float32)


def _grf_sample(n: int, rng: np.random.Generator, tau: float = 3.0,
                alpha: float = 2.0) -> np.ndarray:
    """White noise filtered to power spectrum (4 pi^2 k^2 + tau^2)^(-alpha)
    — i.e. a sample of N(0, (-lap + tau^2)^(-alpha)) on the periodic grid
    (spectrum-tested in tests/test_grid.py)."""
    k = np.fft.fftfreq(n, 1.0 / n)
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    filt = (4.0 * np.pi ** 2 * k2 + tau ** 2) ** (-alpha / 2.0)
    noise = rng.normal(size=(n, n))
    return np.fft.ifft2(np.fft.fft2(noise) * filt).real


def solve_darcy(a: np.ndarray, f=1.0) -> np.ndarray:
    """Finite-volume solve of ``-div(a grad u) = f`` on the unit square with
    homogeneous Dirichlet walls; ``a`` holds [n, n] cell-centered
    coefficients, ``f`` a scalar or [n, n] source.  Harmonic-mean face
    transmissibilities (the conservative scheme for discontinuous
    coefficients); boundary faces use the half-cell distance (T = 2a).
    Direct sparse solve — the matrix is SPD and small (n<=256 -> <=65k
    unknowns), host-side ETL like the mesh partitioner."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    a = np.asarray(a, np.float64)
    n = a.shape[0]
    h = 1.0 / n
    idx = np.arange(n * n).reshape(n, n)

    def harm(a1, a2):
        return 2.0 * a1 * a2 / (a1 + a2)

    diag = np.zeros((n, n))
    rows, cols, vals = [], [], []
    # interior faces along each axis: off-diagonal -T, both diagonals +T
    for axis in (0, 1):
        lo_sl = (slice(None, -1), slice(None)) if axis == 0 else (slice(None), slice(None, -1))
        hi_sl = (slice(1, None), slice(None)) if axis == 0 else (slice(None), slice(1, None))
        t = harm(a[lo_sl], a[hi_sl])
        diag[lo_sl] += t
        diag[hi_sl] += t
        rows.append(idx[lo_sl].ravel())
        cols.append(idx[hi_sl].ravel())
        vals.append(-t.ravel())
        rows.append(idx[hi_sl].ravel())
        cols.append(idx[lo_sl].ravel())
        vals.append(-t.ravel())
    # Dirichlet walls: ghost value 0 at half-cell distance -> T = 2a
    for edge in (idx[0], idx[-1], idx[:, 0], idx[:, -1]):
        diag.ravel()[edge] += 2.0 * a.ravel()[edge]
    rows.append(idx.ravel())
    cols.append(idx.ravel())
    vals.append(diag.ravel())
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n * n, n * n)) / (h * h)
    b = np.broadcast_to(np.asarray(f, np.float64), (n, n)).ravel()
    u = spla.spsolve(A, b)
    return u.reshape(n, n).astype(np.float32)


def darcy_pair(n: int, rng: np.random.Generator,
               factor: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """One Darcy-flow super-resolution pair.

    The canonical neural-operator steady-state task (the FNO paper's Darcy
    benchmark), cast in this framework's super-resolution structure: the
    same thresholded-GRF permeability field is solved on the fine grid
    (truth) and on a ``factor``x coarser grid (the cheap simulation), and
    the model maps (bilinearly upsampled coarse solution, fine-grid
    coefficients) -> fine solution.  Unlike the advected task the fields are
    steady and the difficulty lives at the coefficient discontinuities,
    where the coarse solve smears the interface layers.

    Returns (x [n, n, 2], y [n, n, 1]) float32: x channels are the upsampled
    coarse solution (channel 0 — the improvement baseline, like every other
    dataset's interpolated input) and the normalized coefficient field.
    """
    a = _grf_threshold_coeff(n, rng)
    fine = solve_darcy(a)
    m = n // factor
    coarse = solve_darcy(a[::factor, ::factor])
    # periodic _bilinear_sample would wrap the non-periodic walls; clamp the
    # query instead (cell-centered grids: coarse cell k spans fine cells
    # k*factor..k*factor+factor-1, centers offset by (factor-1)/2)
    q = (np.arange(n) - (factor - 1) / 2.0) / factor
    q = np.clip(q, 0.0, m - 1.0)
    gxq, gyq = np.meshgrid(q, q, indexing="ij")
    up = _bilinear_sample(coarse, gxq, gyq)
    scale = np.abs(fine).max() + 1e-12
    a_norm = (a - (a.max() + a.min()) / 2.0) / (a.max() - a.min() + 1e-12)
    x = np.stack([up / scale, a_norm], axis=-1).astype(np.float32)
    y = (fine / scale)[..., None].astype(np.float32)
    return x, y


def _low_mode_vorticity(n: int, rng: np.random.Generator,
                        max_mode: int = 3) -> np.ndarray:
    """Random initial vorticity exciting only Fourier modes |k| <= max_mode,
    so the SAME field is exactly representable on any coarse grid with
    Nyquist above max_mode — subsampling the fine IC IS the coarse IC (the
    learnability precondition, same trick as _solenoidal_low_mode_velocity)."""
    w_hat = np.zeros((n, n), np.complex128)
    for kx in range(-max_mode, max_mode + 1):
        for ky in range(-max_mode, max_mode + 1):
            if kx == 0 and ky == 0:
                continue
            w_hat[kx % n, ky % n] = (rng.normal() + 1j * rng.normal())
    w = np.fft.ifft2(w_hat).real
    return w / (np.abs(w).max() + 1e-12)


def simulate_ns_vorticity(w0: np.ndarray, t_end: float = 5.0,
                          nu: float = 1e-3, dt: float = 5e-3,
                          forcing_amp: float = 0.1,
                          n_frames: int = 0) -> np.ndarray:
    """Pseudo-spectral 2D incompressible Navier-Stokes in vorticity form on
    the periodic unit square: dw/dt + u.grad(w) = nu lap(w) + f, with the
    standard fixed forcing f = amp (sin(2pi(x+y)) + cos(2pi(x+y))).

    Heun (RK2) on the dealiased advection term, exact integrating factor for
    viscosity — unconditionally stable in the stiff diffusive part; dt obeys
    the advective CFL for the O(1)-velocity regime this task generates.
    Host-side ETL (numpy FFT), like every other generator here.

    ``n_frames=0`` (default) returns the final state [n, n]; ``n_frames=T``
    returns the trajectory [T, n, n] sampled at equal step intervals ending
    at t_end (frame i = step ``steps*(i+1)//T``, so t=0 is never a frame —
    the IC is an input channel, not a target).
    """
    n = w0.shape[0]
    k = 2.0 * np.pi * np.fft.fftfreq(n, 1.0 / n)
    kx = k[:, None]
    ky = k[None, :]
    k2 = kx ** 2 + ky ** 2
    k2_inv = np.where(k2 > 0, 1.0 / np.maximum(k2, 1e-12), 0.0)
    dealias = ((np.abs(np.fft.fftfreq(n, 1.0 / n))[:, None] < n / 3)
               & (np.abs(np.fft.fftfreq(n, 1.0 / n))[None, :] < n / 3))
    # node grid x_i = i/n — the FFT's implicit sample positions, so the
    # coarse and fine runs sample the SAME continuous forcing (a
    # half-cell-offset grid would shift the forcing differently per
    # resolution and break the coarse/fine correspondence)
    xs = np.arange(n) / n
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    f_hat = np.fft.fft2(forcing_amp * (np.sin(2 * np.pi * (gx + gy))
                                       + np.cos(2 * np.pi * (gx + gy))))

    def rhs_advect(w_hat):
        psi_hat = w_hat * k2_inv
        u = np.fft.ifft2(1j * ky * psi_hat).real       # u =  d(psi)/dy
        v = np.fft.ifft2(-1j * kx * psi_hat).real      # v = -d(psi)/dx
        wx = np.fft.ifft2(1j * kx * w_hat).real
        wy = np.fft.ifft2(1j * ky * w_hat).real
        adv_hat = np.fft.fft2(u * wx + v * wy) * dealias
        return -adv_hat + f_hat

    w_hat = np.fft.fft2(np.asarray(w0, np.float64))
    visc = np.exp(-nu * k2 * dt)  # exact integrating factor exp(L dt)
    steps = int(round(t_end / dt))
    if n_frames < 0 or n_frames > steps:
        raise ValueError(
            f"n_frames={n_frames} must be in [0, solver steps={steps}]")
    # distinct for every i when n_frames <= steps (stride >= 1 per frame)
    frame_steps = ({steps * (i + 1) // n_frames for i in range(n_frames)}
                   if n_frames else set())
    frames = []
    for s in range(steps):
        # ETD-Heun: w+ = E w + dt/2 (E N(w) + N(E (w + dt N(w))))
        n1 = rhs_advect(w_hat)
        w_pred = (w_hat + dt * n1) * visc
        n2 = rhs_advect(w_pred)
        w_hat = w_hat * visc + 0.5 * dt * (n1 * visc + n2)
        if s + 1 in frame_steps:
            frames.append(np.fft.ifft2(w_hat).real.astype(np.float32))
    if n_frames:
        return np.stack(frames)
    return np.fft.ifft2(w_hat).real.astype(np.float32)


def ns_vorticity_pair(n: int, rng: np.random.Generator, factor: int = 4,
                      t_end: float = 5.0, nu: float = 1e-4, amp: float = 3.0,
                      dt: float = 5e-3, forcing_amp: float = 0.1,
                      max_mode: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """One Navier-Stokes super-resolution pair (the third canonical
    neural-operator task, after advection and Darcy).

    The same low-mode initial vorticity is evolved on the fine grid and on a
    ``factor``x coarser grid (which under-resolves the advective cascade);
    the model maps (bilinearly upsampled coarse solution, initial vorticity)
    -> fine solution.  Including the IC channel keeps the target a
    deterministic function of the inputs even where the coarse solve has
    lost information (same construction as darcy_pair's coefficient
    channel).  Returns (x [n, n, 2], y [n, n, 1]) float32.
    """
    _check_coarse_nyquist(n, factor, max_mode)
    w0 = _low_mode_vorticity(n, rng, max_mode=max_mode) * amp
    fine = simulate_ns_vorticity(w0, t_end=t_end, nu=nu, dt=dt,
                                 forcing_amp=forcing_amp)
    coarse = simulate_ns_vorticity(w0[::factor, ::factor], t_end=t_end,
                                   nu=nu, dt=dt, forcing_amp=forcing_amp)
    # node grids (x_i = i/n): fine node i sits at coarse coordinate i/factor
    q = np.arange(n) / factor
    gxq, gyq = np.meshgrid(q, q, indexing="ij")  # _bilinear_sample is periodic
    up = _bilinear_sample(coarse, gxq, gyq)
    scale = np.abs(fine).max() + 1e-12
    x = np.stack([up / scale, w0 / scale], axis=-1).astype(np.float32)
    y = (fine / scale)[..., None].astype(np.float32)
    return x, y


def ns_spacetime_pair(n: int, rng: np.random.Generator, factor: int = 4,
                      t_frames: int = 16, t_end: float = 2.0,
                      nu: float = 1e-4, amp: float = 3.0, dt: float = 5e-3,
                      forcing_amp: float = 0.1,
                      max_mode: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """One space-time Navier-Stokes pair for the volumetric operator (FNO3d
    over (t, x, y)) — the canonical FNO-paper NS setup cast in this
    framework's super-resolution structure.

    The same low-mode initial vorticity is evolved on the fine and the
    ``factor``x-coarser spatial grid (both at the fine solver dt), and
    ``t_frames`` frames ending at t_end are recorded from each run.  The
    model maps the full coarse TRAJECTORY (bilinearly upsampled per frame,
    plus the IC as a second channel) to the fine trajectory — the temporal
    axis gives the operator strictly more resolved information than the
    single-frame 'ns_grid' task (each coarse frame constrains the fine one),
    which is exactly what the space-time formulation is for.

    Returns (x [T, n, n, 2], y [T, n, n, 1]) float32.
    """
    _check_coarse_nyquist(n, factor, max_mode)
    w0 = _low_mode_vorticity(n, rng, max_mode=max_mode) * amp
    fine = simulate_ns_vorticity(w0, t_end=t_end, nu=nu, dt=dt,
                                 forcing_amp=forcing_amp, n_frames=t_frames)
    coarse = simulate_ns_vorticity(w0[::factor, ::factor], t_end=t_end,
                                   nu=nu, dt=dt, forcing_amp=forcing_amp,
                                   n_frames=t_frames)
    q = np.arange(n) / factor
    gxq, gyq = np.meshgrid(q, q, indexing="ij")  # _bilinear_sample is periodic
    up = np.stack([_bilinear_sample(c, gxq, gyq) for c in coarse])
    scale = np.abs(fine).max() + 1e-12
    ic = np.broadcast_to(w0[None], fine.shape)
    x = np.stack([up / scale, ic / scale], axis=-1).astype(np.float32)
    y = (fine / scale)[..., None].astype(np.float32)
    return x, y


class NSSpacetimeDataset(_CachedGridDataset):
    """Space-time NS vorticity workload for FNO3d (see ns_spacetime_pair).
    Samples are {'x': [T, n, n, 2], 'y': [T, n, n, 1]}; cached under
    root/processed with param-keyed verification like the other grids."""

    _filename = "ns3d_data.npz"

    def __init__(self, root: str, num_samples: int = 128, resolution: int = 64,
                 downsample: int = 4, t_frames: int = 16, t_end: float = 2.0,
                 nu: float = 1e-4, amp: float = 3.0, dt: float = 5e-3,
                 forcing_amp: float = 0.1, max_mode: int = 3, seed: int = 0,
                 **kwargs):
        params = dict(num_samples=num_samples, resolution=resolution,
                      downsample=downsample, t_frames=t_frames, t_end=t_end,
                      nu=nu, amp=amp, dt=dt, forcing_amp=forcing_amp,
                      max_mode=max_mode, seed=seed)
        super().__init__(root, params, lambda rng: ns_spacetime_pair(
            resolution, rng, factor=downsample, t_frames=t_frames,
            t_end=t_end, nu=nu, amp=amp, dt=dt, forcing_amp=forcing_amp,
            max_mode=max_mode))


class NavierStokesDataset(_CachedGridDataset):
    """Decaying/forced 2D turbulence vorticity workload (see
    ns_vorticity_pair).  Same access API as the other grid datasets; cached
    under root/processed.  All solver knobs (dt, forcing_amp, max_mode) are
    config-reachable — a resolution-scaled run can lower dt below the
    default 5e-3, which sits at the advective CFL limit near n=256."""

    _filename = "ns_data.npz"

    def __init__(self, root: str, num_samples: int = 128, resolution: int = 64,
                 downsample: int = 4, t_end: float = 5.0, nu: float = 1e-4,
                 amp: float = 3.0, dt: float = 5e-3, forcing_amp: float = 0.1,
                 max_mode: int = 3, seed: int = 0, **kwargs):
        params = dict(num_samples=num_samples, resolution=resolution,
                      downsample=downsample, t_end=t_end, nu=nu, amp=amp,
                      dt=dt, forcing_amp=forcing_amp, max_mode=max_mode,
                      seed=seed)
        super().__init__(root, params, lambda rng: ns_vorticity_pair(
            resolution, rng, factor=downsample, t_end=t_end, nu=nu, amp=amp,
            dt=dt, forcing_amp=forcing_amp, max_mode=max_mode))


class DarcyFlowDataset(_CachedGridDataset):
    """Steady-state Darcy-flow grid workload (see darcy_pair).  Same access
    API as the other grid datasets; cached under root/processed."""

    _filename = "darcy_data.npz"

    def __init__(self, root: str, num_samples: int = 128, resolution: int = 64,
                 downsample: int = 4, seed: int = 0, **kwargs):
        params = dict(num_samples=num_samples, resolution=resolution,
                      downsample=downsample, seed=seed)
        super().__init__(root, params, lambda rng: darcy_pair(
            resolution, rng, factor=downsample))


class TurbulenceGridDataset(_CachedGridDataset):
    """Paired (upsampled-coarse, fine) snapshots on a regular grid.

    API mirrors the graph datasets where it makes sense: __len__, __getitem__
    returning dicts with 'x' [n, n, C] and 'y' [n, n, C].
    """

    _filename = "grid_data.npz"

    def __init__(self, root: str, num_samples: int = 32, resolution: int = 64,
                 downsample: int = 4, seed: int = 0, **kwargs):
        params = dict(num_samples=num_samples, resolution=resolution,
                      downsample=downsample, seed=seed)

        def pair(rng):
            hi = synth_turbulence_2d(resolution, rng)
            return spectral_downsample(hi, downsample), hi

        super().__init__(root, params, pair)


# ---------------------------------------------------------------------------
# Burgers' equation (1D) — the remaining member of the canonical
# neural-operator task trio (Burgers / Darcy / Navier-Stokes), cast in this
# framework's super-resolution structure for FNO1d.
# ---------------------------------------------------------------------------


def _linear_sample_1d(f: np.ndarray, xq: np.ndarray) -> np.ndarray:
    """Periodic linear interpolation of ``f`` [m] at fractional grid
    coordinates — the 1D analog of ``_bilinear_sample``."""
    m = f.shape[0]
    x0 = np.floor(xq).astype(np.int64)
    tx = xq - x0
    x0 %= m
    x1 = (x0 + 1) % m
    return f[x0] * (1 - tx) + f[x1] * tx


def _low_mode_ic_1d(n: int, rng: np.random.Generator,
                    max_mode: int = 3) -> np.ndarray:
    """Random periodic initial condition exciting only modes |k| <= max_mode
    — exactly representable on any coarse grid with Nyquist above max_mode,
    so subsampling the fine IC IS the coarse IC (the learnability
    precondition; same trick as ``_low_mode_vorticity``)."""
    u_hat = np.zeros(n, np.complex128)
    for k in range(1, max_mode + 1):
        c = rng.normal() + 1j * rng.normal()
        u_hat[k] = c
        u_hat[-k] = np.conj(c)  # real field
    u = np.fft.ifft(u_hat).real
    return u / (np.abs(u).max() + 1e-12)


def simulate_burgers(u0: np.ndarray, t_end: float = 1.0, nu: float = 5e-3,
                     dt: float = 1e-3) -> np.ndarray:
    """Pseudo-spectral 1D viscous Burgers on the periodic unit interval:
    du/dt + u du/dx = nu d2u/dx2, i.e. du/dt = -0.5 d(u^2)/dx + nu u_xx.

    Heun (RK2) on the dealiased (2/3-rule) conservative nonlinear term,
    exact integrating factor for viscosity — the same ETD-Heun scheme as
    ``simulate_ns_vorticity`` one axis down.  dt must obey the advective
    CFL (|u| dt < 1/n); the defaults hold for |u| ~ 1 up to n = 512.
    Host-side ETL (numpy FFT), like every other generator here.
    """
    n = u0.shape[0]
    k = 2.0 * np.pi * np.fft.fftfreq(n, 1.0 / n)
    dealias = np.abs(np.fft.fftfreq(n, 1.0 / n)) < n / 3

    def rhs(u_hat):
        u = np.fft.ifft(u_hat).real
        return -0.5j * k * np.fft.fft(u * u) * dealias

    u_hat = np.fft.fft(np.asarray(u0, np.float64))
    visc = np.exp(-nu * k ** 2 * dt)  # exact integrating factor exp(L dt)
    for _ in range(int(round(t_end / dt))):
        n1 = rhs(u_hat)
        u_pred = (u_hat + dt * n1) * visc
        n2 = rhs(u_pred)
        u_hat = u_hat * visc + 0.5 * dt * (n1 * visc + n2)
    return np.fft.ifft(u_hat).real.astype(np.float32)


def burgers_pair(n: int, rng: np.random.Generator, factor: int = 4,
                 t_end: float = 1.0, nu: float = 5e-3, amp: float = 1.0,
                 dt: float = 1e-3,
                 max_mode: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """One Burgers super-resolution pair.

    The same low-mode initial condition is evolved on the fine grid and on a
    ``factor``x coarser grid; at ``nu = 5e-3`` the solution steepens into
    moving shock fronts whose width the fine grid resolves and the coarse
    grid smears into Gibbs wiggles — exactly the structure the operator must
    reconstruct, and (because the IC is coarse-resolvable) a deterministic
    function of the inputs.  The model maps (linearly upsampled coarse
    solution, initial condition) -> fine solution, matching darcy_pair /
    ns_vorticity_pair's two-channel input convention.

    Returns (x [n, 2], y [n, 1]) float32; channel 0 of x is the upsampled
    coarse solution (the improvement baseline, like every other dataset).
    """
    _check_coarse_nyquist(n, factor, max_mode, ndim=1)
    u0 = _low_mode_ic_1d(n, rng, max_mode=max_mode) * amp
    fine = simulate_burgers(u0, t_end=t_end, nu=nu, dt=dt)
    coarse = simulate_burgers(u0[::factor], t_end=t_end, nu=nu, dt=dt)
    up = _linear_sample_1d(coarse, np.arange(n) / factor)
    scale = np.abs(fine).max() + 1e-12
    x = np.stack([up / scale, u0 / scale], axis=-1).astype(np.float32)
    y = (fine / scale)[..., None].astype(np.float32)
    return x, y


class BurgersDataset(_CachedGridDataset):
    """1D Burgers super-resolution workload (see burgers_pair) for FNO1d.
    Samples are {'x': [n, 2], 'y': [n, 1]}; cached under root/processed."""

    _filename = "burgers_data.npz"

    def __init__(self, root: str, num_samples: int = 128,
                 resolution: int = 256, downsample: int = 4,
                 t_end: float = 1.0, nu: float = 5e-3, amp: float = 1.0,
                 dt: float = 1e-3, max_mode: int = 3, seed: int = 0,
                 **kwargs):
        params = dict(num_samples=num_samples, resolution=resolution,
                      downsample=downsample, t_end=t_end, nu=nu, amp=amp,
                      dt=dt, max_mode=max_mode, seed=seed)
        super().__init__(root, params, lambda rng: burgers_pair(
            resolution, rng, factor=downsample, t_end=t_end, nu=nu, amp=amp,
            dt=dt, max_mode=max_mode))


def advected_rollout_traj(n: int, rng: np.random.Generator, factor: int = 4,
                          t_frames: int = 10, steps_per_frame: int = 4,
                          dt: float = 0.02, max_mode: int = 3):
    """One advected-scalar TRAJECTORY pair for the rollout lane.

    Same physics as ``advected_scalar_pair`` (shared blob IC, shared
    low-mode solenoidal velocity, semi-Lagrangian at two resolutions), but
    recording ``t_frames`` intermediate frames every ``steps_per_frame``
    steps from BOTH runs.  With the defaults (10 frames x 4 steps) the
    final frame is the one-shot task's target exactly (steps=40, same dt),
    so rollout endpoints compare directly against the one-shot rows.

    Unlike NS vorticity, advection is NOT self-contained dynamics: theta_t
    alone does not determine theta_{t+1} — the velocity does.  The velocity
    is coarse-resolvable and part of the problem spec at serve time, so it
    rides as static input channels (normalized by n: grid-units/time ->
    O(1) fractions-of-domain/time, preserving across-trajectory speed
    differences).

    Returns (traj [T+1, n, n], coarse [T, n, n], vel [n, n, 2]) float32,
    theta scaled per-trajectory like every other grid task.
    """
    _check_coarse_nyquist(n, factor, max_mode)
    grid = np.arange(n)
    gx, gy = np.meshgrid(grid, grid, indexing="ij")
    theta0 = np.zeros((n, n))
    for _ in range(4):
        cx, cy = rng.random(2) * n
        s = (0.05 + 0.05 * rng.random()) * n
        dx = np.minimum(np.abs(gx - cx), n - np.abs(gx - cx))
        dy = np.minimum(np.abs(gy - cy), n - np.abs(gy - cy))
        theta0 += rng.random() * np.exp(-(dx ** 2 + dy ** 2) / (2 * s * s))
    vel = _solenoidal_low_mode_velocity(n, rng, max_mode=max_mode)

    def run_frames(field, velocity, m):
        xq0, yq0 = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
        xq = xq0 - velocity[..., 0] * dt
        yq = yq0 - velocity[..., 1] * dt
        f, frames = field.copy(), []
        for _ in range(t_frames):
            for _ in range(steps_per_frame):
                f = _bilinear_sample(f, xq, yq)
            frames.append(f)
        return np.stack(frames)

    fine = run_frames(theta0, vel, n)
    m = n // factor
    coarse = run_frames(theta0[::factor, ::factor],
                        vel[::factor, ::factor] / factor, m)
    q = np.arange(n) / factor
    gxq, gyq = np.meshgrid(q, q, indexing="ij")
    up = np.stack([_bilinear_sample(c, gxq, gyq) for c in coarse])
    scale = max(np.abs(fine).max(), np.abs(theta0).max()) + 1e-12
    traj = np.concatenate([theta0[None], fine]) / scale
    return (traj.astype(np.float32), (up / scale).astype(np.float32),
            (vel / n).astype(np.float32))


def advected3d_rollout_traj(n: int, rng: np.random.Generator,
                            factor: int = 2, t_frames: int = 10,
                            steps_per_frame: int = 3, dt: float = 0.02,
                            max_mode: int = 2):
    """One VOLUMETRIC advected-scalar trajectory pair for the FNO3d
    time-stepper.  3D analog
    of ``advected_rollout_traj``; with the defaults (10 x 3 steps) the
    endpoint matches ``advected_scalar3d_pair``'s steps=30 target.
    Returns (traj [T+1, n, n, n], coarse [T, n, n, n], vel [n, n, n, 3])."""
    _check_coarse_nyquist(n, factor, max_mode, ndim=3)
    grid = np.arange(n)
    gx, gy, gz = np.meshgrid(grid, grid, grid, indexing="ij")
    theta0 = np.zeros((n, n, n))
    for _ in range(4):
        cx, cy, cz = rng.random(3) * n
        s = (0.06 + 0.06 * rng.random()) * n
        dx = np.minimum(np.abs(gx - cx), n - np.abs(gx - cx))
        dy = np.minimum(np.abs(gy - cy), n - np.abs(gy - cy))
        dz = np.minimum(np.abs(gz - cz), n - np.abs(gz - cz))
        theta0 += rng.random() * np.exp(
            -(dx ** 2 + dy ** 2 + dz ** 2) / (2 * s * s))
    vel = _solenoidal_low_mode_velocity_3d(n, rng, max_mode=max_mode)

    def run_frames(field, velocity, m):
        q0 = np.meshgrid(np.arange(m), np.arange(m), np.arange(m),
                         indexing="ij")
        xq = q0[0] - velocity[..., 0] * dt
        yq = q0[1] - velocity[..., 1] * dt
        zq = q0[2] - velocity[..., 2] * dt
        f, frames = field.copy(), []
        for _ in range(t_frames):
            for _ in range(steps_per_frame):
                f = _trilinear_sample(f, xq, yq, zq)
            frames.append(f)
        return np.stack(frames)

    fine = run_frames(theta0, vel, n)
    coarse = run_frames(theta0[::factor, ::factor, ::factor],
                        vel[::factor, ::factor, ::factor] / factor,
                        n // factor)
    q = np.arange(n) / factor
    gxq, gyq, gzq = np.meshgrid(q, q, q, indexing="ij")
    up = np.stack([_trilinear_sample(c, gxq, gyq, gzq) for c in coarse])
    scale = max(np.abs(fine).max(), np.abs(theta0).max()) + 1e-12
    traj = np.concatenate([theta0[None], fine]) / scale
    return (traj.astype(np.float32), (up / scale).astype(np.float32),
            (vel / n).astype(np.float32))


class _CachedTrajDataset:
    """Shared base for trajectory (rollout-lane) datasets: caches
    ``trajectories`` [S, T+1, *sp], ``coarse_frames`` [S, T, *sp] and
    ``static_fields`` [S, *sp, K] in one param-keyed npz (same verification
    contract as _CachedGridDataset), and serves the S*T one-step training
    pairs trajectory-major — ``train_samples: K*t_frames`` holds out whole
    trajectories, like NSRolloutDataset.

    One-step sample layout (must match grid_runner.pred_rollout's step
    input): x channels = [theta_t, (coarse_t if guided), *static], y =
    theta_{t+1}.
    """

    _filename: str = ""
    rollout_eval = True

    def __init__(self, root: str, params: dict, traj_fn,
                 guided: bool = False) -> None:
        self.root = root
        path = os.path.join(root, "processed", self._filename)
        stamp = json.dumps(params, sort_keys=True)
        traj = None
        if os.path.exists(path):
            with np.load(path) as z:
                if "params" in z and str(z["params"]) == stamp:
                    traj, coarse, static = (z["traj"], z["coarse"],
                                            z["static"])
                # no legacy grace: this format never shipped without params
        if traj is None:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            rng = np.random.default_rng(params["seed"])
            ts, cs, ss = [], [], []
            for _ in range(params["num_samples"]):
                t, c, s = traj_fn(rng)
                ts.append(t)
                cs.append(c)
                ss.append(s)
            traj, coarse, static = np.stack(ts), np.stack(cs), np.stack(ss)
            np.savez(path, traj=traj, coarse=coarse, static=static,
                     params=np.array(stamp))
        self.trajectories = traj
        self.coarse_frames = coarse
        self.static_fields = static
        self.guided = bool(guided)
        self.t_frames = int(coarse.shape[1])

    def __len__(self):
        return self.trajectories.shape[0] * self.t_frames

    def __getitem__(self, i):
        s, t = divmod(int(i), self.t_frames)
        chans = [self.trajectories[s, t]]
        if self.guided:
            # coarse_frames[s, t] is the coarse solve AT the target time
            chans.append(self.coarse_frames[s, t])
        x = np.concatenate([np.stack(chans, axis=-1), self.static_fields[s]],
                           axis=-1)
        return {"x": x, "y": self.trajectories[s, t + 1][..., None]}


class AdvectedRolloutDataset(_CachedTrajDataset):
    """2D advected-scalar rollout workload (see advected_rollout_traj).
    Samples: x [n, n, 3|4] = [theta_t, (coarse_t), u, v], y [n, n, 1]."""

    _filename = "advected_rollout.npz"

    def __init__(self, root: str, num_samples: int = 128,
                 resolution: int = 64, downsample: int = 4,
                 t_frames: int = 10, steps_per_frame: int = 4,
                 max_mode: int = 3, guided: bool = False, seed: int = 0,
                 **kwargs):
        params = dict(num_samples=num_samples, resolution=resolution,
                      downsample=downsample, t_frames=t_frames,
                      steps_per_frame=steps_per_frame, max_mode=max_mode,
                      seed=seed)
        super().__init__(root, params, lambda rng: advected_rollout_traj(
            resolution, rng, factor=downsample, t_frames=t_frames,
            steps_per_frame=steps_per_frame, max_mode=max_mode),
            guided=guided)


class AdvectedRollout3DDataset(_CachedTrajDataset):
    """Volumetric advected-scalar rollout workload for the FNO3d stepper
    (see advected3d_rollout_traj).  Samples: x [n, n, n, 4|5] =
    [theta_t, (coarse_t), u, v, w], y [n, n, n, 1]."""

    _filename = "advected3d_rollout.npz"

    def __init__(self, root: str, num_samples: int = 128,
                 resolution: int = 32, downsample: int = 2,
                 t_frames: int = 10, steps_per_frame: int = 3,
                 max_mode: int = 2, guided: bool = False, seed: int = 0,
                 **kwargs):
        params = dict(num_samples=num_samples, resolution=resolution,
                      downsample=downsample, t_frames=t_frames,
                      steps_per_frame=steps_per_frame, max_mode=max_mode,
                      seed=seed)
        super().__init__(root, params, lambda rng: advected3d_rollout_traj(
            resolution, rng, factor=downsample, t_frames=t_frames,
            steps_per_frame=steps_per_frame, max_mode=max_mode),
            guided=guided)


class NSRolloutDataset:
    """Autoregressive-rollout view of the space-time NS workload.

    No reference analog (the reference's FNO is a one-shot map,
    models/model.py:13-141): instead of
    mapping the coarse solve to the fine solve at a fixed horizon, train a
    fine-resolution TIME-STEPPER on consecutive fine-frame pairs and compose
    it at serve time — the standard autoregressive use of the FNO.  Because
    the initial vorticity is low-mode (exactly representable on the coarse
    grid), the rollout needs ONLY the IC: it replaces the fine solver
    outright rather than correcting a coarse run.  ``guided=True`` adds the
    upsampled coarse frame at the TARGET time as a second input channel (the
    coarse solve is cheap at serve time), anchoring the rollout against
    accumulated drift.

    Training samples are the S*T one-step pairs, trajectory-major — so
    ``train_samples: K*t_frames`` holds out whole trajectories, and the
    one-step val loss is computed on frames from UNSEEN trajectories.
    Rollout evaluation (grid_runner.pred_rollout) reads ``trajectories``
    [S, T+1, n, n] (frame 0 = the IC) and ``coarse_frames`` [S, T, n, n]
    directly.  Wraps NSSpacetimeDataset, reusing its cache byte-for-byte.
    """

    rollout_eval = True
    static_fields = None   # NS is self-contained dynamics: no extra inputs

    def __init__(self, root: str, guided: bool = False, **kwargs):
        inner = NSSpacetimeDataset(root=root, **kwargs)
        ic = inner.x[:, 0, :, :, 1]            # [S, n, n]: the IC channel
        fine = inner.y[..., 0]                 # [S, T, n, n]
        self.trajectories = np.concatenate([ic[:, None], fine], axis=1)
        self.coarse_frames = inner.x[..., 0]   # [S, T, n, n], upsampled
        self.guided = bool(guided)
        self.t_frames = int(fine.shape[1])

    def __len__(self):
        return self.trajectories.shape[0] * self.t_frames

    def __getitem__(self, i):
        s, t = divmod(int(i), self.t_frames)
        cur = self.trajectories[s, t]
        if self.guided:
            # coarse_frames[s, t] is the coarse solve AT the target time
            # (frames exclude t=0, so coarse index t aligns with traj t+1)
            x = np.stack([cur, self.coarse_frames[s, t]], axis=-1)
        else:
            x = cur[..., None]
        return {"x": x, "y": self.trajectories[s, t + 1][..., None]}
