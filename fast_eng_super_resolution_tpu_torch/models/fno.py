"""FNO1d / FNO2d / FNO3d — Fourier Neural Operators on regular grids.

Parity target: the JAX package's ``models/fno.py`` (FNO2d after the
reference models/model.py:13-141; FNO1d and FNO3d are the same four-block
architecture one axis down and up).  Each block is a spectral conv (forward
real FFT, a complex channel mix of the kept low modes, inverse FFT) through
a 1x1 MLP, plus a 1x1 skip, with exact GELU between blocks; the lift is a
Linear over the raw channels and the normalized grid coordinates, and the
domain is zero-padded on the right by ``padding`` before the blocks.
Activations are channel-first inside the blocks, as in the JAX package, and
every 1x1 conv is an einsum over the channel axis (never ``nn.Conv*``,
whose cuDNN path has its own TF32 switch).

The spectral conv has two forms (``spectral_impl``, overridden by the
environment variable ``FESR_FNO_IMPL``):

- ``'fft'``: ``torch.fft`` (cuFFT on the card).  Only the kept columns go
  through the complex transforms over the non-last axes.  The mode mix
  writes complex values into the DC column (and the Nyquist column when the
  modes reach it), which a real inverse FFT cannot represent; pocketfft,
  which the JAX package runs on the CPU, drops their imaginary parts in its
  last step, cuFFT promises nothing for such input.  So the imaginary parts
  are dropped explicitly before the last (complex-to-real) transform: the
  input is well defined on every backend, and the CPU's bits do not change.
- ``'matmul'``: the truncated DFTs as dense einsums against precomputed
  matrices (built in numpy float64 and cast to float32 as the JAX package
  builds them, cached per shape and device); the JAX package's production
  form on the TPU, which had no FFT.

``'auto'`` is ``'fft'`` on the CPU, as in the JAX package, and ``'matmul'``
on the card, where it is the faster at every shipped config's shape (H100,
``chip_smoke.py``'s ``[grid_spectral]`` and ``[grid_train]``: at FNO2d's
32 x 16 x 265^2 one spectral conv forward and backward 1.90 ms against
3.89 for cuFFT, the train step 27.9 against 38.5 ms; FNO3d's 16 x 16 x
70^3 3.52 against 6.22, step 64.0 against 73.8; FNO1d's launch-bound
32 x 32 x 256 step 8.8 against 10.0).  Both forms check the modes against
the grid and raise the same ``ValueError``.

Complex weights are separate float32 real and imaginary parameters named as
in the JAX package's tree (``conv{i}.w1_re`` ...), so Adam treats them as
optax does and checkpoints interchange.  Weights also load from the
reference's ``.pth`` layout (``import_pth``, complex ``weights1/2``).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import jax_tree, linear_init, load_jax_tree


# -- mode checks and truncated-DFT matrices (numpy; the JAX package's) -----

def _check_modes_1d(w: int, m1: int) -> None:
    if m1 > w // 2 + 1:
        raise ValueError(
            f"grid length {w} too small for spectral modes ({m1},); "
            "pad the domain or reduce modes")


def _check_modes_2d(h: int, w: int, m1: int, m2: int) -> None:
    """Below ``2*m1`` rows the two spectrum-end row selections overlap and
    the conv would compute a different operator: both forms refuse."""
    if h < 2 * m1 or m2 > w // 2 + 1:
        raise ValueError(
            f"grid {h}x{w} too small for spectral modes ({m1},{m2}); "
            "pad the domain or reduce modes")


def _check_modes_3d(d: int, h: int, w: int,
                    m1: int, m2: int, m3: int) -> None:
    if d < 2 * m1 or h < 2 * m2 or m3 > w // 2 + 1:
        raise ValueError(
            f"grid {d}x{h}x{w} too small for spectral modes "
            f"({m1},{m2},{m3}); pad the domain or reduce modes")


def _f32_pair(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return (np.ascontiguousarray(v.real, np.float32),
            np.ascontiguousarray(v.imag, np.float32))


def _full_axis(n: int, m: int) -> tuple[np.ndarray, np.ndarray]:
    """Forward DFT [n, 2m] and inverse [2m, n] restricted to the rows kept
    from both spectrum ends, ``[0:m] + [n-m:n]``."""
    rows = np.concatenate([np.arange(m), np.arange(n - m, n)])
    ar = np.arange(n)
    f = np.exp(-2j * np.pi * ar[:, None] * rows[None, :] / n)
    g = np.exp(2j * np.pi * rows[:, None] * ar[None, :] / n) / n
    return f, g


def _real_axis(w: int, m: int) -> tuple[np.ndarray, np.ndarray]:
    """Forward rDFT [w, m] and the real-output inverse [m, w]: each column
    doubled for its Hermitian mirror but the DC and (even w) Nyquist ones,
    whose imaginary parts the final ``Re`` drops."""
    kw = np.arange(m)
    ar = np.arange(w)
    fw = np.exp(-2j * np.pi * ar[:, None] * kw[None, :] / w)
    c = np.full(m, 2.0)
    c[0] = 1.0
    if w % 2 == 0 and m - 1 == w // 2:
        c[-1] = 1.0
    gw = (c[:, None] / w) * np.exp(2j * np.pi * kw[:, None] * ar[None, :] / w)
    return fw, gw


def _complex_block(re_im) -> np.ndarray:
    """[K, N] complex matrix (a re/im pair) -> [K, 2, N, 2] real block, so a
    complex GEMM is one einsum over (K, in-re/im) to (N, out-re/im)."""
    re, im = re_im
    return np.ascontiguousarray(
        np.stack([np.stack([re, im], -1), np.stack([-im, re], -1)], 1),
        np.float32)


def _half_blocks(fw, gw) -> tuple[np.ndarray, np.ndarray]:
    """The rDFT pair's half blocks: ``fw`` [W, m, 2] (real input) and
    ``gw`` [m, 2, W] (real output, the ``Re`` folded in)."""
    fw, gw = _f32_pair(fw), _f32_pair(gw)
    return (np.ascontiguousarray(np.stack(fw, -1), np.float32),
            np.ascontiguousarray(np.stack([gw[0], -gw[1]], 1), np.float32))


@functools.lru_cache(maxsize=32)
def _dft_mats_1d_packed(w: int, m1: int) -> dict:
    _check_modes_1d(w, m1)
    fw, gw = _half_blocks(*_real_axis(w, m1))
    return {"fw": fw, "gw": gw}


@functools.lru_cache(maxsize=32)
def _dft_mats_packed(h: int, w: int, m1: int, m2: int) -> dict:
    _check_modes_2d(h, w, m1, m2)
    fh, gh = _full_axis(h, m1)
    fw, gw = _half_blocks(*_real_axis(w, m2))
    return {"fw": fw, "fh": _complex_block(_f32_pair(fh)),
            "gh": _complex_block(_f32_pair(gh)), "gw": gw}


@functools.lru_cache(maxsize=32)
def _dft_mats_3d_packed(d: int, h: int, w: int,
                        m1: int, m2: int, m3: int) -> dict:
    _check_modes_3d(d, h, w, m1, m2, m3)
    fd, gd = _full_axis(d, m1)
    fh, gh = _full_axis(h, m2)
    fw, gw = _half_blocks(*_real_axis(w, m3))
    blk = lambda a: _complex_block(_f32_pair(a))  # noqa: E731
    return {"fw": fw, "fh": blk(fh), "fd": blk(fd), "gd": blk(gd),
            "gh": blk(gh), "gw": gw}


@functools.lru_cache(maxsize=64)
def _device_mats(make, args: tuple, device: torch.device) -> dict:
    """``make(*args)``'s matrices as float32 tensors on ``device``, cached
    per shape and device."""
    return {k: torch.as_tensor(v, device=device)
            for k, v in make(*args).items()}


def _grid_coords(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` bit for bit: float32 ``i * (1 / (n-1))``
    (XLA multiplies by the reciprocal) with the end point exactly 1."""
    if n == 1:
        return torch.zeros(1, device=device)
    step = np.float32(1.0) / np.float32(n - 1)
    g = np.append(np.arange(n - 1, dtype=np.float32) * step, np.float32(1.0))
    return torch.as_tensor(g, device=device)


# -- the spectral conv, both forms ------------------------------------------

def _expand(a: torch.Tensor, dim: int, m: int, n: int) -> torch.Tensor:
    """Rows ``[0:m]`` and ``[m:2m]`` of ``a`` along ``dim`` placed at the
    two spectrum ends of a length-``n`` axis, zeros between."""
    shape = list(a.shape)
    shape[dim] = n - 2 * m
    return torch.cat([a.narrow(dim, 0, m), a.new_zeros(shape),
                      a.narrow(dim, m, m)], dim)


def _ends(a: torch.Tensor, dim: int, m: int) -> torch.Tensor:
    """The ``m`` lowest and ``m`` highest rows of ``a`` along ``dim``."""
    n = a.shape[dim]
    return torch.cat([a.narrow(dim, 0, m), a.narrow(dim, n - m, m)], dim)


def _irfft_last(u: torch.Tensor, n: int) -> torch.Tensor:
    """Real inverse FFT over the last axis of ``u`` (its first columns;
    the rest are zero) after dropping the imaginary parts of the DC and,
    for even ``n``, the Nyquist column: the input then is a Hermitian
    half spectrum, which cuFFT's C2R requires and pocketfft assumes."""
    keep = torch.ones(u.shape[-1], device=u.device)
    keep[0] = 0.0
    if n % 2 == 0 and u.shape[-1] == n // 2 + 1:
        keep[-1] = 0.0
    return torch.fft.irfft(torch.complex(u.real, u.imag * keep), n=n, dim=-1)


def _spectral_conv_1d(p, x: torch.Tensor, m1: int) -> torch.Tensor:
    """rFFT -> mix of modes [0:m1] -> irFFT.  x: [B, C, W]."""
    w = x.shape[-1]
    _check_modes_1d(w, m1)
    x_ft = torch.fft.rfft(x)[..., :m1]
    mixed = torch.einsum("bix,iox->box", x_ft, torch.complex(p.w_re, p.w_im))
    return _irfft_last(mixed, w)


def _spectral_conv1d_matmul(p, x: torch.Tensor, m1: int) -> torch.Tensor:
    mats = _device_mats(_dft_mats_1d_packed, (x.shape[-1], m1), x.device)
    wgt = torch.stack([torch.stack([p.w_re, p.w_im], -1),
                       torch.stack([-p.w_im, p.w_re], -1)], 2)  # [i,o,e,k,f]
    t = torch.einsum("bcw,wkf->bckf", x, mats["fw"])
    y = torch.einsum("bike,ioekf->bokf", t, wgt)
    return torch.einsum("boke,kew->bow", y, mats["gw"])


def _spectral_conv_2d(p, x: torch.Tensor, m1: int, m2: int) -> torch.Tensor:
    """SpectralConv2d.forward (reference model.py:35-49).  x: [B, C, H, W];
    rows [0:m1] mix through w1, rows [H-m1:H] through w2."""
    h, w = x.shape[-2], x.shape[-1]
    _check_modes_2d(h, w, m1, m2)
    x_ft = _ends(torch.fft.fft(torch.fft.rfft(x)[..., :m2], dim=-2), -2, m1)
    w12 = torch.cat([torch.complex(p.w1_re, p.w1_im),
                     torch.complex(p.w2_re, p.w2_im)], 2)
    out = torch.einsum("bixy,ioxy->boxy", x_ft, w12)
    u = torch.fft.ifft(_expand(out, -2, m1, h), dim=-2)
    return _irfft_last(u, w)


def _spectral_conv2d_matmul(p, x: torch.Tensor, m1: int,
                            m2: int) -> torch.Tensor:
    """The truncated DFTs as five packed real einsums (the JAX package's
    ``_spectral_conv_matmul``)."""
    h, w = x.shape[-2], x.shape[-1]
    mats = _device_mats(_dft_mats_packed, (h, w, m1, m2), x.device)
    w_re = torch.cat([p.w1_re, p.w2_re], 2)                    # [Ci,Co,2m1,m2]
    w_im = torch.cat([p.w1_im, p.w2_im], 2)
    wgt = torch.stack([torch.stack([w_re, w_im], -1),
                       torch.stack([-w_im, w_re], -1)], 2)     # [i,o,e,r,k,f]
    t = torch.einsum("bchw,wkf->bchkf", x, mats["fw"])
    v = torch.einsum("bchke,herf->bcrkf", t, mats["fh"])
    y = torch.einsum("birke,ioerkf->borkf", v, wgt)
    z = torch.einsum("borke,rehf->bohkf", y, mats["gh"])
    return torch.einsum("bohke,kew->bohw", z, mats["gw"])


def _spectral_conv_3d(p, x: torch.Tensor, m1: int, m2: int,
                      m3: int) -> torch.Tensor:
    """x: [B, C, D, H, W]; the stacked-corner weight [Ci, Co, 2m1, 2m2, m3]
    covers the kept rows of D and H from both spectrum ends."""
    d, h, w = x.shape[-3], x.shape[-2], x.shape[-1]
    _check_modes_3d(d, h, w, m1, m2, m3)
    t = _ends(torch.fft.fft(torch.fft.rfft(x)[..., :m3], dim=-2), -2, m2)
    sel = _ends(torch.fft.fft(t, dim=-3), -3, m1)
    out = torch.einsum("birsk,iorsk->borsk", sel,
                       torch.complex(p.w_re, p.w_im))
    u = torch.fft.ifft(_expand(out, -3, m1, d), dim=-3)
    u = torch.fft.ifft(_expand(u, -2, m2, h), dim=-2)
    return _irfft_last(u, w)


def _spectral_conv3d_matmul(p, x: torch.Tensor, m1: int, m2: int,
                            m3: int) -> torch.Tensor:
    """Seven packed real einsums (the JAX package's
    ``_spectral_conv3d_matmul``)."""
    mats = _device_mats(_dft_mats_3d_packed,
                        (*x.shape[-3:], m1, m2, m3), x.device)
    wgt = torch.stack([torch.stack([p.w_re, p.w_im], -1),
                       torch.stack([-p.w_im, p.w_re], -1)], 2)
    t = torch.einsum("bcdhw,wkf->bcdhkf", x, mats["fw"])
    u = torch.einsum("bcdhke,hesf->bcdskf", t, mats["fh"])
    v = torch.einsum("bcdske,derf->bcrskf", u, mats["fd"])
    y = torch.einsum("birske,ioerskf->borskf", v, wgt)
    z = torch.einsum("borske,redf->bodskf", y, mats["gd"])
    a = torch.einsum("bodske,sehf->bodhkf", z, mats["gh"])
    return torch.einsum("bodhke,kew->bodhw", a, mats["gw"])


_SPECTRAL = {1: (_spectral_conv_1d, _spectral_conv1d_matmul),
             2: (_spectral_conv_2d, _spectral_conv2d_matmul),
             3: (_spectral_conv_3d, _spectral_conv3d_matmul)}


# -- modules -----------------------------------------------------------------

def _conv1x1(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """1x1 conv on channel-first [B, C, *S] == a matmul over the channels."""
    bias = layer.bias.reshape(-1, *([1] * (x.dim() - 2)))
    return torch.einsum("bc...,dc->bd...", x, layer.weight) + bias


class _MLP(nn.Module):
    """MLP block (reference model.py:51-61): 1x1 -> GELU -> 1x1."""

    def __init__(self, c_in: int, c_mid: int, c_out: int):
        super().__init__()
        self.mlp1 = nn.utils.skip_init(nn.Linear, c_in, c_mid)
        self.mlp2 = nn.utils.skip_init(nn.Linear, c_mid, c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv1x1(self.mlp2, F.gelu(_conv1x1(self.mlp1, x)))


class _Spectral(nn.Module):
    """A spectral conv's weights: float32 real/imaginary parameter pairs."""

    def __init__(self, names: tuple, shape: tuple):
        super().__init__()
        for name in names:
            setattr(self, name, nn.Parameter(torch.empty(shape)))


def _conv1x1_weight(sd: dict, prefix: str) -> tuple[np.ndarray, np.ndarray]:
    """A k=1 ConvNd's weight [out, in, 1, ...] as a Linear's [out, in]."""
    w = np.asarray(sd[f"{prefix}.weight"])
    return w.reshape(w.shape[0], w.shape[1]), np.asarray(sd[f"{prefix}.bias"])


class _FNO(nn.Module):
    """The four-block operator shared by FNO1d/2d/3d over ``ndim`` axes."""

    ndim = 0
    spectral_names: tuple = ()

    def __init__(self, modes: tuple, width: int, in_feats: int, padding: int,
                 spectral_impl: str, seed: int):
        super().__init__()
        self.modes, self.width = tuple(int(m) for m in modes), width
        self.in_feats, self.padding = in_feats, padding
        self.spectral_impl = spectral_impl
        skip = nn.utils.skip_init
        self.p = skip(nn.Linear, in_feats + self.ndim, width)
        self.q = _MLP(width, width * 4, 128)
        for i in range(4):
            setattr(self, f"conv{i}",
                    _Spectral(self.spectral_names, self.spectral_shape()))
            setattr(self, f"w{i}", skip(nn.Linear, width, width))
            setattr(self, f"mlp{i}", _MLP(width, width, width))
        self.init_params(torch.Generator().manual_seed(seed))

    def spectral_shape(self) -> tuple:
        raise NotImplementedError

    def init_params(self, generator: torch.Generator) -> None:
        """The JAX package's init distributions (torch.nn.Linear's uniform
        for every linear layer, ``U(0, 1) / (width^2)`` for the spectral
        weights), drawn from ``generator`` (the draws differ from
        jax.random's)."""
        scale = 1.0 / (self.width * self.width)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                linear_init(mod, generator)
            elif isinstance(mod, _Spectral):
                with torch.no_grad():
                    for p in mod.parameters():
                        p.uniform_(0.0, 1.0, generator=generator).mul_(scale)

    def resolve_impl(self, device: torch.device) -> str:
        """The spectral form for ``device``: ``FESR_FNO_IMPL`` over
        ``spectral_impl``; 'auto' is 'fft' on the CPU, 'matmul' on the
        card."""
        impl = os.environ.get("FESR_FNO_IMPL", self.spectral_impl)
        if impl == "auto":
            impl = "fft" if torch.device(device).type == "cpu" else "matmul"
        if impl not in ("fft", "matmul"):
            raise ValueError(f"unknown spectral impl {impl!r}")
        return impl

    def _grid(self, x: torch.Tensor) -> list:
        """Per axis, its coordinates in [0, 1] broadcast to x's [B, *S, 1]."""
        spatial = x.shape[1:-1]
        out = []
        for a, n in enumerate(spatial):
            shape = [1] * (self.ndim + 2)
            shape[1 + a] = n
            g = _grid_coords(n, x.device).reshape(shape)
            out.append(g.expand(x.shape[0], *spatial, 1))
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, *S, C_in] -> [B, *S, 128] (reference model.py:100-133)."""
        x = torch.cat([x, *self._grid(x)], dim=-1)
        x = torch.movedim(self.p(x), -1, 1)       # [B, C, *S]
        pad = self.padding
        if pad:
            x = F.pad(x, (0, pad) * self.ndim)
        impl = self.resolve_impl(x.device)
        for i in range(4):
            x1 = getattr(self, f"mlp{i}")(spectral_conv(self, i, x, impl))
            x = x1 + _conv1x1(getattr(self, f"w{i}"), x)
            if i < 3:
                x = F.gelu(x)
        if pad:  # [:-0] would empty the axes
            x = x[(Ellipsis,) + (slice(0, -pad),) * self.ndim]
        return torch.movedim(self.q(x), 1, -1)

    apply = forward

    @staticmethod
    def jax_key(name: str) -> tuple[str, bool]:
        """(flat key in the JAX package's tree, transposed?) of parameter
        ``name``: a linear layer's weight is w [in, out] there."""
        parts = name.split(".")
        leaf = {"weight": ("w", True), "bias": ("b", False)}
        if parts[-1] in leaf:
            parts[-1], transposed = leaf[parts[-1]]
            return "/".join(parts), transposed
        return "/".join(parts), False

    def from_jax_params(self, params: dict) -> "_FNO":
        """Loads the JAX package's parameter tree (numpy leaves)."""
        load_jax_tree(self, params)
        return self

    def to_jax_params(self) -> dict:
        return jax_tree(self)

    def import_pth(self, state_dict) -> "_FNO":
        """Loads the reference's torch state_dict layout: Linear ``p``,
        k=1 ConvNd ``w{i}``, ``mlp{i}.mlp{1,2}`` and ``q.mlp{1,2}``, and the
        complex spectral weights ``conv{i}.weights*`` (``_spectral_pth``)."""
        sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else v
              for k, v in state_dict.items()}
        flat = {"p.weight": np.asarray(sd["p.weight"]),
                "p.bias": np.asarray(sd["p.bias"])}
        convs = ["q.mlp1", "q.mlp2"]
        for i in range(4):
            convs += [f"w{i}", f"mlp{i}.mlp1", f"mlp{i}.mlp2"]
            for k, v in self._spectral_pth(sd, i).items():
                flat[f"conv{i}.{k}"] = v
        for prefix in convs:
            flat[f"{prefix}.weight"], flat[f"{prefix}.bias"] = \
                _conv1x1_weight(sd, prefix)
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.copy_(torch.as_tensor(np.ascontiguousarray(
                    flat[name], np.float32)))
        return self

    def _spectral_pth(self, sd: dict, i: int) -> dict:
        raise NotImplementedError


def _re_im(w: np.ndarray, name: str) -> dict:
    return {f"{name}_re": np.real(w), f"{name}_im": np.imag(w)}


class FNO1d(_FNO):
    """1D operator on [B, W, C] lines (Burgers).  ``padding`` defaults to 0:
    the canonical Burgers task is periodic.  The rFFT keeps modes
    ``[0:modes1]``: weight [Ci, Co, m1]."""

    ndim = 1
    spectral_names = ("w_re", "w_im")

    def __init__(self, modes1: int, width: int, in_feats: int = 2,
                 padding: int = 0, spectral_impl: str = "auto",
                 seed: int = 0):
        super().__init__((modes1,), width, in_feats, padding, spectral_impl,
                         seed)

    def spectral_shape(self) -> tuple:
        return (self.width, self.width, self.modes[0])

    def _spectral_pth(self, sd: dict, i: int) -> dict:
        return _re_im(np.asarray(sd[f"conv{i}.weights1"]), "w")


class FNO2d(_FNO):
    """The reference FNO2d (model.py:63-99) on [B, H, W, C]; ``in_feats``
    is the raw field channels (the reference hardcodes 256), domain
    padding 9.  Rows ``[0:m1]`` and ``[H-m1:H]`` mix through ``w1``/``w2``
    [Ci, Co, m1, m2]."""

    ndim = 2
    spectral_names = ("w1_re", "w1_im", "w2_re", "w2_im")

    def __init__(self, modes1: int, modes2: int, width: int,
                 in_feats: int = 256, padding: int = 9,
                 spectral_impl: str = "auto", seed: int = 0):
        super().__init__((modes1, modes2), width, in_feats, padding,
                         spectral_impl, seed)

    def spectral_shape(self) -> tuple:
        return (self.width, self.width, *self.modes)

    def _spectral_pth(self, sd: dict, i: int) -> dict:
        return {**_re_im(np.asarray(sd[f"conv{i}.weights1"]), "w1"),
                **_re_im(np.asarray(sd[f"conv{i}.weights2"]), "w2")}


class FNO3d(_FNO):
    """The volumetric operator on [B, D, H, W, C], domain padding 6.  One
    stacked-corner weight [Ci, Co, 2m1, 2m2, m3]: rows ``[0:m1]`` are the
    low D modes and ``[m1:2m1]`` the high ones, H's columns likewise."""

    ndim = 3
    spectral_names = ("w_re", "w_im")

    def __init__(self, modes1: int, modes2: int, modes3: int, width: int,
                 in_feats: int = 1, padding: int = 6,
                 spectral_impl: str = "auto", seed: int = 0):
        super().__init__((modes1, modes2, modes3), width, in_feats, padding,
                         spectral_impl, seed)

    def spectral_shape(self) -> tuple:
        m1, m2, m3 = self.modes
        return (self.width, self.width, 2 * m1, 2 * m2, m3)

    def _spectral_pth(self, sd: dict, i: int) -> dict:
        """The canonical four corner blocks ``weights1-4`` (w1 low d low h,
        w2 high d low h, w3 low d high h, w4 high d high h) stacked."""
        c = [np.asarray(sd[f"conv{i}.weights{j}"]) for j in (1, 2, 3, 4)]
        lo = np.concatenate([c[0], c[2]], axis=3)
        hi = np.concatenate([c[1], c[3]], axis=3)
        return _re_im(np.concatenate([lo, hi], axis=2), "w")


def spectral_conv(model: _FNO, i: int, x: torch.Tensor,
                  impl: str) -> torch.Tensor:
    """Block ``i``'s spectral conv of ``model`` on channel-first ``x`` in
    form ``impl`` ('fft' or 'matmul')."""
    fn = _SPECTRAL[model.ndim][0 if impl == "fft" else 1]
    return fn(getattr(model, f"conv{i}"), x, *model.modes)

