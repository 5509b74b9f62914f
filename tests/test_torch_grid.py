"""Port of the grid model family (models/fno.py, models/deeponet.py,
parallel/grid_train.py, the registry's grid entries): the JAX package's
parameters carried into the port give the JAX models' outputs, in both
spectral forms and across them; the MSE's gradients through GridTrainer
and three Adam steps match JAX's; the mode checks raise as JAX's; the
reference's ``.pth`` layout imports to JAX's parameters; the spectral conv's
explicit Hermitian input changes no bit on the CPU.

Float32 on both sides, sums in other orders: forward rel 1e-5 of the max,
gradients and losses rel 1e-4 (Adam divides by the square root of small
second moments, which magnifies float32 noise in the steps)."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_eng_super_resolution_tpu.core.checkpoint import flatten_params as jflat
from fast_eng_super_resolution_tpu.models import deeponet as jdeeponet
from fast_eng_super_resolution_tpu.models import fno as jfno
from fast_eng_super_resolution_tpu.models.registry import init_model as jinit_model
from fast_eng_super_resolution_tpu.parallel.grid_train import GridTrainer as JGridTrainer
from fast_eng_super_resolution_tpu_torch.core.checkpoint import flatten_params
from fast_eng_super_resolution_tpu_torch.models import deeponet, fno
from fast_eng_super_resolution_tpu_torch.models.registry import init_model
from fast_eng_super_resolution_tpu_torch.parallel import grid_train
from fast_eng_super_resolution_tpu_torch.parallel.grid_train import GridTrainer

FWD_TOL = 1e-5
GRAD_TOL = 1e-4

# (JAX model, port model, input shape): width 8, modes 3-4, grids 16^2 /
# 12^3 / 32, the models' default paddings (2D 9, 3D 6, 1D 0)
CASES = {
    "fno1d": (lambda: jfno.FNO1d(modes1=4, width=8, in_feats=2),
              lambda: fno.FNO1d(4, 8, in_feats=2), (2, 32, 2)),
    "fno2d": (lambda: jfno.FNO2d(modes1=4, modes2=4, width=8, in_feats=1),
              lambda: fno.FNO2d(4, 4, 8, in_feats=1), (2, 16, 16, 1)),
    "fno3d": (lambda: jfno.FNO3d(modes1=3, modes2=3, modes3=3, width=8,
                                 in_feats=1),
              lambda: fno.FNO3d(3, 3, 3, 8, in_feats=1), (2, 12, 12, 12, 1)),
}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """Tiny ops: one torch thread (a spinning pool under the other test
    workers' load costs 10x), and the model's own spectral form."""
    monkeypatch.delenv("FESR_FNO_IMPL", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _pair(name, impl, seed=0):
    """The JAX model in ``impl``, its parameters, and the port's model in
    ``impl`` holding them."""
    jm_fn, tm_fn, shape = CASES[name]
    jm = dataclasses.replace(jm_fn(), spectral_impl=impl)
    params = _np_tree(jm.init(jax.random.PRNGKey(seed)))
    tm = tm_fn()
    tm.spectral_impl = impl
    return jm, params, tm.from_jax_params(params), shape


def _input(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("impl", ["fft", "matmul"])
@pytest.mark.parametrize("name", list(CASES))
def test_fno_forward_matches_jax(name, impl):
    jm, params, tm, shape = _pair(name, impl)
    x = _input(shape)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
        other = "matmul" if impl == "fft" else "fft"
        tm.spectral_impl = other
        across = tm(torch.as_tensor(x)).numpy()
    assert got.shape == ref.shape == shape[:-1] + (128,)
    assert _rel(got, ref) < FWD_TOL
    assert _rel(across, got) < FWD_TOL


def _jax_trainer(jm, params, x, out_channels):
    """JAX's GridTrainer with ``params`` as its model's, its init's proj."""
    tr = JGridTrainer(jm, lr=1e-3, out_channels=out_channels)
    full, _ = tr.init(jax.random.PRNGKey(0), x)
    full = _np_tree(dict(full, model=params))
    return tr, full, tr.optimizer.init(full)


@pytest.mark.parametrize("impl", ["fft", "matmul"])
@pytest.mark.parametrize("name", list(CASES))
def test_fno_grads_through_grid_trainer_match_jax(name, impl):
    """The MSE through ``proj`` (128 -> 1): loss and every gradient."""
    jm, params, tm, shape = _pair(name, impl)
    x = _input(shape)
    y = _input(shape[:-1] + (1,), seed=2)
    jtr, jparams, _ = _jax_trainer(jm, params, x, 1)

    def loss_fn(p):
        out = jm.apply(p["model"], jnp.asarray(x))
        out = out @ p["proj"]["w"] + p["proj"]["b"]
        return jnp.mean((out - jnp.asarray(y)) ** 2)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    tr = GridTrainer(tm, lr=1e-3, out_channels=1)
    tr.init(0, x)
    tr.net.from_jax_params(jparams)
    loss = tr.loss(torch.as_tensor(x), torch.as_tensor(y))
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(ref_loss)) / float(ref_loss) < GRAD_TOL
    want = jflat(_np_tree(ref_grads))
    for pname, p in tr.net.named_parameters():
        key, transposed = tr.net.jax_key(pname)
        got = p.grad.numpy().T if transposed else p.grad.numpy()
        err = np.linalg.norm(got - want[key]) / np.linalg.norm(want[key])
        assert err < GRAD_TOL, (key, err)


# grids one row/column short of the modes: (shape [B, C, *S], modes)
SMALL = {1: ((1, 2, 4), (4,)), 2: ((1, 2, 7, 16), (4, 4)),
         3: ((1, 2, 12, 5, 12), (3, 3, 3))}
JAX_CONVS = {1: (jfno._spectral_conv_1d, jfno._spectral_conv1d_matmul),
             2: (jfno._spectral_conv, jfno._spectral_conv_matmul),
             3: (jfno._spectral_conv_3d, jfno._spectral_conv3d_matmul)}


@pytest.mark.parametrize("impl", [0, 1])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_check_modes_raise_on_small_grids(ndim, impl):
    """Both forms refuse a grid too small for the modes, with JAX's
    message."""
    shape, modes = SMALL[ndim]
    model = (fno.FNO1d, fno.FNO2d, fno.FNO3d)[ndim - 1](*modes, 2)
    x = np.zeros(shape, np.float32)
    jp = {k: np.asarray(v.detach()) for k, v in model.conv0.named_parameters()}
    with pytest.raises(ValueError, match="too small") as jerr:
        JAX_CONVS[ndim][impl](jp, jnp.asarray(x), *modes)
    with pytest.raises(ValueError, match="too small") as err:
        fno.spectral_conv(model, 0, torch.as_tensor(x),
                          ("fft", "matmul")[impl])
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("n", [16, 15, 265, 70])
def test_hermitian_input_changes_no_bit_on_cpu(n):
    """Dropping the DC's and Nyquist's imaginary parts before the last
    (complex-to-real) transform is what the CPU's FFT does anyway: the bits
    equal ``torch.fft.irfft`` of the raw spectrum, with the modes short of
    and reaching the Nyquist column, and after a complex transform over
    another axis (the 2D form's order)."""
    rng = np.random.default_rng(n)
    for m in (4, n // 2 + 1):
        u = torch.as_tensor((rng.normal(size=(3, 6, m))
                             + 1j * rng.normal(size=(3, 6, m))
                             ).astype(np.complex64))
        assert torch.equal(fno._irfft_last(u, n), torch.fft.irfft(u, n=n))
        full = torch.zeros(3, 6, n // 2 + 1, dtype=torch.complex64)
        full[..., :m] = u
        assert torch.equal(
            fno._irfft_last(torch.fft.ifft(u, dim=-2), n),
            torch.fft.irfft2(full, s=(6, n)))


def _pth_state_dict(ref: dict, ndim: int) -> dict:
    """The reference's torch layout of a JAX FNO tree: Linear p, k=1
    ConvNd blocks [out, in, 1...], complex spectral weights (3D: the four
    corner blocks)."""
    conv = lambda w: np.asarray(w).T.reshape(  # noqa: E731
        *np.asarray(w).T.shape, *([1] * ndim))
    sd = {"p.weight": np.asarray(ref["p"]["w"]).T,
          "p.bias": np.asarray(ref["p"]["b"])}
    blocks = [("q.mlp1", ref["q"]["mlp1"]), ("q.mlp2", ref["q"]["mlp2"])]
    for i in range(4):
        blocks += [(f"w{i}", ref[f"w{i}"])] + [
            (f"mlp{i}.mlp{j}", ref[f"mlp{i}"][f"mlp{j}"]) for j in (1, 2)]
        c = ref[f"conv{i}"]
        if ndim == 2:
            for j in (1, 2):
                sd[f"conv{i}.weights{j}"] = c[f"w{j}_re"] + 1j * c[f"w{j}_im"]
        else:
            w = c["w_re"] + 1j * c["w_im"]
            if ndim == 1:
                sd[f"conv{i}.weights1"] = w
            else:
                m1, m2 = w.shape[2] // 2, w.shape[3] // 2
                sd.update({f"conv{i}.weights1": w[:, :, :m1, :m2],
                           f"conv{i}.weights2": w[:, :, m1:, :m2],
                           f"conv{i}.weights3": w[:, :, :m1, m2:],
                           f"conv{i}.weights4": w[:, :, m1:, m2:]})
    for name, p in blocks:
        sd[f"{name}.weight"] = conv(p["w"])
        sd[f"{name}.bias"] = np.asarray(p["b"])
    return sd


@pytest.mark.parametrize("name", list(CASES) + ["deeponet"])
def test_import_pth_equals_jax(name):
    """The reference-layout state dict imports to JAX's ``import_pth``
    parameters, bit for bit (DeepONet: ``branch.{0,2,4}``,
    ``trunk.{0,2,4}``)."""
    if name == "deeponet":
        jm = jdeeponet.DeepONet(1, 2, 8, 3)
        ref = _np_tree(jm.init(jax.random.PRNGKey(0)))
        sd = {}
        for net in ("branch", "trunk"):
            for layer, i in zip(ref[net], (0, 2, 4)):
                sd[f"{net}.{i}.weight"] = layer["w"].T
                sd[f"{net}.{i}.bias"] = layer["b"]
        ports = [deeponet.DeepONet(1, 2, 8, 3),
                 deeponet.AdaptDeepONet(1, 2, 8, 3)]
    else:
        jm, ref, port, _ = _pair(name, "fft")
        sd = _pth_state_dict(ref, port.ndim)
        ports = [CASES[name][1]()]
    want = jflat(_np_tree(jm.import_pth(
        {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()})))
    for port in ports:
        got = flatten_params(port.import_pth(sd).to_jax_params())
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("cls", ["DeepONet", "AdaptDeepONet"])
def test_deeponet_forward_matches_jax(cls):
    jm = getattr(jdeeponet, cls)(1, 2, 16, 3)
    params = _np_tree(jm.init(jax.random.PRNGKey(0)))
    tm = getattr(deeponet, cls)(1, 2, 16, 3).from_jax_params(params)
    x = _input((2, 16, 16, 1))
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
    assert got.shape == ref.shape == (2, 16, 16, 1 if cls[0] == "A" else 3)
    assert _rel(got, ref) < FWD_TOL


def test_registry_grid_entries():
    """``fno`` binds in/out channels onto modes1/modes2 with in_feats 256
    unless named; ``fno1d``/``fno3d`` read ``modes``; ``deeponet`` needs
    ``trunk_size`` (JAX's KeyError); graphsage still refuses."""
    m = init_model("fno", 12, 10, width=16)
    assert isinstance(m, fno.FNO2d) and m.modes == (12, 10)
    assert m.in_feats == 256 and m.padding == 9
    assert init_model("fno", 6, 6, width=8, in_feats=1).in_feats == 1
    m1 = init_model("fno1d", 2, 1, width=12, modes=8)
    assert m1.modes == (8,) and m1.in_feats == 2 and m1.padding == 0
    m3 = init_model("fno3d", 1, 1, width=8, modes=[4, 3, 2])
    assert m3.modes == (4, 3, 2) and m3.padding == 6
    assert init_model("fno3d", 1, 1, width=8).modes == (8, 8, 8)
    for kw in ({}, {"trunk_size": 2}):
        try:
            jm = jinit_model("deeponet", 1, 1, width=16, **kw)
        except KeyError as e:
            with pytest.raises(KeyError) as err:
                init_model("deeponet", 1, 1, width=16, **kw)
            assert str(err.value) == str(e)
            continue
        m = init_model("deeponet", 1, 1, width=16, **kw)
        assert (m.trunk_input_dim, m.hidden_dim) == (jm.trunk_input_dim,
                                                     jm.hidden_dim)
    with pytest.raises(NotImplementedError, match=r"item 14 \(ii\)"):
        init_model("graphsage", 4, 4, width=8)
    with pytest.raises(NotImplementedError, match="item 16"):
        grid_train.shard_grid_epoch(None, None, None)


@pytest.mark.parametrize("proj", [True, False])
def test_grid_trainer_steps_match_jax(proj):
    """Three Adam steps as one epoch (order [3, 2]), a fourth after
    ``set_lr``, and ``evaluate``, from the same weights and order, with
    ``proj`` (target 1 channel) and without (target 128 channels: the probe
    adds none)."""
    jm, params, tm, shape = _pair("fno2d", "fft")
    c = 1 if proj else 128
    x = _input((6,) + shape[1:])
    y = _input((6,) + shape[1:-1] + (c,), seed=2) * 0.1
    order = np.random.default_rng(0).permutation(6).reshape(3, 2)
    jtr, jparams, jopt = _jax_trainer(jm, params, x, c)
    assert ("proj" in jparams) == proj
    jparams, jopt, jlosses = jtr.epoch(jparams, jopt, jnp.asarray(x),
                                       jnp.asarray(y), order)
    jopt = jtr.set_lr(jopt, 5e-4)
    jparams, jopt, jlast = jtr.step(jparams, jopt, jnp.asarray(x),
                                    jnp.asarray(y))
    tr = GridTrainer(tm, lr=1e-3, out_channels=c)
    opt = tr.init(0, x)
    assert (tr.net.proj is not None) == proj
    tr.net.from_jax_params(_jax_trainer(jm, params, x, c)[1])
    losses = tr.epoch(opt, torch.as_tensor(x), torch.as_tensor(y), order)
    tr.set_lr(opt, 5e-4)
    last = tr.step(opt, torch.as_tensor(x), torch.as_tensor(y))
    got = np.append(losses.numpy(), float(last))
    want = np.append(np.asarray(jlosses), float(jlast))
    assert np.all(np.abs(got - want) / want < GRAD_TOL), (got, want)
    ev = tr.evaluate(torch.as_tensor(x), torch.as_tensor(y))
    jev = jtr.evaluate(jparams, x, y)
    assert abs(ev - jev) / jev < GRAD_TOL
    assert (flatten_params(tr.net.to_jax_params()).keys()
            == jflat(_np_tree(jparams)).keys())


def test_grid_trainer_stacked_epoch_equals_indexed():
    """``epoch_stacked`` over pre-batched arrays takes the same steps as
    ``epoch`` over the indices (same losses, same parameters)."""
    _, params, tm, shape = _pair("fno1d", "fft")
    x, y = _input((4,) + shape[1:]), _input((4,) + shape[1:-1] + (1,), 2)
    order = np.array([[2, 0], [3, 1]])
    runs = []
    for stacked in (False, True):
        tr = GridTrainer(fno.FNO1d(4, 8, in_feats=2), lr=1e-3,
                         out_channels=1)
        opt = tr.init(3, x)
        xt, yt = torch.as_tensor(x), torch.as_tensor(y)
        losses = (tr.epoch_stacked(opt, xt[order], yt[order]) if stacked
                  else tr.epoch(opt, xt, yt, order))
        runs.append((losses, flatten_params(tr.net.to_jax_params())))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(np.array_equal(runs[0][1][k], runs[1][1][k])
               for k in runs[0][1])


def test_grid_signatures_follow_jax():
    """The port's public grid callables take JAX's parameters in JAX's
    order (the JAX side is imported only here)."""
    from fast_eng_super_resolution_tpu import grid_runner as jgr
    from fast_eng_super_resolution_tpu_torch import grid_runner as tgr

    for name in ("train_grid", "pred_grid"):
        want = list(inspect.signature(getattr(jgr, name)).parameters)
        got = list(inspect.signature(getattr(tgr, name)).parameters)
        assert got[:len(want)] == want and got[len(want):] == ["device"]


def test_auto_spectral_form(monkeypatch):
    """'auto' is 'fft' on the CPU (as in JAX) and 'matmul' on the card;
    ``FESR_FNO_IMPL`` overrides the model's own choice, and an unknown form
    raises."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for name, (_, tm_fn, _) in CASES.items():
        m = tm_fn()
        assert m.resolve_impl(cpu) == "fft"
        assert m.resolve_impl(cuda) == "matmul"
        monkeypatch.setenv("FESR_FNO_IMPL", "matmul")
        assert m.resolve_impl(cpu) == "matmul"
        monkeypatch.setenv("FESR_FNO_IMPL", "dft")
        with pytest.raises(ValueError, match="unknown spectral impl"):
            m.resolve_impl(cpu)
        monkeypatch.delenv("FESR_FNO_IMPL")
