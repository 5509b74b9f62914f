"""Port of the grid rollout lane (the trajectory datasets, the dataset
factory's rollout names, ``grid_runner.pred_rollout``): the datasets give
the JAX package's arrays bit for bit and each package serves the other's
cache; ``pred_rollout`` of the port rolls a JAX-trained checkpoint to
JAX's frames, pure and guided, in 2D and 3D; 'scan' and 'stepwise' give the
same bits; a split that is not whole trajectories is refused.  Mirrors
tests/test_grid_rollout.py at smaller sizes."""

import os

import numpy as np
import pytest
import torch

from fast_eng_super_resolution_tpu import grid_runner as jgr
from fast_eng_super_resolution_tpu.data.dataset import init_dataset as jinit_dataset
from fast_eng_super_resolution_tpu.models.fno import FNO2d as JFNO2d
from fast_eng_super_resolution_tpu.models.fno import FNO3d as JFNO3d
from fast_eng_super_resolution_tpu_torch import grid_runner
from fast_eng_super_resolution_tpu_torch.data.dataset import init_dataset
from fast_eng_super_resolution_tpu_torch.models.fno import FNO2d, FNO3d

# float32 forwards on both sides, FFT sums in other orders, compounded over
# T steps of the same map: relative to the frames' max
FRAME_TOL = 1e-5

NS = dict(num_samples=3, resolution=16, downsample=2, t_frames=3,
          t_end=0.15, dt=5e-3)
ADV = dict(num_samples=3, resolution=16, downsample=2, t_frames=3,
           steps_per_frame=2)
ADV3 = dict(num_samples=2, resolution=8, downsample=2, t_frames=3,
            steps_per_frame=2, max_mode=1)
DATASETS = {"ns_rollout": NS, "advected_rollout": ADV,
            "advected3d_rollout": ADV3}
TRAIN = dict(epochs=2, batch_size=3, lr=1e-3, val_interval=1)


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.delenv("FESR_TASKSPEC_GUARD", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(DATASETS))
def test_trajectory_dataset_bit_equal_to_jax_and_caches_interchange(
        tmp_path, name):
    kw = DATASETS[name]
    port = init_dataset(name, root=str(tmp_path / "port"), guided=True, **kw)
    ref = jinit_dataset(name, root=str(tmp_path / "jax"), guided=True, **kw)
    assert type(port).__name__ == type(ref).__name__
    assert port.rollout_eval and port.guided and port.t_frames == kw["t_frames"]
    assert len(port) == len(ref) == kw["num_samples"] * kw["t_frames"]
    for field in ("trajectories", "coarse_frames", "static_fields"):
        a, b = getattr(port, field), getattr(ref, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), field
    # the trajectory-major one-step pairs, channel order [theta_t,
    # coarse_t, *static]
    for i in range(len(ref)):
        for k in ("x", "y"):
            assert np.array_equal(port[i][k], ref[i][k]), (i, k)
    s, t = divmod(len(ref) - 2, kw["t_frames"])
    x = port[len(ref) - 2]["x"]
    assert np.array_equal(x[..., 0], port.trajectories[s, t])
    assert np.array_equal(x[..., 1], port.coarse_frames[s, t])
    # each package serves the other's cache file as it is
    for reader, root in ((jinit_dataset, "port"), (init_dataset, "jax")):
        (path,) = (tmp_path / root / "processed").iterdir()
        before = os.stat(path).st_mtime_ns
        served = reader(name, root=str(tmp_path / root), **kw)
        assert os.stat(path).st_mtime_ns == before
        assert np.array_equal(served.trajectories, ref.trajectories)
        assert not served.guided and served[0]["x"].shape[-1] == (
            x.shape[-1] - 1)


def _models(name, guided):
    """(JAX model, port model) of one config for dataset ``name``."""
    if name == "advected3d_rollout":
        kw = dict(modes1=2, modes2=2, modes3=2, width=4,
                  in_feats=4 + guided, padding=2)
        return JFNO3d(**kw), FNO3d(**kw)
    in_feats = 1 + guided + (2 if name == "advected_rollout" else 0)
    kw = dict(modes1=4, modes2=4, width=6, in_feats=in_feats)
    return JFNO2d(**kw), FNO2d(**kw)


def _frames(paths):
    out = {}
    for p in paths:
        with np.load(p) as z:
            out[os.path.basename(p)] = {k: z[k] for k in z.files}
    return out


@pytest.mark.parametrize("name,guided", [
    ("ns_rollout", False), ("ns_rollout", True),
    ("advected_rollout", True), ("advected3d_rollout", True)])
def test_pred_rollout_matches_jax(tmp_path, capsys, name, guided):
    """JAX's ``train_grid`` writes one checkpoint; both packages'
    ``pred_rollout`` serve it: the same held-out trajectories, the same
    artifacts and keys, frames within FRAME_TOL, the same printed lines."""
    kw = DATASETS[name]
    jds = jinit_dataset(name, root=str(tmp_path / "data"), guided=guided, **kw)
    ds = init_dataset(name, root=str(tmp_path / "data"), guided=guided, **kw)
    jm, model = _models(name, guided)
    T, n_traj = kw["t_frames"], kw["num_samples"]
    exp = dict(train_samples=(n_traj - 1) * T, idxs=[n_traj - 1], seed=0,
               rollout_impl="scan")
    logs = str(tmp_path / "logs")
    jgr.train_grid("roll", jm, jds, dict(TRAIN, batch_size=T), exp,
                   log_dir=logs)
    capsys.readouterr()
    want = _frames(jgr.pred_rollout(exp["idxs"], "roll", jm, jds, exp,
                                    log_dir=logs))
    jax_out = capsys.readouterr().out
    got = _frames(grid_runner.pred_rollout(exp["idxs"], "roll", model, ds,
                                           exp, log_dir=logs, device="cpu"))
    port_out = capsys.readouterr().out
    assert got.keys() == want.keys() == {f"pred_{n_traj - 1}.npz"}
    for fname, w in want.items():
        g = got[fname]
        assert set(g) == set(w) == ({"pred", "ref", "input", "rollout"}
                                    | ({"coarse"} if guided else set()))
        assert g["rollout"].shape == (T, *ds.trajectories.shape[2:])
        for k in ("ref", "input") + (("coarse",) if guided else ()):
            assert np.array_equal(g[k], w[k]), k
        for k in ("rollout", "pred"):
            err = np.abs(g[k] - w[k]).max() / np.abs(w[k]).max()
            assert err < FRAME_TOL, (k, err)
        assert np.array_equal(g["pred"][..., 0], g["rollout"][-1])

    def lines(out):
        return [ln.split(":")[0] for ln in out.splitlines()
                if not ln.startswith("Prediction time")]
    assert lines(port_out) == lines(jax_out)
    assert "over 1 trajectories" in port_out


@pytest.mark.parametrize("guided", [False, True])
def test_rollout_stepwise_matches_scan(tmp_path, guided):
    """'stepwise' (each step's guidance frame uploaded as the step needs
    it) gives 'scan''s frames bit for bit, on the advected family whose
    velocity rides as static channels."""
    ds = init_dataset("advected_rollout", root=str(tmp_path / "data"),
                      guided=guided, **ADV)
    _, model = _models("advected_rollout", guided)
    T = ADV["t_frames"]
    exp = dict(train_samples=2 * T, idxs=[2], seed=0)
    logs = str(tmp_path / "logs")
    grid_runner.train_grid("roll", model, ds, dict(TRAIN, batch_size=T), exp,
                           log_dir=logs, device="cpu")
    frames = {}
    for impl in ("scan", "stepwise", "auto"):
        (p,) = grid_runner.pred_rollout([2], "roll", model, ds,
                                        dict(exp, rollout_impl=impl),
                                        log_dir=logs, device="cpu")
        with np.load(p) as z:
            frames[impl] = z["rollout"]
    assert np.isfinite(frames["scan"]).all()
    assert np.array_equal(frames["stepwise"], frames["scan"])
    assert np.array_equal(frames["auto"], frames["scan"])
    with pytest.raises(ValueError, match="rollout_impl"):
        grid_runner.pred_rollout([2], "roll", model, ds,
                                 dict(exp, rollout_impl="vmap"),
                                 log_dir=logs, device="cpu")


def test_rollout_rejects_partial_trajectory_split(tmp_path):
    """A ``train_samples`` that is not whole trajectories would count the
    boundary trajectory's training frames as held out: refused, as in the
    JAX package, before any checkpoint is read."""
    ds = init_dataset("ns_rollout", root=str(tmp_path), **NS)
    _, model = _models("ns_rollout", False)
    with pytest.raises(ValueError, match="multiple of"):
        grid_runner.pred_rollout([2], "missing", model, ds,
                                 dict(train_samples=2 * NS["t_frames"] + 1),
                                 log_dir=str(tmp_path / "logs"), device="cpu")
