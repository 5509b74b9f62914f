"""Port of data/mat_dataset.py (the FNO literature's ``.mat`` layout):
``MatGridDataset`` gives the JAX package's arrays bit for bit in both
tasks, v5 through scipy and v7.3 through h5py; without h5py a v7.3 file
raises an ImportError naming it; the grid runners train and predict on the
repo's fixture.  Mirrors tests/test_mat.py."""

import os
import sys

import numpy as np
import pytest
import scipy.io as sio
import torch

from fast_eng_super_resolution_tpu.data import mat_dataset as jmat
from fast_eng_super_resolution_tpu_torch import grid_runner
from fast_eng_super_resolution_tpu_torch.data import mat_dataset as tmat
from fast_eng_super_resolution_tpu_torch.data.dataset import init_dataset
from fast_eng_super_resolution_tpu_torch.models.fno import FNO2d

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "darcy_sample_r32_N12.mat")
ROOT, NAME = os.path.dirname(FIXTURE), os.path.basename(FIXTURE)


def _same(port, ref):
    assert len(port) == len(ref)
    for a, b in ((port.x, ref.x), (port.y, ref.y)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (port.task, port.resolution, port.downsample) == (
        ref.task, ref.resolution, ref.downsample)


def test_mat_sr_task_bit_equal_to_jax():
    port = tmat.MatGridDataset(ROOT, mat_file=NAME, downsample=4)
    _same(port, jmat.MatGridDataset(ROOT, mat_file=NAME, downsample=4))
    assert len(port) == 12 and port.resolution == 32
    s = port[0]
    assert s["x"].shape == (32, 32, 2) and s["y"].shape == (32, 32, 1)
    base_mse = float(((s["x"][..., :1] - s["y"]) ** 2).mean())
    assert 0 < base_mse < float((s["y"] ** 2).mean())
    assert abs(s["x"][..., 1]).max() <= 0.5 + 1e-6


def test_mat_upsample_aligned_and_equal_to_jax():
    rng = np.random.default_rng(3)
    d = 4
    for fine in (rng.standard_normal(32), rng.standard_normal((32, 32))):
        sub = fine[::d] if fine.ndim == 1 else fine[::d, ::d]
        up = tmat._upsample_clamped(sub, 32, d)
        assert np.array_equal(up, jmat._upsample_clamped(sub, 32, d))
        at = up[::d] if fine.ndim == 1 else up[::d, ::d]
        np.testing.assert_allclose(at, sub, atol=1e-12)


def test_mat_v73_hdf5_transpose(tmp_path):
    """An h5py-written (column-major) v7.3 file loads as scipy's fields, as
    the JAX package loads it."""
    import h5py

    ref = sio.loadmat(FIXTURE)
    p = str(tmp_path / "v73.mat")
    with h5py.File(p, "w") as f:
        f.create_dataset("coeff", data=np.ascontiguousarray(ref["coeff"].T))
        f.create_dataset("sol", data=np.ascontiguousarray(ref["sol"].T))
    got = tmat.load_mat_arrays(p, ["coeff", "sol"])
    want = jmat.load_mat_arrays(p, ["coeff", "sol"])
    for k in ("coeff", "sol"):
        assert np.array_equal(got[k], want[k])
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6)
    with pytest.raises(KeyError, match="missing key"):
        tmat.load_mat_arrays(p, ["coeff", "a"])


def test_mat_v73_without_h5py_names_the_file(tmp_path, monkeypatch):
    """Where h5py is missing (the GPU host has none), a v7.3 file raises an
    ImportError that names it and says it is v7.3; a v5 file still loads."""
    import h5py

    p = str(tmp_path / "v73.mat")
    with h5py.File(p, "w") as f:
        f.create_dataset("sol", data=np.zeros((4, 4, 2)))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match=r"v73\.mat.*v7\.3"):
        tmat.load_mat_arrays(p, ["sol"])
    assert tmat.load_mat_arrays(FIXTURE, ["sol"])["sol"].shape == (12, 32, 32)


def test_mat_operator_task_and_factory():
    port = init_dataset("mat_grid", ROOT, mat_file=NAME, task="operator",
                        num_samples=5)
    _same(port, jmat.MatGridDataset(ROOT, mat_file=NAME, task="operator",
                                    num_samples=5))
    assert port[0]["x"].shape == (32, 32, 1) and port.downsample is None


def test_mat_1d_burgers_layout(tmp_path):
    rng = np.random.default_rng(0)
    xg = np.linspace(0, 1, 64, endpoint=False)
    a = np.stack([np.sin(2 * np.pi * (xg + rng.random())) for _ in range(4)])
    sio.savemat(str(tmp_path / "burgers.mat"), {"a": a, "u": 0.5 * a + 0.1})
    kw = dict(mat_file="burgers.mat", input_key="a", target_key="u",
              downsample=4)
    port = tmat.MatGridDataset(str(tmp_path), **kw)
    _same(port, jmat.MatGridDataset(str(tmp_path), **kw))
    assert port[0]["x"].shape == (64, 2) and port[0]["y"].shape == (64, 1)


def test_mat_errors(tmp_path):
    with pytest.raises(KeyError, match="missing key"):
        tmat.MatGridDataset(ROOT, mat_file=NAME, input_key="nope")
    with pytest.raises(FileNotFoundError, match="no .mat"):
        tmat.MatGridDataset(str(tmp_path))
    with pytest.raises(ValueError, match="divisible"):
        tmat.MatGridDataset(ROOT, mat_file=NAME, downsample=5)
    with pytest.raises(ValueError, match="task"):
        tmat.MatGridDataset(ROOT, mat_file=NAME, task="inverse")


def test_mat_train_pred_end_to_end(tmp_path):
    """``train_grid`` then ``pred_grid`` on the fixture through the port,
    on the CPU: a finite prediction per held-out sample."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ds = init_dataset("mat_grid", ROOT, mat_file=NAME, downsample=4)
        model = FNO2d(modes1=8, modes2=8, width=12, in_feats=2)
        exp = dict(train_samples=8, idxs=[9], seed=0)
        logs = str(tmp_path / "logs")
        grid_runner.train_grid("mat", model, ds,
                               dict(epochs=3, batch_size=4, lr=2e-3,
                                    val_interval=1), exp, log_dir=logs,
                               device="cpu")
        (out,) = grid_runner.pred_grid([9], "mat", model, ds, exp,
                                       log_dir=logs, device="cpu")
    finally:
        torch.set_num_threads(n)
    with np.load(out) as z:
        assert np.isfinite(z["pred"]).all() and z["pred"].shape == (32, 32, 1)
