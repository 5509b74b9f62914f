"""Port of the grid family's data and entry points (data/grid_dataset.py,
``init_dataset``'s grid names, grid_runner.py, the CLI's grid branch): the
seven one-step datasets give the JAX package's arrays bit for bit and each
package serves the other's cache; ``python -m
fast_eng_super_resolution_tpu_torch`` trains and predicts the grid models
on the CPU; checkpoints interchange both ways with the same predictions;
the task-spec guard and the diverged-run fallback behave as JAX's; the
rest of the family (rollout, ``mat_grid``, graphsage) builds."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from fast_eng_super_resolution_tpu import grid_runner as jgr
from fast_eng_super_resolution_tpu.data.dataset import init_dataset as jinit_dataset
from fast_eng_super_resolution_tpu.models.registry import init_model as jinit_model
from fast_eng_super_resolution_tpu_torch import grid_runner
from fast_eng_super_resolution_tpu_torch.core import checkpoint as ckpt
from fast_eng_super_resolution_tpu_torch.data.dataset import init_dataset
from fast_eng_super_resolution_tpu_torch.models.registry import init_model
from fast_eng_super_resolution_tpu_torch.runner import main
from fast_eng_super_resolution_tpu_torch.utils.config import parse_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each one-step dataset at a tiny size (coarse grids above the excited
# modes' Nyquist limit, short horizons)
DATASETS = {
    "turbulence_grid": dict(resolution=16, downsample=4),
    "advected_grid": dict(resolution=16, downsample=2, steps=4),
    "advected3d_grid": dict(resolution=12, downsample=2, steps=3),
    "darcy_grid": dict(resolution=16, downsample=4),
    "ns_grid": dict(resolution=16, downsample=2, t_end=0.05),
    "ns3d_grid": dict(resolution=16, downsample=2, t_frames=2, t_end=0.05),
    "burgers_grid": dict(resolution=32, downsample=4, t_end=0.05),
}
ADVECTED = dict(num_samples=8, resolution=16, downsample=2, steps=4,
                train_samples=6, idxs=[6, 7], n_clusters=1)
TRAIN = dict(epochs=2, batch_size=4, lr=0.003, step_size=30, gamma=0.1,
             val_interval=1)
PRED_TOL = 1e-5  # float32 forward on both sides, sums in other orders


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.delenv("FESR_FNO_IMPL", raising=False)
    monkeypatch.delenv("FESR_TASKSPEC_GUARD", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(DATASETS))
def test_one_step_dataset_bit_equal_to_jax_and_caches_interchange(
        tmp_path, name):
    kw = dict(DATASETS[name], num_samples=2, seed=3)
    port = init_dataset(name, root=str(tmp_path / "port"), **kw)
    ref = jinit_dataset(name, root=str(tmp_path / "jax"), **kw)
    assert type(port).__name__ == type(ref).__name__
    assert len(port) == len(ref) == 2
    for i in range(2):
        for k in ("x", "y"):
            assert port[i][k].dtype == ref[i][k].dtype
            assert np.array_equal(port[i][k], ref[i][k]), (i, k)
    # each package serves the other's cache file as it is
    for reader, root in ((jinit_dataset, "port"), (init_dataset, "jax")):
        (path,) = (tmp_path / root / "processed").iterdir()
        before = os.stat(path).st_mtime_ns
        served = reader(name, root=str(tmp_path / root), **kw)
        assert os.stat(path).st_mtime_ns == before
        assert np.array_equal(served.x, ref.x)


def test_unported_parts_refuse(tmp_path):
    """The rest of the family is ported: the rollout datasets, ``mat_grid``
    and graphsage build and ``pred_rollout`` runs (their outputs are held
    against JAX in tests/test_torch_rollout.py, test_torch_mat.py and
    test_torch_graphsage.py); an unknown dataset still raises."""
    kw = dict(num_samples=1, downsample=2, t_frames=2)
    for name, extra in (("ns_rollout", dict(resolution=16, t_end=0.01)),
                        ("advected_rollout", dict(resolution=8, max_mode=1)),
                        ("advected3d_rollout", dict(resolution=8,
                                                    max_mode=1))):
        ds = init_dataset(name, root=str(tmp_path / name), **kw, **extra)
        assert ds.rollout_eval and len(ds) == 2
    mat = init_dataset("mat_grid", root=os.path.join(REPO, "tests", "fixtures"),
                       mat_file="darcy_sample_r32_N12.mat", num_samples=2)
    assert len(mat) == 2
    assert init_model("graphsage", 4, 4).num_layers == 5
    with pytest.raises(ValueError, match="multiple of"):
        grid_runner.pred_rollout([0], "x", None, ds, {"train_samples": 3},
                                 device="cpu")
    with pytest.raises(ValueError, match="Invalid dataset"):
        init_dataset("nope", root=str(tmp_path))


def _write(tmp_path, cfg: dict, name: str) -> str:
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_python_m_trains_and_predicts_fno_on_cpu(tmp_path):
    """``python -m fast_eng_super_resolution_tpu_torch --model=fno
    --dataset=advected_grid``, ``--mode=train`` then ``--mode=pred``, with
    ``device: cpu``: the checkpoint with its task-spec stamp, finite
    ``pred_{idx}.npz`` files and the improvement line."""
    exp = _write(tmp_path, dict(ADVECTED, root=str(tmp_path / "data"),
                                device="cpu", in_channels=4,
                                out_channels=4, width=8, in_feats=1),
                 "exp.yaml")
    train = _write(tmp_path, TRAIN, "train.yaml")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for mode in ("train", "pred"):
        r = subprocess.run(
            [sys.executable, "-m", "fast_eng_super_resolution_tpu_torch",
             f"--mode={mode}", "--model=fno", "--dataset=advected_grid",
             "--exp_name=cli", f"--exp_config={exp}",
             f"--train_config={train}"],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
    assert "Prediction time:" in r.stdout and "improvement" in r.stdout
    path = tmp_path / "logs" / "models" / "collection_cli" / "partition_0.npz"
    meta = ckpt.load_meta(str(path))
    assert meta["task"] == "AdvectedScalarDataset" and meta["model"] == "FNO2d"
    assert meta["task_downsample"] == "2"
    for idx in (6, 7):
        with np.load(tmp_path / "logs" / "vtk" / "cli" / f"pred_{idx}.npz") as z:
            assert np.isfinite(z["pred"]).all()
            assert z["pred"].shape == z["ref"].shape == (16, 16, 1)


@pytest.mark.parametrize("model,dataset,extra", [
    ("fno1d", "burgers_grid", dict(in_channels=2, out_channels=1, width=8,
                                   modes=4, resolution=32, downsample=4,
                                   t_end=0.05)),
    ("fno3d", "advected3d_grid", dict(in_channels=1, out_channels=1, width=8,
                                      modes=3, resolution=12, downsample=2,
                                      steps=3)),
    ("fno3d", "ns3d_grid", dict(in_channels=2, out_channels=1, width=4,
                                modes=[2, 3, 3], resolution=16, downsample=2,
                                t_frames=4, t_end=0.05, padding=2)),
    ("deeponet", "advected_grid", dict(in_channels=1, out_channels=1,
                                       width=16, trunk_size=2)),
])
def test_cli_main_runs_each_grid_model(tmp_path, monkeypatch, capsys, model,
                                       dataset, extra):
    """runner.main's grid branch (the body of ``python -m``) trains and
    predicts each grid model on its dataset with ``device: cpu``."""
    monkeypatch.chdir(tmp_path)
    exp = _write(tmp_path, dict(ADVECTED, root=str(tmp_path / "data"),
                                device="cpu", **extra), "exp.yaml")
    train = _write(tmp_path, dict(TRAIN, epochs=1), "train.yaml")
    argv = [f"--model={model}", f"--dataset={dataset}", "--exp_name=m",
            f"--exp_config={exp}", f"--train_config={train}"]
    out = main(parse_args(["--mode=train"] + argv))
    assert os.path.exists(out["ckpt"]) and np.isfinite(out["best_val"])
    paths = main(parse_args(["--mode=pred"] + argv))
    assert [os.path.basename(p) for p in paths] == ["pred_6.npz", "pred_7.npz"]
    for p in paths:
        with np.load(p) as z:
            assert np.isfinite(z["pred"]).all()
            assert z["pred"].shape == z["ref"].shape
    assert capsys.readouterr().out.count("improvement") == 2


def _pred_arrays(log_dir, exp):
    out = {}
    for idx in ADVECTED["idxs"]:
        with np.load(os.path.join(log_dir, "vtk", exp, f"pred_{idx}.npz")) as z:
            out[idx] = z["pred"]
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_interchange_with_jax(tmp_path, writer):
    """A ``partition_0.npz`` that one package's ``train_grid`` writes is
    served by the other's ``pred_grid`` with the writer's predictions."""
    exp_cfg = dict(ADVECTED, in_channels=4, out_channels=4, width=8,
                   in_feats=1)
    kw = {k: exp_cfg[k] for k in ("num_samples", "resolution", "downsample",
                                  "steps")}
    ds = init_dataset("advected_grid", root=str(tmp_path / "data"), **kw)
    jds = jinit_dataset("advected_grid", root=str(tmp_path / "data"), **kw)
    logs = str(tmp_path / "logs")
    jmodel = jinit_model("fno", **exp_cfg)
    model = init_model("fno", **exp_cfg)
    if writer == "jax":
        jgr.train_grid("x", jmodel, jds, TRAIN, exp_cfg, log_dir=logs)
    else:
        grid_runner.train_grid("x", model, ds, TRAIN, exp_cfg, log_dir=logs,
                               device="cpu")
    jgr.pred_grid(exp_cfg["idxs"], "x", jmodel, jds, exp_cfg, log_dir=logs)
    want = _pred_arrays(logs, "x")
    grid_runner.pred_grid(exp_cfg["idxs"], "x", model, ds, exp_cfg,
                          log_dir=logs, device="cpu")
    got = _pred_arrays(logs, "x")
    for idx in want:
        err = np.abs(got[idx] - want[idx]).max() / np.abs(want[idx]).max()
        assert err < PRED_TOL, (idx, err)


def test_task_spec_guard_and_diverged_run(tmp_path, monkeypatch, capsys):
    """A run that diverges (lr 1e12) still checkpoints; serving it on a
    coarse grid of another ``downsample`` is refused, served with a warning
    under ``task_spec_guard: warn``, and silently under
    ``FESR_TASKSPEC_GUARD=off``, as in the JAX package."""
    exp_cfg = dict(ADVECTED, in_channels=4, out_channels=4, width=8,
                   in_feats=1, resolution=32, steps=2)
    kw = {k: exp_cfg[k] for k in ("num_samples", "resolution", "downsample",
                                  "steps")}
    logs = str(tmp_path / "logs")
    model = init_model("fno", **exp_cfg)
    ds = init_dataset("advected_grid", root=str(tmp_path / "a"), **kw)
    out = grid_runner.train_grid("d", model, ds, dict(TRAIN, lr=1e12),
                                 exp_cfg, log_dir=logs, device="cpu")
    assert not np.isfinite(out["best_val"]) and os.path.exists(out["ckpt"])
    other = dict(exp_cfg, downsample=4)
    ds4 = init_dataset("advected_grid", root=str(tmp_path / "b"),
                       **dict(kw, downsample=4))
    with pytest.raises(ValueError, match="task-spec mismatch"):
        grid_runner.pred_grid([6], "d", model, ds4, other, log_dir=logs,
                              device="cpu")
    capsys.readouterr()
    grid_runner.pred_grid([6], "d", model, ds4,
                          dict(other, task_spec_guard="warn"), log_dir=logs,
                          device="cpu")
    assert "WARNING: checkpoint task-spec mismatch" in capsys.readouterr().out
    monkeypatch.setenv("FESR_TASKSPEC_GUARD", "off")
    grid_runner.pred_grid([6], "d", model, ds4, other, log_dir=logs,
                          device="cpu")
    assert "WARNING" not in capsys.readouterr().out


def test_grid_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    model = init_model("fno", 4, 4, width=8, in_feats=1)
    for call in (lambda: grid_runner.train_grid("x", model, [], TRAIN, {}),
                 lambda: grid_runner.pred_grid([0], "x", model, [], {})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
