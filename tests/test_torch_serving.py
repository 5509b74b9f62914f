"""The port's serving slice end to end on the CPU against the JAX package:
synthetic duct -> RCB subdomains -> KernelNN (full rank, and with rank-3
factorized edge kernels) through the fused layer -> overlap-average
reconstruction -> ``.vtu``, on both serving lanes.

The JAX side reaches its fused lanes on the CPU with
``FESR_FUSED_PREDICT=force`` (Pallas in interpret mode) and one device
(``use_mesh=False``); both sides run the fused layer in float32
(``gemm_dtype``), so the comparison is of the algorithm, not of bf16
rounding.
"""

import os

import numpy as np
import pytest
import torch

import jax

from fast_eng_super_resolution_tpu.core import checkpoint as jckpt
from fast_eng_super_resolution_tpu.data.dataset import SyntheticDataset as JSynthetic
from fast_eng_super_resolution_tpu.data import reconstruct as jrec
from fast_eng_super_resolution_tpu.models.registry import init_model as jinit
from fast_eng_super_resolution_tpu.ops import fused_conv as jfc
from fast_eng_super_resolution_tpu.runner import pred_graph_ALDD as jpred
from fast_eng_super_resolution_tpu.sched.scheduler import PartitionScheduler as JSched
from fast_eng_super_resolution_tpu_torch.core import checkpoint as tckpt
from fast_eng_super_resolution_tpu_torch.data import reconstruct as trec
from fast_eng_super_resolution_tpu_torch.data.dataset import SyntheticDataset
from fast_eng_super_resolution_tpu_torch.data.vtu import read_vtu
from fast_eng_super_resolution_tpu_torch.models.registry import init_model
from fast_eng_super_resolution_tpu_torch.runner import pred_graph_ALDD
from fast_eng_super_resolution_tpu_torch.sched.scheduler import PartitionScheduler

DS_KW = dict(sub_size=4, n_high=(16, 8, 8), n_low=(8, 4, 4), num_cases=2)
MODEL_KW = dict(width=8, num_layers=2)
# the rank-r model served from a checkpoint of its own (exp names "*_r3")
LOWRANK_KW = dict(width=12, num_layers=2, kernel_rank=3)
# float32 on both sides, sums in different orders, through depth 2 and an
# overlap average: differences at the 1e-6 level -> 1e-4 of the max
TOL = 1e-4


@pytest.fixture(scope="module")
def jax_dataset(tmp_path_factory):
    return JSynthetic(root=str(tmp_path_factory.mktemp("jds")), **DS_KW)


@pytest.fixture(scope="module")
def log_dir(tmp_path_factory):
    """Checkpoints written by the JAX package's own ``save_params``: a
    full-rank model (exps "fast", "general") and a rank-3 one ("*_r3")."""
    d = str(tmp_path_factory.mktemp("logs"))
    for kw, suffix in ((MODEL_KW, ""), (LOWRANK_KW, "_r3")):
        model = jinit("neuralop", 4, 4, **kw)
        params = jax.tree_util.tree_map(np.asarray,
                                        model.init(jax.random.PRNGKey(3)))
        for exp in ("fast", "general"):
            jckpt.save_params(os.path.join(d, "models",
                                           f"collection_{exp}{suffix}",
                                           "partition_0.npz"),
                              params, meta={"model": "KernelNN"})
    return d


@pytest.fixture
def jax_fused_f32(monkeypatch):
    """Runs the JAX fused layers with float32 GEMM inputs (its serving lanes
    pass no gemm_dtype, so the default bf16 is swapped here)."""
    for name in ("fused_edge_conv", "fused_edge_conv_lowrank"):
        orig = getattr(jfc, name)

        def f32(*args, _orig=orig, **kwargs):
            kwargs["gemm_dtype"] = "float32"
            return _orig(*args, **kwargs)

        monkeypatch.setattr(jfc, name, f32)
    monkeypatch.setenv("FESR_FUSED_PREDICT", "force")


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("kernel_rank", [None, 3])
@pytest.mark.parametrize("lane,budget", [("fast", None), ("general", "5000")])
def test_pred_graph_matches_jax(lane, budget, kernel_rank, jax_dataset,
                                log_dir, jax_fused_f32, monkeypatch):
    if budget is not None:
        monkeypatch.setenv("FESR_PREDICT_EDGE_BUDGET", budget)
    kw, exp = ((MODEL_KW, lane) if kernel_rank is None
               else (LOWRANK_KW, lane + "_r3"))
    idxs = [0, 1]
    ref_paths = jpred(idxs, exp, jinit("neuralop", 4, 4, **kw),
                      jax_dataset, 1, log_dir=log_dir, use_mesh=False)
    ref = [read_vtu(p)["point_data"] for p in ref_paths]
    lanes = []
    got_paths = pred_graph_ALDD(idxs, exp, init_model("neuralop", 4, 4, **kw),
                                jax_dataset, 1, log_dir=log_dir, device="cpu",
                                gemm_dtype="float32", lanes=lanes)
    assert [lane_ for _, lane_, _ in lanes] == [lane] * len(idxs)
    for p_ref, p_got, r in zip(ref_paths, got_paths, ref):
        assert p_ref == p_got  # same file: the port wrote after JAX
        g = read_vtu(p_got)["point_data"]
        assert sorted(g) == sorted(r)
        for k in r:
            assert np.all(np.isfinite(g[k])), k
            assert g[k].shape == r[k].shape, k
            assert _rel(g[k], r[k]) < TOL, (k, _rel(g[k], r[k]))


def test_predict_weights_match_jax(jax_dataset, log_dir, jax_fused_f32):
    x = jax_dataset.get_one_full_sample(0)
    js = JSched("general", 1, jax_dataset, jinit("neuralop", 4, 4, **MODEL_KW),
                train=False, log_dir=log_dir, use_mesh=False)
    ts = PartitionScheduler("general", 1, jax_dataset,
                            init_model("neuralop", 4, 4, **MODEL_KW),
                            train=False, log_dir=log_dir, device="cpu",
                            gemm_dtype="float32")
    jp, jr, jm, jw = js.predict(x)
    tp, tr, tm, tw = ts.predict(x)
    np.testing.assert_array_equal(jm, tm)
    for a, b in zip(tp, jp):
        assert _rel(a, np.asarray(b)) < TOL
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(tw, jw):
        assert _rel(a, np.asarray(b)) < TOL


def test_port_dataset_matches_jax(jax_dataset, tmp_path):
    ds = SyntheticDataset(root=str(tmp_path / "tds"), **DS_KW)
    assert len(ds) == len(jax_dataset)
    for idx in (0, 1):
        a, b = ds.get_one_full_sample(idx), jax_dataset.get_one_full_sample(idx)
        assert len(a) == len(b)
        for da, db in zip(a, b):
            assert sorted(da) == sorted(db)
            for k in db:
                np.testing.assert_array_equal(da[k], db[k], err_msg=k)
        fa, fb = ds.full_mesh(idx), jax_dataset.full_mesh(idx)
        for k in fb:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_port_checkpoint_serves_on_jax(tmp_path):
    """``save_params`` of the port writes what the JAX package loads."""
    model = init_model("neuralop", 4, 4, seed=7, **MODEL_KW)
    path = str(tmp_path / "p.npz")
    tckpt.save_params(path, model.to_jax_params(), meta={"model": "KernelNN"})
    loaded = jckpt.load_params(path)
    assert jckpt.load_meta(path) == {"model": "KernelNN"}
    back = init_model("neuralop", 4, 4, seed=8, **MODEL_KW).from_jax_params(
        tckpt.load_params(path))
    for (ka, a), (kb, b) in zip(model.state_dict().items(),
                                back.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_array_equal(loaded["conv"]["root"],
                                  model.root.detach().numpy())


def test_overlap_average_matches_jax():
    rng = np.random.default_rng(0)
    num_nodes = 40
    gids = [rng.integers(0, num_nodes - 5, 30) for _ in range(3)]
    preds = [rng.normal(size=(30, 4)).astype(np.float32) for _ in range(3)]
    # negative weights: the guard divides only where the sum is positive
    weights = [rng.normal(size=30).astype(np.float32) for _ in range(3)]
    for w in (None, weights):
        np.testing.assert_allclose(trec.overlap_average(preds, gids, num_nodes, w),
                                   jrec.overlap_average(preds, gids, num_nodes, w))
    cat_p = np.concatenate(preds)
    cat_g = np.concatenate(gids).astype(np.int32)
    cat_w = np.concatenate(weights)
    ref = np.asarray(jrec.make_overlap_average_device(num_nodes)(
        cat_p, cat_g, cat_w))
    got = trec.overlap_average_device(torch.as_tensor(cat_p),
                                      torch.as_tensor(cat_g),
                                      torch.as_tensor(cat_w), num_nodes)
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_unported_paths_raise(jax_dataset, log_dir, monkeypatch):
    model = init_model("neuralop", 4, 4, **MODEL_KW)
    sched = PartitionScheduler("fast", 1, jax_dataset, model, train=True,
                               log_dir=log_dir, device="cpu")
    monkeypatch.setenv("FESR_PLOT_VAL", "1")  # validation plots wait
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        sched.train(dict(epochs=1, batch_size=4, lr=1e-3))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        PartitionScheduler("fast", 2, jax_dataset, model, train=False,
                           log_dir=log_dir, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pred_graph_ALDD([0], "fast", model, jax_dataset, 1, log_dir=log_dir,
                        device="cpu", smooth=True)


def test_cli_main_serves_on_cpu(tmp_path, monkeypatch, log_dir):
    """``python -m fast_eng_super_resolution_tpu_torch --mode=pred`` flow
    (runner.main) with ``device: cpu`` in the exp config."""
    import shutil

    import yaml

    from fast_eng_super_resolution_tpu_torch.runner import main
    from fast_eng_super_resolution_tpu_torch.utils.config import parse_args

    monkeypatch.chdir(tmp_path)
    shutil.copytree(os.path.join(log_dir, "models", "collection_fast"),
                    tmp_path / "logs" / "models" / "collection_cli")
    cfg = dict(n_clusters=1, in_channels=4, out_channels=4, num_layers=2,
               root=str(tmp_path / "data"), idxs=[0], device="cpu",
               **{k: v for k, v in DS_KW.items() if k != "num_cases"},
               num_cases=1, width=MODEL_KW["width"])
    (tmp_path / "exp.yaml").write_text(yaml.safe_dump(cfg))
    argv = ["--mode=pred", "--model=neuralop", "--dataset=synthetic",
            "--exp_name=cli", "--exp_config=exp.yaml"]
    paths = main(parse_args(argv))
    assert paths == [os.path.join("logs", "vtk", "cli", "pred_0.vtu")]
    fields = read_vtu(paths[0])["point_data"]
    assert all(np.all(np.isfinite(v)) for v in fields.values())
    # routed experts are still to port, in either mode
    (tmp_path / "routed.yaml").write_text(yaml.safe_dump({**cfg, "n_clusters": 2}))
    for mode in ("--mode=pred", "--mode=train"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            main(parse_args(argv[1:-1] + [mode, "--exp_config=routed.yaml"]))
