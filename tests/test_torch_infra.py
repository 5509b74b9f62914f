"""Port of the host utilities and the training-layout gate: ``SubJHTDB``
(data/subsets.py), ``prefetch_to_device`` and ``ThreadedLoader``
(data/pipeline.py), ``trace_dir``/``annotate`` (utils/tracing.py),
utils/mesh_io.py, ``gaussian_interpolate_device`` (ops/interpolate.py),
the validation plots behind ``FESR_PLOT_VAL`` and
``sched.scheduler._train_layout``, each against the JAX package's
counterpart where it has one."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from fast_eng_super_resolution_tpu.data import subsets as jsubsets
from fast_eng_super_resolution_tpu.ops import interpolate as jinterp
from fast_eng_super_resolution_tpu.utils import mesh_io as jmesh_io
from fast_eng_super_resolution_tpu_torch.data import pipeline, subsets
from fast_eng_super_resolution_tpu_torch.data.dataset import SyntheticDataset
from fast_eng_super_resolution_tpu_torch.data.partition import extract_subdomains
from fast_eng_super_resolution_tpu_torch.data.synthetic import make_sample_pair
from fast_eng_super_resolution_tpu_torch.data.vtu import read_vtu
from fast_eng_super_resolution_tpu_torch.models.kernelnn import KernelNN
from fast_eng_super_resolution_tpu_torch.models.registry import init_model
from fast_eng_super_resolution_tpu_torch.models.teecnet import TEECNet
from fast_eng_super_resolution_tpu_torch.ops import interpolate
from fast_eng_super_resolution_tpu_torch.parallel.mesh import make_mesh
from fast_eng_super_resolution_tpu_torch.sched.scheduler import (
    PartitionScheduler, _train_layout)
from fast_eng_super_resolution_tpu_torch.utils import mesh_io, tracing

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


# -- SubJHTDB ----------------------------------------------------------------

def test_subjhtdb_matches_jax(tmp_path):
    """``processed/jhtdb_data.npz`` by index, ``arr_<i>`` keys in numeric
    order (arr_10 after arr_9); the legacy ``data.npz`` with a warning; no
    record: "not processed yet"."""
    rng = np.random.default_rng(0)
    arrays = [rng.random((4, 4)).astype(np.float32) for _ in range(12)]
    (tmp_path / "processed").mkdir()
    np.savez(tmp_path / "processed" / "jhtdb_data.npz", *arrays)
    idx = [2, 10, 11, 0]
    port = subsets.SubJHTDB(str(tmp_path), idx)
    ref = jsubsets.SubJHTDB(str(tmp_path), idx)
    assert len(port) == len(ref) == 4
    for i, k in enumerate(idx):
        assert np.array_equal(port[i], ref[i])
        assert np.array_equal(port[i], arrays[k])
    legacy = tmp_path / "legacy"
    (legacy / "processed").mkdir(parents=True)
    np.savez(legacy / "processed" / "data.npz", *arrays[:3])
    with pytest.warns(UserWarning, match="legacy JHTDB record"):
        got = subsets.SubJHTDB(str(legacy), [1])
    assert np.array_equal(got[0], arrays[1])
    with pytest.raises(ValueError, match="not processed yet"):
        subsets.SubJHTDB(str(tmp_path / "none"), [0])


# -- prefetch_to_device and ThreadedLoader -----------------------------------

def _batches(n):
    rng = np.random.default_rng(1)
    return [{"x": rng.random((3, 2)).astype(np.float32),
             "ids": np.arange(i, i + 3), "meta": ("tag", i)} for i in range(n)]


def test_prefetch_to_device_order_bits_and_device():
    host = _batches(7)
    got = list(pipeline.prefetch_to_device(iter(host), size=2, device="cpu"))
    assert len(got) == 7
    for g, h in zip(got, host):
        assert isinstance(g["x"], torch.Tensor) and g["x"].device == CPU
        assert np.array_equal(g["x"].numpy(), h["x"])
        assert np.array_equal(g["ids"].numpy(), h["ids"])
        assert g["meta"] == h["meta"]
    # over a one-device mesh: the whole batch on the mesh's device (a
    # rank's block of a group's batch: test_torch_multidevice.py)
    got = list(pipeline.prefetch_to_device(iter(host),
                                           sharding=make_mesh("cpu")))
    assert [g["ids"].tolist() for g in got] == [h["ids"].tolist()
                                                for h in host]
    assert got[0]["x"].device == CPU


def test_prefetch_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(pipeline.prefetch_to_device(iter(_batches(1))))


def test_prefetch_reraises_producer_error_on_consumer_side():
    def source():
        yield from _batches(2)
        raise OSError("disk went away")

    got = []
    with pytest.raises(OSError, match="disk went away"):
        for b in pipeline.prefetch_to_device(source(), device="cpu"):
            got.append(b)
    assert len(got) == 2


def test_prefetch_producer_exits_when_consumer_abandons():
    """The consumer takes one batch of an endless source and closes the
    generator: the producer thread stops (timed puts + stop flag) instead of
    blocking on the full queue."""
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield {"x": np.full(2, i, np.float32)}
            i += 1

    before = set(threading.enumerate())
    gen = pipeline.prefetch_to_device(endless(), size=2, device="cpu")
    assert next(gen)["x"][0].item() == 0
    (worker,) = set(threading.enumerate()) - before
    gen.close()
    worker.join(timeout=5.0)
    assert not worker.is_alive()
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n  # nothing produced after the stop


def test_threaded_loader_order_and_error():
    delays = np.random.default_rng(2).random(20) * 0.01

    def load(k):
        time.sleep(delays[k])
        return k * k

    assert list(pipeline.ThreadedLoader(list(range(20)), load,
                                        num_workers=4, ahead=3)) == [
        k * k for k in range(20)]

    def bad(k):
        if k == 5:
            raise KeyError(k)
        return k

    got = []
    with pytest.raises(KeyError):
        for v in pipeline.ThreadedLoader(list(range(10)), bad, num_workers=2):
            got.append(v)
    assert got == [0, 1, 2, 3, 4]


# -- tracing -----------------------------------------------------------------

def test_trace_dir_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("FESR_TRACE_DIR", raising=False)
    with tracing.trace_dir("off"):
        pass
    assert not (tmp_path / "off").exists()
    monkeypatch.setenv("FESR_TRACE_DIR", str(tmp_path))
    with tracing.trace_dir("req"):
        with tracing.annotate("fesr_region"):
            torch.ones(64).cumsum(0)
    with open(tmp_path / "req" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "fesr_region" for e in events)
    assert tracing.span is not None


# -- mesh_io -----------------------------------------------------------------

def test_mesh_io_writes_jax_vtus(tmp_path):
    """The three helpers write the VTUs the JAX package's write, array for
    array."""
    s = make_sample_pair(n_high=(6, 3, 3), n_low=(4, 2, 2), seed=0)
    pts, cells = s["pos"], s["mesh"].cells
    subs = extract_subdomains(pts, cells, s["x"], s["y"], 2,
                              "all_intersecting")
    arrays = {"a": np.ones(3, np.float64), "b": np.arange(3, dtype=np.int64),
              "c": np.ones(2, np.float16)}
    got, want = (mesh_io.convert_arrays_to_32bit(arrays),
                 jmesh_io.convert_arrays_to_32bit(arrays))
    assert {k: v.dtype for k, v in got.items()} == {
        k: v.dtype for k, v in want.items()}
    pred = s["y"][:, 0]
    for name, port_fn, jax_fn, args in (
            ("pred", mesh_io.save_graph_to_vtk, jmesh_io.save_graph_to_vtk,
             (pts, cells, pred)),
            ("parts", mesh_io.write_partition_visualization,
             jmesh_io.write_partition_visualization, (pts, cells, subs))):
        port_fn(*args, str(tmp_path / f"{name}_port.vtu"))
        jax_fn(*args, str(tmp_path / f"{name}_jax.vtu"))
        a = read_vtu(str(tmp_path / f"{name}_port.vtu"))
        b = read_vtu(str(tmp_path / f"{name}_jax.vtu"))
        assert np.array_equal(a["points"], b["points"])
        assert np.array_equal(a["cell_types"], b["cell_types"])
        for kind in ("point_data", "cell_data"):
            assert a[kind].keys() == b[kind].keys()
            for k in a[kind]:
                assert np.array_equal(a[kind][k], b[kind][k]), (name, k)


# -- gaussian_interpolate_device ---------------------------------------------

def test_gaussian_interpolate_device_matches_jax():
    """The weighted gather over host-built neighbour lists, on tensors,
    against the JAX package's jitted one and the host version: 1e-6."""
    rng = np.random.default_rng(4)
    src = rng.random((300, 3)).astype(np.float32)
    dst = rng.random((500, 3)).astype(np.float32)
    vals = rng.normal(size=(300, 4)).astype(np.float32)
    radius = 0.12
    idxs, dists, mask = interpolate.build_neighbor_lists(src, dst, radius, 16)
    got = interpolate.gaussian_interpolate_device(
        torch.as_tensor(vals), torch.as_tensor(idxs), torch.as_tensor(dists),
        torch.as_tensor(mask), radius).numpy()
    ref = np.asarray(jinterp.gaussian_interpolate_device_jit(
        vals, idxs, dists, mask, radius=radius))
    host = interpolate.gaussian_interpolate_host(src, vals, dst, radius,
                                                 max_neighbors=16)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 1e-6
    assert np.abs(got - host).max() / scale < 1e-6


# -- validation plots and the layout gate ------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return SyntheticDataset(root=str(tmp_path_factory.mktemp("synth")),
                            sub_size=4, n_high=(10, 5, 5), n_low=(6, 3, 3),
                            num_cases=1)


def test_plot_val_writes_png_from_fused_batch(synth, tmp_path, monkeypatch):
    """FESR_PLOT_VAL: each new best validation epoch writes
    ``logs/figures/{exp}/val_p0_e{epoch}.png`` from the first validation
    batch, here in the fused layout whose batch carries its graph."""
    pytest.importorskip("matplotlib")
    monkeypatch.setenv("FESR_PLOT_VAL", "1")
    model = init_model("neuralop", 4, 4, width=8, num_layers=2)
    sched = PartitionScheduler("plot", 1, synth, model, train=True,
                               log_dir=str(tmp_path), device="cpu",
                               gemm_dtype="float32")
    sched.train(dict(epochs=1, batch_size=8, lr=1e-3, val_interval=1),
                layout="fused")
    png = tmp_path / "figures" / "plot" / "val_p0_e0.png"
    assert png.exists() and png.read_bytes()[:4] == b"\x89PNG"


def test_train_layout_gate(monkeypatch):
    """'fused' only on CUDA for a model with a fused training form whose
    fused_train_ok/fused_ok holds, unless FESR_FUSED_TRAIN=0; the
    power-series TEECNet's fused forms refuse to run."""
    monkeypatch.delenv("FESR_FUSED_TRAIN", raising=False)
    kw = dict(width=8, num_layers=2)
    kernelnn = init_model("neuralop", 4, 4, **kw)
    dense = init_model("teecnet", 4, 4, **kw)
    ps = TEECNet(4, 8, 4, 2, kernel_type="powerseries")
    sage = init_model("graphsage", 4, 4)
    assert [_train_layout(m, CUDA) for m in (kernelnn, dense, ps, sage)] == [
        "fused", "fused", "merged", "merged"]
    assert _train_layout(KernelNN(8, 8, 2, in_width=4, out_width=4,
                                  kernel_rank=2), CUDA) == "fused"
    assert {_train_layout(m, CPU) for m in (kernelnn, dense, ps, sage)} == {
        "merged"}
    monkeypatch.setenv("FESR_FUSED_TRAIN", "0")
    assert _train_layout(kernelnn, CUDA) == "merged"
    for fn in (ps.apply_fused, ps.apply_fused_ad):
        with pytest.raises(ValueError, match="powerseries"):
            fn(torch.zeros(3, 4), None, None, None, rows_blk=64, blk=256)
