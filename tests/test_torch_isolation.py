"""The port stands alone: it imports neither jax nor the JAX package (nor
joblib, which the GPU host lacks), and its entry points run on CUDA unless
the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "fast_eng_super_resolution_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "fast_eng_super_resolution_tpu")

_CHILD = r"""
import importlib, pkgutil, sys
# the JAX package and jax, and joblib, h5py and matplotlib (which the GPU
# host lacks)
for name in ("jax", "jaxlib", "fast_eng_super_resolution_tpu", "joblib",
             "h5py", "matplotlib"):
    sys.modules[name] = None          # any import of them now fails
import numpy as np, torch
import fast_eng_super_resolution_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke                    # the card's smoke script, not run
from fast_eng_super_resolution_tpu_torch.models.registry import init_model
from fast_eng_super_resolution_tpu_torch.models.kernelnn import KernelNN
rng = np.random.default_rng(0)
n, e = 70, 400
recv = np.sort(rng.integers(0, n, e)).astype(np.int32)
send = rng.integers(0, n, e).astype(np.int32)
ea = rng.random((e, 1)).astype(np.float32)
x = torch.randn(n, 4)
graph = [torch.as_tensor(a) for a in (send, recv, ea)]
for name in ("neuralop", "teecnet"):
    m = init_model(name, 4, 4, width=8, num_layers=2)
    ea_b, sp, s, rb, bk = m.prepare_fused(send, recv, ea, n, compact=True)
    with torch.no_grad():
        out = m.apply_fused(x, torch.as_tensor(ea_b), torch.as_tensor(sp),
                            s.to("cpu"), rows_blk=rb, blk=bk)
        plain = m.apply(x, *graph)
    assert out.shape == (n, 4) and torch.isfinite(out).all()
    assert torch.isfinite(plain).all()
with torch.no_grad():  # conv mode 'pallas': the per-edge message kernel
    out = KernelNN(8, 8, 2, in_width=4, out_width=4, mode="pallas").apply(
        x, *graph)
assert out.shape == (n, 4) and torch.isfinite(out).all()
# conv mode 'edge', and the hand-written loss backward (FESR_LOSS_VJP=custom)
import os
with torch.no_grad():
    out = KernelNN(8, 8, 2, in_width=4, out_width=4, mode="edge").apply(
        x, *graph)
assert out.shape == (n, 4) and torch.isfinite(out).all()
from fast_eng_super_resolution_tpu_torch.ops.loss import gradient_weight_scalar
os.environ["FESR_LOSS_VJP"] = "custom"
pred = torch.randn(n, 4, requires_grad=True)
gradient_weight_scalar(pred, torch.randn(n, 4), *graph,
                       max_weight=1e6).backward()   # no clamp active
del os.environ["FESR_LOSS_VJP"]
assert torch.isfinite(pred.grad).all() and pred.grad.abs().sum() > 0
# the grid family: each model through init_model, one forward on the CPU
for name, kw, shape in (
        ("fno", dict(width=4, in_feats=1), (1, 8, 8, 1)),
        ("fno1d", dict(width=4, modes=3), (1, 16, 2)),
        ("fno3d", dict(width=4, modes=2, padding=2), (1, 4, 4, 4, 2)),
        ("deeponet", dict(width=8, trunk_size=2), (1, 8, 8, 2))):
    m = init_model(name, 2, 2, **kw)
    with torch.no_grad():
        out = m(torch.randn(*shape))
    assert out.shape[:-1] == shape[:-1] and torch.isfinite(out).all()
# the rest of the grid family and the host utilities
with torch.no_grad():
    out = init_model("graphsage", 4, 4).apply(x, *graph)
assert out.shape == (n, 4) and torch.isfinite(out).all()
from fast_eng_super_resolution_tpu_torch.data.dataset import init_dataset
mat = init_dataset("mat_grid", root="tests/fixtures",
                   mat_file="darcy_sample_r32_N12.mat", num_samples=2)
assert mat[0]["x"].shape == (32, 32, 2)
from fast_eng_super_resolution_tpu_torch.data.pipeline import prefetch_to_device
got = list(prefetch_to_device(iter([{"x": np.ones(2)}]), device="cpu"))
assert torch.equal(got[0]["x"], torch.ones(2, dtype=torch.float64))
from fast_eng_super_resolution_tpu_torch.utils import tracing
with tracing.trace_dir("t"), tracing.annotate("a"):
    pass
# the multi-device helpers: without a process group, one device
from fast_eng_super_resolution_tpu_torch.parallel.mesh import make_mesh
from fast_eng_super_resolution_tpu_torch.utils.env import maybe_init_distributed
assert make_mesh("cpu").size == 1 and maybe_init_distributed() is False
print("imported", len(names), "modules")
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_imports_jax_or_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    assert len(files) > 20
    bad = [(f, mod) for f in files for mod in _imports(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    from fast_eng_super_resolution_tpu_torch.models.registry import init_model
    from fast_eng_super_resolution_tpu_torch.runner import pred_graph_ALDD
    from fast_eng_super_resolution_tpu_torch.sched.scheduler import PartitionScheduler
    from fast_eng_super_resolution_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(dev)
    model = init_model("neuralop", 4, 4, width=8, num_layers=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PartitionScheduler("x", 1, [], model, train=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pred_graph_ALDD([0], "x", model, [], 1)
