"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, each printing its own lines; any failure raises and the script exits
non-zero without the final result line:

1. device  — needs CUDA; prints the card's name and power limit.
2. build   — compiles the five kernels' nine libraries (the forward B1 as
             csrc/fused_edge_conv.cu, float32 FMAs, and
             csrc/fused_edge_conv_wgmma.cu, bfloat16 on the tensor cores; the
             backward B2 as csrc/fused_edge_conv_bwd.cu and
             csrc/fused_edge_conv_bwd_wgmma.cu; their rank-r counterparts B3
             as csrc/fused_edge_conv_lowrank.cu and
             csrc/fused_edge_conv_lowrank_wgmma.cu and B4 as
             csrc/fused_edge_conv_lowrank_bwd.cu and
             csrc/fused_edge_conv_lowrank_bwd_wgmma.cu; and B5, the
             per-edge messages of conv mode 'pallas', float32 on the tensor
             cores through exact bf16 splits as
             csrc/fused_edge_messages_wgmma.cu) from the checkout, one nvcc
             each, started together; prints ptxas's registers and spills of the
             tensor-core kernels and their blocks per SM (``[ptxas]``).
3. kernel  — B1 against its plain PyTorch version on the card, at the
             full-size serving chunk shape, on operands from the real dataset
             chunk: float32 (TF32 off) and bfloat16, compact and dense S,
             each line naming the design that ran (``design=wgmma`` for
             bfloat16 B1/B2, and B3/B4 at rank 16; ``fma`` otherwise, as
             ``fused_conv.design`` says); a tensor-core launch is repeated
             and must give the same bits.
4. bwd     — B2 against its plain version at the same shape and operands with
             a seeded output gradient, both types and both S forms (repeated
             as B1); then the differentiable layer's gradients on the card
             against the CPU's plain ones on the small mesh's graph.
   train batch — both kernels again at the shapes training gives them: the
             first layer's operands of the 12-subdomain train batch and the
             4-subdomain val batch, built as the scheduler builds them (one
             common blk); B1 and B2 (with a seeded output gradient) on both,
             both types and both S forms.
5. serve   — the port's ``pred_graph_ALDD`` on the synthetic duct at the full
             width of configs/exp_config/neuralop_synthetic_full.yaml (width
             48, depth 4) with a seeded checkpoint: two full-size meshes
             (general lane, 2 chunks x 4 layers = 8 launches each) and one
             small mesh (fast lane, 4 launches); every .vtu finite; the card's
             prediction against the port's float32 plain prediction on the CPU.
6. train   — ``train_graph_ALDD`` on the full-size meshes (16 subdomains,
             12 train / 4 val) with configs/train_config/synthetic_full.yaml
             cut to 10 epochs: finite losses that fall, B2 launched depth x
             steps times and B1 depth x (steps + validations), a checkpoint
             written, then served to a finite .vtu.
7. parity  — three float32 fused train steps on the small mesh on the card
             (kernels) and on the CPU (plain versions), same weights: the
             losses agree.
8. times   — CUDA-event medians of both kernels and their plain versions, the
             warm wall time of one full-size request and of one fused train
             step, and profiles of both.

Phases 3-8 then run again for the rank-16 path, the same config with
``kernel_rank: 16`` (edge-MLP head 2 x 16 x 48 = 1536 columns, factorized
edge kernels) and its depth cut to 2 to keep the run short: B3 and B4
against their plain versions at the same shapes (``[lowrank_kernel]``,
``[lowrank_bwd]``), serving with 4 B3 launches per full-size request and
none of B1, training with B4 launched depth x steps
times and neither B1 nor B2 (and the same training in float32, for its
loss curve beside the bfloat16 one), card-vs-CPU parity, and their times
(``[lowrank_*]`` lines).  They run a third time for TEECNet at the full
width of configs/exp_config/teecnet_ansys.yaml (width 48, 5 layers, edge MLP
K = 128) on the same meshes (``[teecnet_*]`` lines): B1 and B2 at K = 128,
10 B1 launches per full-size request, configs/train_config/teecnet.yaml cut
to 3 epochs (its loss is recorded, not held to fall).

9. pallas  — KernelNN and TEECNet built with ``mode='pallas'`` serve one
             full-size mesh each with FESR_FUSED_PREDICT=0 (the general lane's
             ``apply``): B5 launched depth x chunks times (8, 10), no other
             kernel; the prediction against the same checkpoint's 'edge3d'
             prediction on the card; each model's warm request time in
             both modes.  B5 against its plain version at both chunk shapes
             (K 48, K 128), repeated launches bit-identical, its first
             launch (the stage image of w3 and b3) bit-equal to its plain
             version, and the times of B5, its plain version and one
             einsum computing the same function (``library_ms``); its
             bound is the lesser of float32 FMAs and six bf16 tensor-core
             passes (``bound_basis``; ``bound_fma_ms`` the former).

10. routed — the paper's routed pipeline at the full width of
             configs/exp_config/neuralop_synthetic_full.yaml with
             ``n_clusters: 2`` and ``n_components: 2`` of
             configs/exp_config/neuralop_synthetic_routed.yaml added in
             memory, ``--encoder=pca --classifier=kmeans``: training on the
             full-size meshes (partition sizes, each expert's losses, B2
             launched depth x steps summed over the experts, checkpoints and
             routing state written); serving both full-size meshes through
             the routed predict (B1 launched depth x sum_k ceil(n_k /
             chunk_b) times for the request's label counts n_k), full
             mesh 0 again with a smaller budget (a padded tail chunk in a
             label group) and a larger one (the routed lane over at least
             two label groups), and the small mesh through the routed lane;
             every .vtu finite, labels
             on the card equal to the CPU's, the prediction against the
             port's float32 plain one on the CPU; B1 and B2 against their
             plain versions on a routed chunk's and an expert's batches;
             warm times of a routed full-size request and a routed-lane
             request (``[routed_*]`` lines).
11. coalesced — R = 4 seeded payloads on the small mesh through
             ``predict_full_batch``, each against its own ``predict_full``,
             and the batch's warm time against R single requests
             (``[coalesced*]`` lines).

12. physics_ops — every physics operator on the full mesh's duct (27 648
             nodes, K 16) with the analytic field plus noise 0.05: both
             weight operators (and the fallback-branch nodes counted on both
             sides), both divergences, the Laplacian, the composite A and its
             adjoint A^T in both forms, the pressure correction and one CGNR
             solve at 20 iterations, card against the port's CPU results;
             the adjoint's dot-product test in float64 on the card; the
             composite pair's time against its bound, and the masked CG's
             cost per inner iteration (``[physics_ops]``).
13. physics_smooth — ``pred_graph_ALDD(smooth=True)`` on both full meshes
             from the serve phase's checkpoint (B1 8 times each, counted as
             B1's ``smooth`` launches): initial and final divergence, ratio,
             the projection's and the request's wall time; two projections
             of one field give the same bits; on the small mesh the card's
             host and device loops against the CPU's.
14. physics_amg — the AMG host build on the full mesh (seconds, level
             sizes), one V-cycle card vs CPU on the same hierarchy, and the
             device loop with ``precond='amg'`` against ``'none'``.
15. physics_scale — the device loop at 97 556 nodes
             (benchmarks/projection_scale.py's field; the reference's
             500k-1M nodes are cut to fit the time limit), plain and AMG.
16. wss     — ``python -m fast_eng_super_resolution_tpu_torch.compute_wss``
             on the first smoothed .vtu, each field's .vtp against the CPU,
             and the analytic shear on a duct.
17. powerseries — TEECNet at teecnet_ansys.yaml's width with
             ``kernel_type='powerseries'``: one full-size request through the
             general lane, no kernel launched; the small mesh card vs CPU.
18. lut     — KernelNN at full width in mode 'lut' and with
             ``kernel_dtype='bfloat16'`` in mode 'edge3d', the same way.

19. grid    — the one-step grid family, which runs no hand-written kernel
             (B1-B5 launched 0 times across these phases), at the published
             widths, modes, resolution, padding and batch of
             configs/exp_config/fno_advected_256.yaml (FNO2d, width 16,
             modes 12, 256^2 padded to 265^2, batch 32),
             fno3d_advected_64.yaml (FNO3d, width 16, modes 8, 64^3 padded
             to 70^3, batch 16), fno_burgers.yaml (FNO1d, width 32, modes
             16, 256 points) and deeponet_advected.yaml (width 128, 64^2,
             trunk_size 2), each with its recipe (fno_advected.yaml,
             fno3d_advected.yaml).  Cut: the sample count (72, 24, 40, 40,
             with train_samples 64, 16, 32, 32 and the idxs to match; the
             datasets are generated in worker processes during phases
             2-18) and the recipe's 300 epochs to 10.  ``[grid_spectral]``:
             one spectral conv per FNO, 'fft' (cuFFT) vs 'matmul' on the
             card vs the CPU, their warm times and the form 'auto' takes;
             ``[grid_train]``: ``train_grid`` per model (finite losses,
             FNO2d's falling, the stamped checkpoint, the warm step, the
             peak memory); ``[grid_parity]``: three FNO2d steps card vs
             CPU; ``[grid_serve]``: ``pred_grid`` per checkpoint (finite
             .npz, the improvement factors, the warm request).

The second-to-last line is a JSON object with the kernels' numbers, the last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fast_eng_super_resolution_tpu_torch.core import checkpoint as ckpt  # noqa: E402
from fast_eng_super_resolution_tpu_torch.core.graph import merge_batch, pad_and_bucket  # noqa: E402
from fast_eng_super_resolution_tpu_torch.data.dataset import init_dataset  # noqa: E402
from fast_eng_super_resolution_tpu_torch.data.synthetic import duct_field, make_duct_mesh  # noqa: E402
from fast_eng_super_resolution_tpu_torch.data.tensorize import cells_to_edges  # noqa: E402
from fast_eng_super_resolution_tpu_torch.data.vtu import read_vtu  # noqa: E402
from fast_eng_super_resolution_tpu_torch.models.kernelnn import KernelNN  # noqa: E402
from fast_eng_super_resolution_tpu_torch.models.registry import init_model  # noqa: E402
from fast_eng_super_resolution_tpu_torch.models.teecnet import TEECNet, _leaky_relu  # noqa: E402
from fast_eng_super_resolution_tpu_torch.ops import fused_conv, pallas_mp  # noqa: E402
from fast_eng_super_resolution_tpu_torch.ops.message_passing import apply_edge_mlp_hidden  # noqa: E402
from fast_eng_super_resolution_tpu_torch.physics import amg as pamg  # noqa: E402
from fast_eng_super_resolution_tpu_torch.physics import divergence as pdiv  # noqa: E402
from fast_eng_super_resolution_tpu_torch.physics import projection as pproj  # noqa: E402
from fast_eng_super_resolution_tpu_torch.physics.projection import DivergenceFreeProjection  # noqa: E402
from fast_eng_super_resolution_tpu_torch.physics.wss import compute_wall_shear_stress  # noqa: E402
from fast_eng_super_resolution_tpu_torch.parallel.train import (  # noqa: E402
    Trainer, make_fused_batch, make_fused_batches, train_val_split)
from fast_eng_super_resolution_tpu_torch.runner import pred_graph_ALDD, train_graph_ALDD  # noqa: E402
from fast_eng_super_resolution_tpu_torch.sched.classifiers import init_classifier  # noqa: E402
from fast_eng_super_resolution_tpu_torch.sched.encoders import init_encoder  # noqa: E402
from fast_eng_super_resolution_tpu_torch.sched.scheduler import PartitionScheduler  # noqa: E402
from fast_eng_super_resolution_tpu_torch.sched.serving import _as_raw_graph, edge_budget  # noqa: E402
from fast_eng_super_resolution_tpu_torch.utils.config import load_yaml  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
BASE_CONFIG = os.path.join(REPO, "configs", "exp_config",
                           "neuralop_synthetic_full.yaml")
TRAIN_CONFIG = os.path.join(REPO, "configs", "train_config",
                            "synthetic_full.yaml")
TRAIN_EPOCHS = 10  # the one cut of synthetic_full.yaml (300 epochs)
TEECNET_CONFIG = os.path.join(REPO, "configs", "exp_config",
                              "teecnet_ansys.yaml")
TEECNET_TRAIN = os.path.join(REPO, "configs", "train_config", "teecnet.yaml")
TEECNET_EPOCHS = 3  # the one cut of teecnet.yaml (151 epochs)
# the routed path: the full config with this config's n_clusters and
# n_components added in memory, trained TRAIN_EPOCHS epochs
ROUTED_CONFIG = os.path.join(REPO, "configs", "exp_config",
                             "neuralop_synthetic_routed.yaml")
COALESCED_R = 4  # requests per coalesced batch
FULL = dict(n_high=(48, 24, 24), n_low=(20, 10, 10), sub_size=8, num_cases=2)
SMALL = dict(n_high=(16, 8, 8), n_low=(8, 4, 4), sub_size=4, num_cases=1)
SEED = 0
CHUNKS = {"full": 2, "small": 1}  # per request; launches = chunks x depth
RANK = 16  # the rank-r path's kernel_rank (the JAX package's lowrank16 rows)
RANK_DEPTH = 2  # its depth, cut from the config's 4 to keep the run short
KERNELS = (fused_conv.fused_edge_conv, fused_conv.fused_edge_conv_bwd,
           fused_conv.fused_edge_conv_lowrank,
           fused_conv.fused_edge_conv_lowrank_bwd,
           pallas_mp.fused_edge_messages)
# rank-r? -> (wrapper, plain version, CUDA launcher), forward and backward
FWD = {False: (fused_conv.fused_edge_conv, fused_conv.fused_edge_conv_plain,
               fused_conv.fused_edge_conv_cuda),
       True: (fused_conv.fused_edge_conv_lowrank,
              fused_conv.fused_edge_conv_lowrank_plain,
              fused_conv.fused_edge_conv_lowrank_cuda)}
BWD = {False: (fused_conv.fused_edge_conv_bwd,
               fused_conv.fused_edge_conv_bwd_plain,
               fused_conv.fused_edge_conv_bwd_cuda),
       True: (fused_conv.fused_edge_conv_lowrank_bwd,
              fused_conv.fused_edge_conv_lowrank_bwd_plain,
              fused_conv.fused_edge_conv_lowrank_bwd_cuda)}

# Kernel vs plain version on the card, relative to the output's max.  Both
# round h, x and w3 to the GEMM type identically and then work in float32,
# summing ~2.4k products per slot in different orders: ~1e-6 expected (B3
# too: its uv, t and msg stay float32 on both sides).
KERNEL_TOL = {"float32": 5e-5, "bfloat16": 1e-4}
# B2 (and B4) vs its plain version, each output relative to its own max: both
# round h, x_src, w3 and dmsg (one exact product per slot) identically, then
# sum float32 products in different orders (dw3: over ~250k slots).
# The differentiable layer on the card vs the CPU's plain versions (float32,
# index_add_ atomics on the card) and the fused train losses card vs CPU
# (float32, 3 steps of Adam): 1e-4.
BWD_TOL = {"float32": 5e-5, "bfloat16": 1e-4}
GRAD_TOL = 1e-4
PARITY_TOL = 1e-4
# Served bf16 prediction vs the CPU float32 plain prediction: bf16 rounding of
# the GEMM inputs (2^-8 relative) through 4-5 layers -> 3e-2 of the max.
SERVE_TOL = 3e-2
# B5 vs its plain version (both float32, TF32 off, sums of (K+1) c_in
# products in other orders), and the 'pallas' prediction vs the 'edge3d' one
# (float32 end to end, through 4-5 layers and the overlap average), each
# relative to the max.
MSG_TOL = 5e-5
PALLAS_TOL = 1e-4
# A coalesced request vs the same request alone: the same kernel launches
# (bit-identical) and the same segment sums, whose index_add_ atomics may
# add in another order: 1e-6 of the max.
COALESCED_TOL = 1e-6

# The grid family, one path per shipped config at its published widths,
# modes, resolution, padding and batch size; cut: the sample count (and
# train_samples and idxs with it) and the recipe's epochs (300).  FNO1d and
# DeepONet train with fno_advected.yaml, as their configs' comments say.
GRID = {
    "fno2d": dict(model="fno", dataset="advected_grid",
                  exp="fno_advected_256.yaml", train="fno_advected.yaml",
                  num_samples=72, train_samples=64),
    "fno3d": dict(model="fno3d", dataset="advected3d_grid",
                  exp="fno3d_advected_64.yaml", train="fno3d_advected.yaml",
                  num_samples=24, train_samples=16),
    "fno1d": dict(model="fno1d", dataset="burgers_grid",
                  exp="fno_burgers.yaml", train="fno_advected.yaml",
                  num_samples=40, train_samples=32),
    "deeponet": dict(model="deeponet", dataset="advected_grid",
                     exp="deeponet_advected.yaml", train="fno_advected.yaml",
                     num_samples=40, train_samples=32),
}
GRID_EPOCHS = 10
# One spectral conv, card 'fft' vs card 'matmul' vs CPU 'fft' (float32,
# TF32 off; FFTs and DFT sums in other orders over up to 265 points),
# relative to the max; FNO2d's first three train losses card vs CPU.
GRID_SPECTRAL_TOL = 1e-5
GRID_PARITY_TOL = 1e-4

# H100 SXM data sheet: HBM rate and dense peaks per input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches_of(*kernels) -> dict:
    return {k.__name__: k.launches for k in kernels}


def check_only(label: str, want: dict) -> None:
    """Raises unless each kernel of ``want`` launched as often as it says and
    every other kernel not at all since ``reset_launches``."""
    got = launches_of(*KERNELS)
    want = {k.__name__: want.get(k, 0) for k in KERNELS}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def prefix(model) -> str:
    """The log prefix of the path ``model`` runs: '' (KernelNN at full
    rank), 'lowrank_' (KernelNN at rank r) or 'teecnet_'."""
    if isinstance(model, TEECNet):
        return "teecnet_"
    return "" if model.kernel_rank is None else "lowrank_"


def rank_of(model):
    return getattr(model, "kernel_rank", None)


def make_model(cfg: dict):
    """The seeded model of ``cfg``: KernelNN (full rank, or rank
    ``kernel_rank``) or TEECNet, as ``cfg['model']`` names it."""
    return init_model(cfg["model"], cfg["in_channels"], cfg["out_channels"],
                      seed=SEED, kernel_rank=cfg.get("kernel_rank"),
                      **{k: cfg[k] for k in ("width", "num_layers")})


def make_pallas_model(cfg: dict):
    """The model of ``cfg`` in conv mode 'pallas': the mode is a constructor
    argument (never read from a config), so the model is built directly."""
    if cfg["model"] == "teecnet":
        return TEECNet(cfg["in_channels"], cfg["width"], cfg["out_channels"],
                       cfg["num_layers"], mode="pallas", seed=SEED)
    w = cfg["width"]
    return KernelNN(w, w, cfg["num_layers"], in_width=cfg["in_channels"],
                    out_width=cfg["out_channels"], mode="pallas", seed=SEED)


def conv_parts(model):
    """(edge MLP, its activation, the map from fc1's output to the conv
    layer's node features) of ``model``'s shared conv."""
    if isinstance(model, TEECNet):
        return model.kernel.edge_mlp, _leaky_relu, model.kernel.linear
    return model.edge_mlp, torch.relu, lambda h: h


def layer_operands(model, ea, x) -> tuple:
    """(h_e, x, w3, b3) the model's first conv layer takes for blocked (or
    per-edge) edge attributes ``ea`` and node inputs ``x``."""
    edge_mlp, act, node_map = conv_parts(model)
    with torch.no_grad():
        h_e = apply_edge_mlp_hidden(edge_mlp, ea, act).contiguous()
        xl = node_map(model.fc1(x)).contiguous()
        w3 = edge_mlp[-1].weight.t().contiguous()
        b3 = edge_mlp[-1].bias.detach().contiguous()
    return h_e, xl, w3, b3


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    log("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi


def make_config(root: str, sizes: dict, base: str = BASE_CONFIG,
                model: str = "neuralop", train: str = TRAIN_CONFIG,
                epochs: int = TRAIN_EPOCHS) -> dict:
    """The shipped full-width config ``base`` with this run's mesh sizes and
    root, and (in memory only) the model type, train config and epoch cut of
    the path it drives."""
    cfg = load_yaml(base)
    cfg.update(sizes, root=os.path.join(root, "data"),
               idxs=list(range(sizes["num_cases"])), model=model,
               train_config=train, train_epochs=epochs)
    return cfg


def write_checkpoint(log_dir: str, exp: str, cfg: dict):
    model = make_model(cfg)
    ckpt.save_params(os.path.join(log_dir, "models", f"collection_{exp}",
                                  "partition_0.npz"),
                     model.to_jax_params(),
                     meta={"model": type(model).__name__})
    return model


def chunk_operands(dataset, model, device, idx=None):
    """The first serving chunk of mesh 0 (the scheduler's chunking), or its
    subdomains ``idx`` (a routed chunk), and the first layer's fused
    operands on ``device``."""
    raw = [_as_raw_graph(d) for d in dataset.get_one_full_sample(0)]
    (_, _, batch), = pad_and_bucket(raw, uniform=True)
    if idx is None:
        idx = np.arange(max(1, edge_budget() // batch.senders.shape[1]))
    chunk = batch.map(lambda a: a[idx])
    merged, _ = merge_batch(chunk)
    ea_b, sp, sm, rows_blk, blk = model.prepare_fused(
        merged.senders, merged.receivers, merged.edge_attr,
        merged.x.shape[0], merged.edge_mask, compact=True)
    m = model.to(device)
    h_e, x, w3, b3 = layer_operands(
        m, torch.as_tensor(ea_b, device=device),
        torch.as_tensor(merged.x, device=device))
    msg = None
    if rank_of(model) is None:
        # B5's operands at full rank: every edge of the merged chunk,
        # padding included, as the general lane's 'pallas' apply hands them
        hid, xl, _, _ = layer_operands(
            m, torch.as_tensor(merged.edge_attr, device=device),
            torch.as_tensor(merged.x, device=device))
        src = torch.as_tensor(merged.senders, device=device).long()
        msg = (hid, xl[src].contiguous(), w3, b3)
    return dict(h=h_e, x=x, sp=torch.as_tensor(sp, device=device),
                w3=w3, b3=b3, s=sm.to(device), rows_blk=rows_blk, blk=blk,
                n=merged.x.shape[0], b=chunk.x.shape[0], rank=rank_of(model),
                tag=prefix(model), msg=msg)


def layer_kw(op) -> dict:
    """The layer's keyword arguments for the operands ``op``."""
    c = op["x"].shape[1]
    kw = dict(c_in=c, c_out=c, rows_blk=op["rows_blk"], blk=op["blk"])
    if op["rank"] is not None:
        kw["rank"] = op["rank"]
    return kw


def layer(op, gemm_dtype, plain=False, dense=False):
    """B1 (B3 for a rank-r model's operands) or its plain version."""
    wrapper, plain_fn, _ = FWD[op["rank"] is not None]
    s = op["s"]
    if dense:
        s = fused_conv.expand_s(s.slot_rows, s.row_weight,
                                rows_blk=op["rows_blk"], blk=op["blk"])
    return (plain_fn if plain else wrapper)(
        op["h"], op["x"], op["sp"], op["w3"], op["b3"], s,
        gemm_dtype=gemm_dtype, **layer_kw(op))


def design_of(op, gemm_dtype: str) -> str:
    """The design the kernel of ``op`` runs in ``gemm_dtype``: bfloat16 on
    the tensor cores ('wgmma': B1/B2, and B3/B4 at a rank that is a multiple
    of 8), else ('fma') float32 FMAs on the CUDA cores."""
    return fused_conv.design(getattr(torch, gemm_dtype), op["rank"])


def check_repeat(label: str, at: str, dt: str, dense: bool, first,
                 second) -> None:
    """Raises unless a second launch on the same inputs gave the same bits
    (the tensor-core kernels sum in a fixed order, with no atomics)."""
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(label, at=at, dtype=dt, s="dense" if dense else "compact",
        second_launch_bit_identical=same)
    if not same:
        raise AssertionError(f"{label} at {at} {dt}: two launches differ")


def log_ptxas() -> None:
    """Registers and spills of the tensor-core kernels, as ptxas reported
    them when the libraries were built (and any wgmma serialization it
    warned of), and their blocks per SM at width 48 and K 48 and 128
    (B1/B2, B5) and at K 48, rank 16 (B3/B4)."""
    import re
    for lib in ("fused_edge_conv_wgmma", "fused_edge_conv_bwd_wgmma",
                "fused_edge_conv_lowrank_wgmma",
                "fused_edge_conv_lowrank_bwd_wgmma",
                "fused_edge_messages_wgmma"):
        name, spills = None, ("?", "?")
        for line in fused_conv.ptxas_report(lib).splitlines():
            if "wgmma" in line and "erialized" in line:
                log("ptxas", lib=lib, warning=repr(line.strip()[:200]))
            m = re.search(r"Function properties for \S*?"
                          r"(lowrank_fwd_wgmma|lowrank_bwd_rows_wgmma|"
                          r"lowrank_bwd_weights_wgmma|conv_fwd_wgmma|"
                          r"bwd_rows_wgmma|bwd_weights_wgmma|"
                          r"messages_wgmma(?=I))"
                          r"(?:ILi(\d+)E)?(?:Li(\d+)E)?", line)
            if m:
                arg = m.group(2)
                if arg and m.group(1).startswith("lowrank"):
                    arg = f"r{8 * int(arg)}"  # the template's r / 8
                if m.group(3):  # B5: N = c_out padded, S k16 steps of c_in
                    arg = f"N{arg},S{m.group(3)}"
                name = m.group(1) + (f"<{arg}>" if arg else "")
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if name and m:
                spills = m.groups()
                continue
            m = re.search(r"Used (\d+) registers", line)
            if name and m:
                log("ptxas", lib=lib, kernel=name, registers=m.group(1),
                    spill_stores=spills[0], spill_loads=spills[1])
                name = None
    for k in (48, 128):
        log("ptxas", k=k, c=48, blocks_per_sm=fused_conv.occupancy(k, 48, 48))
    log("ptxas", k=48, c=48, rank=RANK,
        blocks_per_sm=fused_conv.occupancy(48, 48, 48, rank=RANK))
    b5 = fused_conv._load_kernel("fused_edge_messages_wgmma")
    for k in (48, 128):
        log("ptxas", kernel="messages_wgmma", k=k, c=48,
            blocks_per_sm=b5.fused_edge_messages_wgmma_blocks_per_sm(k, 48, 48),
            smem_bytes=b5.fused_edge_messages_wgmma_smem_bytes(k, 48, 48))


def phase_kernel(op, at: str = "chunk", errs: dict | None = None) -> dict:
    """B1 (B3 on the rank-r path) against its plain version on ``op`` (the
    operands at shape ``at``); returns ``errs`` with each type's largest
    absolute error."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    slots, k = op["h"].shape
    label = op["tag"] + "kernel"
    log(label, at=at, n=op["n"], subdomains=op["b"],
        num_blocks=slots // op["blk"], blk=op["blk"], slots=slots,
        real_slots=int((op["s"].slot_rows >= 0).sum()), k=k,
        c=op["x"].shape[1], rank=op["rank"])
    errs = {} if errs is None else errs
    with torch.no_grad():
        for dt in ("float32", "bfloat16"):
            ref = layer(op, dt, plain=True)
            for dense in (False, True):
                got = layer(op, dt, dense=dense)
                torch.cuda.synchronize()
                abs_err = (got - ref).abs().max().item()
                rel = abs_err / ref.abs().max().item()
                log(label, at=at, dtype=dt, s="dense" if dense else "compact",
                    design=design_of(op, dt), max_abs_err=f"{abs_err:.3e}",
                    rel_to_max=f"{rel:.3e}", tol=KERNEL_TOL[dt])
                if not (rel <= KERNEL_TOL[dt]):
                    raise AssertionError(f"{label} at {at} {dt} dense={dense}: "
                                         f"{rel:.3e} > {KERNEL_TOL[dt]}")
                errs[dt] = max(errs.get(dt, 0.0), abs_err)
                if design_of(op, dt) == "wgmma":
                    check_repeat(label, at, dt, dense, (got,),
                                 (layer(op, dt, dense=dense),))
            del ref, got
    torch.cuda.empty_cache()
    return errs


def serve(ds, model, idxs, log_dir, exp, device, n: int = 1, **kw):
    """``pred_graph_ALDD`` of meshes ``idxs`` from exp ``exp``'s ``n``
    experts: (lanes, each .vtu's point data), every field finite."""
    lanes = []
    paths = pred_graph_ALDD(idxs, exp, model, ds, n, log_dir=log_dir,
                            device=device, lanes=lanes, **kw)
    fields = []
    for p in paths:
        pd_ = read_vtu(p)["point_data"]
        for key, v in pd_.items():
            if not np.all(np.isfinite(v)):
                raise AssertionError(f"{p}: non-finite {key}")
        fields.append(pd_)
    return lanes, fields


def phase_serve(root: str, datasets: dict, models: dict, cfgs: dict,
                tag: str = "") -> int:
    """Serves both full-size meshes and the small one from the checkpoints
    of exps ``full{tag}`` and ``small{tag}``: lanes, launches (B1, or B3
    for a rank-r model, and no other kernel), finite fields, and the card's
    bf16 prediction against the port's float32 plain one on the CPU."""
    log_dir = os.path.join(root, "logs")
    rank = rank_of(models["full"])
    label = prefix(models["full"]) + "serve"
    kernel = FWD[rank is not None][0]
    launches = 0
    card = {}
    for name, idxs in (("full", cfgs["full"]["idxs"]), ("small", [0])):
        for idx in idxs:
            reset_launches()
            t0 = time.time()
            lanes, fields = serve(datasets[name], models[name], [idx],
                                  log_dir, name + tag, None)
            torch.cuda.synchronize()
            got = kernel.launches
            launches += got
            want_lane = "general" if name == "full" else "fast"
            log(label, mesh=name, idx=idx, lane=lanes[0][1],
                reason=repr(lanes[0][2]), launches=got,
                nodes=len(fields[0]["pressure"]),
                cold_s=f"{time.time() - t0:.3f}")
            if lanes[0][1] != want_lane:
                raise AssertionError(f"{name} mesh took lane {lanes[0][1]}")
            check_only(f"{label} {name} request",
                       {kernel: CHUNKS[name] * cfgs[name]["num_layers"]})
            card[(name, idx)] = fields[0]
    # the card's bf16 serving against the port's float32 plain version on the
    # CPU, same checkpoint and mesh
    for name in ("full", "small"):
        t0 = time.time()
        _, (ref,) = serve(datasets[name], models[name], [0], log_dir,
                          name + tag + "_cpu", "cpu", gemm_dtype="float32")
        for key in ("velocity", "pressure"):
            r, g = ref[key], card[(name, 0)][key]
            rel = np.abs(g - r).max() / np.abs(r).max()
            log(label, mesh=name, field=key, vs_cpu_f32=f"{rel:.3e}",
                tol=SERVE_TOL, cpu_s=f"{time.time() - t0:.1f}")
            if not rel <= SERVE_TOL:
                raise AssertionError(f"{name} {key}: {rel:.3e} > {SERVE_TOL}")
    return launches


def fwd_times(op, smi) -> dict:
    """B1's (B3's on the rank-r path) and its plain version's CUDA-event
    medians at the operands ``op``, and its bound."""
    t = {}
    rank = op["rank"]
    _, plain, launcher = FWD[rank is not None]
    kw = layer_kw(op)
    log(op["tag"] + "times", kernel="fwd", k=op["h"].shape[1],
        c=op["x"].shape[1])
    with torch.no_grad():
        for dt in ("bfloat16", "float32"):
            # operands already in the GEMM type, as apply_fused hands them
            # over (it casts h and w3 once per forward, x once per layer)
            tdt = getattr(torch, dt)
            h, x, w3 = (op[key].to(tdt).contiguous() for key in ("h", "x", "w3"))
            t[f"ms_{dt}"] = cuda_ms(lambda: launcher(
                h, x, op["sp"], w3, op["b3"], op["s"], **kw))
            t[f"plain_ms_{dt}"] = cuda_ms(
                lambda: plain(h, x, op["sp"], w3, op["b3"], op["s"],
                              gemm_dtype=dt, **kw), reps=5)
    # bound: real slots' operations at the input type's peak vs every input
    # byte read once and the output written once.  Per slot: the kernel GEMM
    # over K+1 rows (b3 the last) -- [h (x) x, x] W~ at full rank, uv = h~ W~
    # at rank r, then t = U^T x and msg = V t -- and the S weight
    slots, k = op["h"].shape
    c = op["x"].shape[1]
    real = int((op["s"].slot_rows >= 0).sum())
    if rank is None:
        flops = real * (2 * (k + 1) * c * c + 2 * c)
    else:
        flops = real * (2 * (k + 1) * op["w3"].shape[1] + 4 * rank * c + 2 * c)
    for dt, size in (("bfloat16", 2), ("float32", 4)):
        nbytes = (size * (op["h"].numel() + op["x"].numel() + op["w3"].numel())
                  + 4 * (op["b3"].numel() + op["sp"].numel()
                         + op["s"].slot_rows.numel() + op["s"].row_weight.numel()
                         + (slots // op["blk"]) * op["rows_blk"] * c))
        t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_PER_S
        t[f"bound_ms_{dt}"] = max(t_ops, t_bytes) * 1e3
        t[f"bound_by_{dt}"] = "operations" if t_ops >= t_bytes else "bytes"
        t[f"flops_{dt}"], t[f"bytes_{dt}"] = flops, nbytes
    log_times(op["tag"] + "times", "fwd", t, smi)
    return t


def log_times(label: str, kernel: str, t: dict, smi) -> None:
    for key, v in t.items():
        log(label, kernel=kernel,
            **{key: v if isinstance(v, (int, str)) else f"{v:.4f}"},
            card=repr(smi))


def request_times(datasets, models, root, smi, tag: str = "") -> dict:
    """One warm full-size request (exp ``full{tag}``): predict (2 chunks) +
    node weights + host overlap average, on a scheduler whose operand cache
    is warm; median of 5 and one profile."""
    ms, request = warm_request(datasets["full"], models["full"],
                               os.path.join(root, "logs"), "full" + tag)
    label = prefix(models["full"]) + "times"
    t = {"request_ms": ms}
    t.update(profile_call(request, label + "_request"))
    log_times(label, "request", t, smi)
    return t


def warm_ms(fn, reps: int = 5) -> float:
    """Median wall ms of ``reps`` calls of ``fn`` after one warm-up, each
    ending in a device sync."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def warm_request(ds, model, log_dir: str, exp: str, n: int = 1,
                 **routing) -> tuple:
    """(median wall ms of 5 full-size requests of mesh 0 after one warm-up,
    the request): predict + host overlap average, ending in a device sync,
    on a scheduler serving ``model`` from exp ``exp``'s checkpoints (``n``
    experts, routed by ``routing``'s encoder and classifier)."""
    from fast_eng_super_resolution_tpu_torch.data.reconstruct import overlap_average

    sched = PartitionScheduler(exp, n, ds, model, train=False,
                               log_dir=log_dir, **routing)
    x = ds.get_one_full_sample(0)
    num_nodes = len(ds.full_mesh(0)["points"])
    gids = [d["global_node_ids"] for d in x]

    def request():
        pred_l, _, _, _ = sched.predict(x)
        return overlap_average(pred_l, gids, num_nodes)

    return warm_ms(request), request


def profile_call(fn, label: str) -> dict:
    """Where one warm call's time goes: torch.profiler's device time by
    kernel, and the device's busy share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side rows only (kernels, copies): an operator's row repeats the
    # device time of the kernels it launched, and an autograd Function's
    # backward (FusedEdgeConvBackward) reports its ctypes-launched kernels
    # as its own self time
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    for key, us, count in rows[:8]:
        log("profile", call=label, kernel=repr(key[:60]),
            device_ms=f"{us / 1e3:.3f}", calls=count)
    busy = sum(us for _, us, _ in rows)
    if not rows:  # the profiler saw no device activity: no share to report
        log("profile", call=label, device_time="not measured")
        return {}
    return {"profiled_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us}


BWD_NAMES = ("dh", "dx_src", "dw3", "db3")


def bwd_operands(op) -> dict:
    """B2's operands at the chunk shape: B1's, the gathered x_src, and a
    seeded gradient of the layer's output."""
    nb = op["h"].shape[0] // op["blk"]
    g = torch.randn(nb * op["rows_blk"], op["x"].shape[1],
                    generator=torch.Generator().manual_seed(SEED))
    return dict(op, g=g.to(op["x"].device),
                x_src=op["x"][op["sp"].long()].contiguous())


def bwd(bop, gemm_dtype, plain=False, dense=False):
    """B2 (B4 for a rank-r model's operands) or its plain version."""
    wrapper, plain_fn, _ = BWD[bop["rank"] is not None]
    s = bop["s"]
    if dense:
        s = fused_conv.expand_s(s.slot_rows, s.row_weight,
                                rows_blk=bop["rows_blk"], blk=bop["blk"])
    return (plain_fn if plain else wrapper)(
        bop["g"], bop["h"], bop["x_src"], bop["w3"], bop["b3"], s,
        gemm_dtype=gemm_dtype, **layer_kw(bop))


def merged_subdomains(ds, idxs=None):
    """One merged host graph of the dataset's subdomains ``idxs`` (all by
    default), padded as the scheduler pads a batch."""
    idxs = range(len(ds)) if idxs is None else idxs
    raw = [_as_raw_graph(ds.get(int(i))) for i in idxs]
    (_, _, batch), = pad_and_bucket(raw, uniform=True)
    return merge_batch(batch)[0]


def layer_grads(merged, model, device) -> list:
    """The differentiable fused layer's gradients (h, x, w3, b3) for the
    graph ``merged`` at the model's width (and rank), float32, on
    ``device``, from the model's first-layer operands and a seeded output
    gradient."""
    ea, aux, s, rows_blk, blk = model.prepare_fused_train(
        merged.senders, merged.receivers, merged.edge_attr,
        merged.x.shape[0], merged.edge_mask, compact=True)
    h, x, w3, b3 = layer_operands(model, torch.as_tensor(ea),
                                  torch.as_tensor(merged.x))
    c = x.shape[1]
    g = torch.randn(len(s.row_weight), c,
                    generator=torch.Generator().manual_seed(SEED + 1))
    leaves = [t.to(device).requires_grad_() for t in (h, x, w3, b3)]
    aux = {k: torch.as_tensor(v, device=device) for k, v in aux.items()}
    kw = dict(c_in=c, c_out=c, rows_blk=rows_blk, blk=blk,
              gemm_dtype="float32")
    if rank_of(model) is None:
        out = fused_conv.fused_edge_conv_ad(*leaves, s.to(device), aux, **kw)
    else:
        out = fused_conv.fused_edge_conv_lowrank_ad(
            *leaves, s.to(device), aux, rank=model.kernel_rank, **kw)
    (out * g.to(device)).sum().backward()
    return [t.grad.cpu() for t in leaves]


def check_bwd(bop, at: str = "chunk", errs: dict | None = None) -> dict:
    """B2 (B4 on the rank-r path) against its plain version on ``bop`` (the
    operands at shape ``at``), each output relative to its own max; returns
    ``errs`` with each type's largest absolute error."""
    slots, k = bop["h"].shape
    label = bop["tag"] + "bwd"
    log(label, at=at, n=bop["n"], subdomains=bop["b"],
        num_blocks=slots // bop["blk"], blk=bop["blk"], slots=slots,
        real_slots=int((bop["s"].slot_rows >= 0).sum()))
    errs = {} if errs is None else errs
    with torch.no_grad():
        for dt in ("float32", "bfloat16"):
            ref = bwd(bop, dt, plain=True)
            for dense in (False, True):
                got = bwd(bop, dt, dense=dense)
                torch.cuda.synchronize()
                for name, a, b in zip(BWD_NAMES, got, ref):
                    abs_err = (a - b).abs().max().item()
                    rel = abs_err / b.abs().max().item()
                    log(label, at=at, dtype=dt,
                        s="dense" if dense else "compact", out=name,
                        design=design_of(bop, dt),
                        max_abs_err=f"{abs_err:.3e}",
                        rel_to_max=f"{rel:.3e}", tol=BWD_TOL[dt])
                    if not rel <= BWD_TOL[dt]:
                        raise AssertionError(
                            f"{label} kernel at {at} {dt} dense={dense} {name}: "
                            f"{rel:.3e} > {BWD_TOL[dt]}")
                    errs[dt] = max(errs.get(dt, 0.0), abs_err)
                if design_of(bop, dt) == "wgmma":
                    check_repeat(label, at, dt, dense, got,
                                 bwd(bop, dt, dense=dense))
            del ref, got
    torch.cuda.empty_cache()
    return errs


def phase_bwd(bop, small_merged, small_model) -> dict:
    """B2 (B4) against its plain version at the chunk shape, then the
    differentiable layer on the card against the CPU."""
    errs = check_bwd(bop)
    model = small_model.cpu()
    rank = rank_of(model)
    fn = "FusedEdgeConv" if rank is None else "FusedEdgeConvLowrank"
    card = layer_grads(small_merged, model, "cuda")
    torch.cuda.synchronize()
    for name, a, b in zip(("h", "x", "w3", "b3"), card,
                          layer_grads(small_merged, model, "cpu")):
        rel = (a - b).abs().max().item() / b.abs().max().item()
        log(prefix(model) + "bwd", layer=fn, grad=name,
            card_vs_cpu=f"{rel:.3e}", tol=GRAD_TOL)
        if not rel <= GRAD_TOL:
            raise AssertionError(f"{fn} grad {name}: {rel:.3e}")
    return errs


def train_batches(ds, cfg: dict, subset=None):
    """(model, [train batch, val batch], rows_blk, blk): the first train and
    the first val batch ``PartitionScheduler.train`` builds for ``ds`` (or
    for an expert's ``subset`` of it) with seed 0 and the path's train
    config's batch size (the 12 train and the 4 val subdomains whole at a
    batch size of 16) — each merged into one graph, both blocked with one
    common blk — on the card, with a seeded full-width model."""
    subset = np.arange(len(ds)) if subset is None else np.asarray(subset)
    tr_idx, va_idx = train_val_split(len(subset), 0.2, 0)
    bs = min(load_yaml(cfg["train_config"])["batch_size"], len(tr_idx))
    tr_idx, va_idx = subset[tr_idx[:bs]], subset[va_idx[:bs]]
    model = make_model(cfg).cuda()
    fbs, rows_blk, blk = make_fused_batches(
        [merged_subdomains(ds, ix) for ix in (tr_idx, va_idx)], model)
    for fb, ix in zip(fbs, (tr_idx, va_idx)):
        fb["subdomains"] = len(ix)
    return model, fbs, rows_blk, blk


def batch_operands(fb, model, rows_blk: int, blk: int, tag: str) -> dict:
    """The first conv layer's operands of a fused training batch, as
    ``apply_fused_ad`` hands them to the layer, logged as ``tag``."""
    g, fused = fb["graph"], fb["fused"]
    h_e, x, w3, b3 = layer_operands(model, fused["edge_attr"], g.x)
    return dict(h=h_e, x=x, sp=fused["aux"]["senders_perm"], w3=w3, b3=b3,
                s=fused["s"], rows_blk=rows_blk, blk=blk, n=g.x.shape[0],
                b=fb["subdomains"], rank=rank_of(model), tag=tag)


def phase_train_kernels(batches, errs: dict, errs_bwd: dict,
                        tag: str | None = None) -> None:
    """Both kernels against their plain versions at the shapes training
    gives them: B1 and B2 (B3 and B4) on the train and the val batch."""
    model, fbs, rows_blk, blk = batches
    for at, fb in zip(("train_batch", "val_batch"), fbs):
        op = batch_operands(fb, model, rows_blk, blk,
                            prefix(model) if tag is None else tag)
        phase_kernel(op, at, errs)
        check_bwd(bwd_operands(op), at, errs_bwd)
        del op
        torch.cuda.empty_cache()


def phase_train(root: str, datasets: dict, cfgs: dict, tag: str = "") -> dict:
    """The training slice end to end: train_graph_ALDD on the full-size
    meshes (exp ``train_full{tag}``), launch counts (B1 and B2, or B3 and
    B4 for a rank-r config, and no other kernel), then the trained
    checkpoint served.  KernelNN's loss must fall; TEECNet's is recorded."""
    log_dir = os.path.join(root, "logs")
    cfg, ds = cfgs["full"], datasets["full"]
    rank = cfg.get("kernel_rank")
    model = make_model(cfg)
    label = prefix(model) + "train"
    fwd, bwd_k = FWD[rank is not None][0], BWD[rank is not None][0]
    exp = "train_full" + tag
    epochs = cfg["train_epochs"]
    train_cfg = load_yaml(cfg["train_config"])
    log(label, config=os.path.relpath(cfg["train_config"], REPO),
        cut=f"epochs {train_cfg['epochs']} -> {epochs}",
        val_interval=f"{train_cfg['val_interval']} -> 1")
    train_cfg.update(epochs=epochs, val_interval=1)
    depth = cfg["num_layers"]
    tr_idx, va_idx = train_val_split(len(ds), 0.2, 0)
    n_batches = [-(-len(ix) // min(train_cfg["batch_size"], len(tr_idx)))
                 for ix in (tr_idx, va_idx)]
    reset_launches()
    t0 = time.time()
    train_graph_ALDD(exp, model, ds, 1, train_cfg, log_dir=log_dir)
    torch.cuda.synchronize()
    wall = time.time() - t0
    n_fwd, n_bwd = fwd.launches, bwd_k.launches
    with open(os.path.join(log_dir, "metrics",
                           f"{exp}_partition_0.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    vals = [r["val_loss"] for r in records if "val_loss" in r]
    steps = epochs * n_batches[0]
    evals = len(vals) * n_batches[1]
    log(label, subdomains=len(ds), train=len(tr_idx), val=len(va_idx),
        batch_size=train_cfg["batch_size"], epochs=len(losses), steps=steps,
        val_evals=evals, rank=rank, fwd_launches=n_fwd,
        bwd_launches=n_bwd, wall_s=f"{wall:.1f}",
        losses=",".join(f"{v:.5g}" for v in losses),
        val_losses=",".join(f"{v:.5g}" for v in vals))
    if cfg["model"] == "neuralop":
        # TEECNet's loss is recorded as it comes: no nonlinearity between
        # layers, and its lr and init are the reference's, not tuned here
        if len(losses) != epochs or not np.all(np.isfinite(losses + vals)):
            raise AssertionError(f"train losses {losses}, val {vals}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train loss did not fall: {losses}")
    check_only(label, {fwd: depth * (steps + evals), bwd_k: depth * steps})
    ckpt_path = os.path.join(log_dir, "models", f"collection_{exp}",
                             "partition_0.npz")
    if not os.path.exists(ckpt_path):
        raise AssertionError(f"{ckpt_path} was not written")
    reset_launches()
    lanes, fields = serve(ds, model, [0], log_dir, exp, None)
    torch.cuda.synchronize()
    served = fwd.launches
    log(label, served_from=os.path.relpath(ckpt_path, root),
        lane=lanes[0][1], launches=served,
        nodes=len(fields[0]["pressure"]), finite=True)
    check_only(f"{label}: the trained checkpoint's request",
               {fwd: CHUNKS["full"] * depth})
    if rank is not None:
        # the same training in float32 (the FMA kernels) from the same seed,
        # so that the loss curve at this lr can be told from bf16 rounding
        reset_launches()
        train_graph_ALDD(exp + "_f32", make_model(cfg), ds, 1, train_cfg,
                         log_dir=log_dir, gemm_dtype="float32")
        torch.cuda.synchronize()
        check_only(f"{label} float32",
                   {fwd: depth * (steps + evals), bwd_k: depth * steps})
        with open(os.path.join(log_dir, "metrics",
                               f"{exp}_f32_partition_0.jsonl")) as f:
            records = [json.loads(line) for line in f]
        log(label, dtype="float32", design=fused_conv.design(torch.float32,
                                                             rank),
            losses=",".join(f"{r['train_loss']:.5g}" for r in records
                            if "train_loss" in r),
            val_losses=",".join(f"{r['val_loss']:.5g}" for r in records
                                if "val_loss" in r))
    return dict(fwd=n_fwd, bwd=n_bwd, served=served, steps=steps,
                evals=evals, losses=losses)


def phase_parity(small_merged, cfg: dict) -> None:
    """Three float32 fused train steps on the card (kernels) and on the CPU
    (plain versions), from the same seeded weights."""
    lr = load_yaml(cfg["train_config"])["lr"]
    losses = {}
    for dev in ("cuda", "cpu"):
        model = make_model(cfg)
        fb, rows_blk, blk = make_fused_batch(small_merged, model, device=dev)
        trainer = Trainer(model.to(dev), lr=lr, layout="fused",
                          fused_rows_blk=rows_blk, fused_blk=blk,
                          fused_dtype="float32")
        opt = trainer.init()
        losses[dev] = [float(trainer.step(opt, fb)) for _ in range(3)]
    for step, (a, b) in enumerate(zip(losses["cuda"], losses["cpu"])):
        rel = abs(a - b) / abs(b)
        log(prefix(model) + "parity", step=step,
            card=f"{a:.8g}", cpu=f"{b:.8g}", rel=f"{rel:.3e}", tol=PARITY_TOL)
        if not rel <= PARITY_TOL:
            raise AssertionError(f"train step {step}: card {a} vs cpu {b}")


def phase_bwd_times(bop, smi) -> dict:
    """B2's (B4's) and its plain version's CUDA-event medians at the chunk
    shape, and its bound."""
    t = {}
    rank = bop["rank"]
    _, plain, launcher = BWD[rank is not None]
    kw = layer_kw(bop)
    with torch.no_grad():
        for dt in ("bfloat16", "float32"):
            tdt = getattr(torch, dt)
            h, xs, w3 = (bop[key].to(tdt).contiguous()
                         for key in ("h", "x_src", "w3"))
            t[f"ms_{dt}"] = cuda_ms(lambda: launcher(
                bop["g"], h, xs, w3, bop["b3"], bop["s"], **kw))
            t[f"plain_ms_{dt}"] = cuda_ms(
                lambda: plain(bop["g"], h, xs, w3, bop["b3"], bop["s"],
                              gemm_dtype=dt, **kw), reps=5)
    # bound: the real slots' operations at the input type's peak vs every
    # input byte read once and every output written once.  Full rank: dmsg,
    # the two outer products and the three GEMMs (dh, dx_src, dw3 with db3).
    # Rank r: dmsg, the uv recompute, t, dt, dx_src, duv, dh, dw3 with db3
    slots, k = bop["h"].shape
    c = bop["x"].shape[1]
    ncol = bop["w3"].shape[1]
    real = int((bop["s"].slot_rows >= 0).sum())
    if rank is None:
        flops = real * (c + ncol + (k + 1) * c
                        + 2 * k * ncol + 2 * (k + 1) * ncol + 2 * (k + 1) * ncol)
    else:
        flops = real * (c + 2 * (k + 1) * ncol + 6 * rank * c + ncol
                        + 2 * k * ncol + 2 * (k + 1) * ncol)
    rows = len(bop["s"].row_weight)
    for dt, size in (("bfloat16", 2), ("float32", 4)):
        nbytes = (size * (slots * k + slots * c + k * ncol)
                  + 4 * (rows * c + ncol + slots + rows)      # g, b3, S
                  + 4 * (slots * k + slots * c + k * ncol + ncol))  # outputs
        t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_PER_S
        t[f"bound_ms_{dt}"] = max(t_ops, t_bytes) * 1e3
        t[f"bound_by_{dt}"] = "operations" if t_ops >= t_bytes else "bytes"
        t[f"flops_{dt}"], t[f"bytes_{dt}"] = flops, nbytes
    log_times(bop["tag"] + "times", "bwd", t, smi)
    return t


def phase_train_times(batches, cfg: dict, smi, tag: str | None = None) -> dict:
    """Warm wall time of one fused bf16 train step on the training batch
    (the 12 train subdomains merged at batch size 16), and one profiled
    step."""
    model, (fb, _), rows_blk, blk = batches
    s = fb["fused"]["s"]
    label = (prefix(model) if tag is None else tag) + "times"
    log(label, train_batch=fb["subdomains"], nodes=fb["graph"].x.shape[0],
        edges=int(fb["graph"].edge_mask.sum()), blk=blk,
        slots=len(s.slot_rows), real_slots=int((s.slot_rows >= 0).sum()))
    trainer = Trainer(model, lr=load_yaml(cfg["train_config"])["lr"],
                      layout="fused", fused_rows_blk=rows_blk, fused_blk=blk)
    opt = trainer.init(SEED)

    def step():
        return trainer.step(opt, fb)

    t = {"train_step_ms": warm_ms(step)}
    t.update({f"train_{k}": v for k, v in
              profile_call(step, label + "_train_step").items()})
    log_times(label, "train_step", t, smi)
    return t


def run_path(root, name, smi, datasets, models, cfgs, tag: str = "") -> dict:
    """Phases 3-8 for one model configuration (full rank, or rank r with
    ``tag``): kernels against their plain versions at the chunk and the
    training batches, serving, training, parity, times.  Returns what the
    kernels' JSON entries need."""
    t0 = time.time()
    op = chunk_operands(datasets["full"], models["full"], "cuda")
    errs = phase_kernel(op)
    bop = bwd_operands(op)
    small_merged = merged_subdomains(datasets["small"])
    errs_bwd = phase_bwd(bop, small_merged, models["small"])
    batches = train_batches(datasets["full"], cfgs["full"])
    phase_train_kernels(batches, errs, errs_bwd)
    launches = phase_serve(root, datasets, models, cfgs, tag)
    train = phase_train(root, datasets, cfgs, tag)
    phase_parity(small_merged, cfgs["small"])
    t = fwd_times(op, smi)
    t.update(request_times(datasets, models, root, smi, tag))
    tb = phase_bwd_times(bop, smi)
    t.update(phase_train_times(batches, cfgs["full"], smi))
    msg = op["msg"]
    del op, bop, batches
    torch.cuda.empty_cache()
    log(prefix(models["full"]) + "path", depth=cfgs["full"]["num_layers"],
        wall_s=f"{time.time() - t0:.1f}")
    return dict(errs=errs, errs_bwd=errs_bwd, launches=launches, train=train,
                t=t, tb=tb, msg=msg)


def phase_pallas(root: str, datasets: dict, paths: dict, smi) -> tuple:
    """Conv mode 'pallas' end to end: for each (label -> (cfg, exp tag)) of
    ``paths``, the model built with ``mode='pallas'`` serves full-size mesh 0
    from the checkpoint of exp ``full{tag}`` with FESR_FUSED_PREDICT=0 (the
    general lane's ``apply`` per chunk): B5 launched chunks x depth times
    and no other kernel.  The same checkpoint served by the model in its
    default mode ('edge3d' on the card, no kernel) is the reference.
    Then each model's warm request time in both modes (B5's share of the
    path that uses it).  Returns B5's launches per path and the warm
    request times."""
    log_dir = os.path.join(root, "logs")
    launches, requests = {}, {}
    saved = os.environ.get("FESR_FUSED_PREDICT")
    os.environ["FESR_FUSED_PREDICT"] = "0"
    try:
        for label, (cfg, tag) in paths.items():
            want = CHUNKS["full"] * cfg["num_layers"]
            fields = {}
            for mode, model in (("pallas", make_pallas_model(cfg)),
                                ("edge3d", make_model(cfg))):
                reset_launches()
                t0 = time.time()
                lanes, (f,) = serve(datasets["full"], model, [0], log_dir,
                                    "full" + tag, None)
                torch.cuda.synchronize()
                got = pallas_mp.fused_edge_messages.launches
                log("pallas", model=label, mode=mode, lane=lanes[0][1],
                    reason=repr(lanes[0][2]), b5_launches=got,
                    nodes=len(f["pressure"]), cold_s=f"{time.time() - t0:.3f}")
                if lanes[0][1] != "general":
                    raise AssertionError(f"{label} {mode} took lane {lanes[0][1]}")
                check_only(f"pallas {label} {mode} request",
                           {pallas_mp.fused_edge_messages: want}
                           if mode == "pallas" else {})
                fields[mode] = f
                ms, _ = warm_request(datasets["full"], model, log_dir,
                                     "full" + tag)
                requests.setdefault(label, {})[mode] = ms
                log("pallas", model=label, mode=mode,
                    request_ms=f"{ms:.4f}", card=repr(smi))
            launches[label] = want
            for key in ("velocity", "pressure"):
                r, g = fields["edge3d"][key], fields["pallas"][key]
                rel = np.abs(g - r).max() / np.abs(r).max()
                log("pallas", model=label, field=key,
                    vs_edge3d=f"{rel:.3e}", tol=PALLAS_TOL)
                if not rel <= PALLAS_TOL:
                    raise AssertionError(f"pallas {label} {key}: {rel:.3e}")
    finally:
        if saved is None:
            os.environ.pop("FESR_FUSED_PREDICT")
        else:
            os.environ["FESR_FUSED_PREDICT"] = saved
    return launches, requests


def phase_messages(ops: dict, smi) -> dict:
    """B5 against its plain version on the card at each chunk shape of
    ``ops`` (label -> (h, x_src, w3, b3): every edge of the full-size
    chunk, padding included), then the CUDA-event medians of B5, of its
    plain version and of one PyTorch call computing the same function, and
    B5's bound."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for label, (h, x_src, w3, b3) in ops.items():
        e, k = h.shape
        c_in = x_src.shape[1]
        c_out = w3.shape[1] // c_in
        with torch.no_grad():
            ref = pallas_mp.fused_edge_messages_plain(h, x_src, w3, b3)
            got = pallas_mp.fused_edge_messages_cuda(h, x_src, w3, b3)
            again = pallas_mp.fused_edge_messages_cuda(h, x_src, w3, b3)
            # the kernel's first launch, the stage image, against its plain
            # version: the same bits
            image = pallas_mp.stage_image_cuda(w3, b3, c_in)
            torch.cuda.synchronize()
            abs_err = (got - ref).abs().max().item()
            rel = abs_err / ref.abs().max().item()
            same = torch.equal(got, again)
            image_ok = torch.equal(
                image.view(torch.int16),
                pallas_mp.stage_image(w3, b3, c_in).view(torch.int16))
            del ref, got, again, image
            log("messages", model=label, edges=e, k=k, c_in=c_in,
                c_out=c_out, design=pallas_mp.design(),
                max_abs_err=f"{abs_err:.3e}", rel_to_max=f"{rel:.3e}",
                tol=MSG_TOL, bit_identical=same, stage_image_exact=image_ok)
            if not (rel <= MSG_TOL and same and image_ok):
                raise AssertionError(f"B5 at {label}: {rel:.3e} (tol "
                                     f"{MSG_TOL}), repeat identical {same}, "
                                     f"stage image exact {image_ok}")
            # the library yardstick: one einsum over [h, 1] and [w3; b3],
            # prepared outside the timed window (float32, TF32 off)
            h1 = torch.cat([h, torch.ones_like(h[:, :1])], 1)
            w3_aug = torch.cat([w3, b3[None]]).reshape(k + 1, c_in, c_out)
            t = {"ms": cuda_ms(lambda: pallas_mp.fused_edge_messages_cuda(
                     h, x_src, w3, b3)),
                 "plain_ms": cuda_ms(lambda: pallas_mp.fused_edge_messages_plain(
                     h, x_src, w3, b3), reps=5),
                 "library_ms": cuda_ms(lambda: torch.einsum(
                     "ek,ei,kio->eo", h1, x_src, w3_aug), reps=5)}
            del h1, w3_aug
        torch.cuda.empty_cache()
        # bound: every edge's (K+1) c_in c_out multiply-adds, float32-exact:
        # the lesser of float32 FMAs at their peak and six bf16 passes (the
        # split products) on the tensor cores, against h, x_src, w3, b3 read
        # once and the messages written once
        flops = 2 * e * (k + 1) * c_in * c_out
        nbytes = 4 * (e * k + e * c_in + w3.numel() + b3.numel() + e * c_out)
        t_fma = flops / PEAK_FLOPS["float32"]
        t_ops = min(t_fma, 6 * flops / PEAK_FLOPS["bfloat16"])
        t_bytes = nbytes / HBM_BYTES_PER_S
        t.update(bound_ms=max(t_ops, t_bytes) * 1e3,
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 bound_basis=("six bf16 passes" if t_ops < t_fma
                              else "float32 FMA"),
                 bound_fma_ms=max(t_fma, t_bytes) * 1e3,
                 flops=flops, bytes=nbytes, max_abs_err=abs_err, k=k)
        log_times("messages", f"b5_k{k}", t, smi)
        out[label] = t
    return out


def routing(cfg: dict) -> dict:
    """The routed path's encoder and classifier, built as the CLI builds
    them for ``--encoder=pca --classifier=kmeans`` from the exp config."""
    return dict(encoder=init_encoder("pca", **cfg),
                classifier=init_classifier("kmeans", **cfg))


def expert_batches(subset_size: int, batch_size: int) -> tuple:
    """(train, val) batches per epoch ``PartitionScheduler.train`` gives an
    expert of ``subset_size`` subdomains (seed 0): none for an expert with
    nothing to train on, which saves its initial weights."""
    tr, va = train_val_split(subset_size, 0.2, 0)
    if len(va) == 0:
        va = tr[-1:]
    if len(tr) == 0:
        return 0, 0
    bs = max(1, min(batch_size, len(tr)))
    return -(-len(tr) // bs), -(-len(va) // bs)


def phase_routed_train(root: str, ds, cfg: dict) -> dict:
    """Routed training end to end: ``train_graph_ALDD`` with ``n_clusters``
    experts routed by PCA + k-means on the full-size meshes (exp
    ``routed``): partition sizes, each expert's losses (finite, and falling
    for an expert with at least 4 train subdomains), B2 launched depth x
    steps summed over the experts and B1 depth x (steps + validations),
    every checkpoint and the routing state written."""
    log_dir = os.path.join(root, "logs")
    depth, n = cfg["num_layers"], cfg["n_clusters"]
    epochs = cfg["train_epochs"]
    train_cfg = load_yaml(cfg["train_config"])
    train_cfg.update(epochs=epochs, val_interval=1)
    fwd, bwd_k = FWD[False][0], BWD[False][0]
    reset_launches()
    t0 = time.time()
    sched = train_graph_ALDD("routed", make_model(cfg), ds, n, train_cfg,
                             log_dir=log_dir, **routing(cfg))
    torch.cuda.synchronize()
    wall = time.time() - t0
    n_fwd, n_bwd = fwd.launches, bwd_k.launches
    sizes = [len(sub) for sub in sched.subset_indices]
    per = [expert_batches(size, train_cfg["batch_size"]) for size in sizes]
    steps = epochs * sum(s for s, _ in per)
    evals = epochs * sum(v for _, v in per)
    log("routed_train", config=os.path.relpath(ROUTED_CONFIG, REPO),
        n_clusters=n, n_components=cfg["n_components"],
        encoder="pca", classifier="kmeans",
        partitions=",".join(map(str, sizes)), epochs=epochs, steps=steps,
        val_evals=evals, fwd_launches=n_fwd, bwd_launches=n_bwd,
        wall_s=f"{wall:.1f}")
    coll = os.path.join(log_dir, "models", "collection_routed")
    for i, size in enumerate(sizes):
        n_train = len(train_val_split(size, 0.2, 0)[0])
        if not os.path.exists(os.path.join(coll, f"partition_{i}.npz")):
            raise AssertionError(f"expert {i}: no checkpoint")
        if n_train == 0:
            log("routed_train", expert=i, subdomains=size, trained=False)
            continue
        with open(os.path.join(log_dir, "metrics",
                               f"routed_partition_{i}.jsonl")) as f:
            records = [json.loads(line) for line in f]
        losses = [r["train_loss"] for r in records if "train_loss" in r]
        vals = [r["val_loss"] for r in records if "val_loss" in r]
        log("routed_train", expert=i, subdomains=size, train=n_train,
            losses=",".join(f"{v:.5g}" for v in losses),
            val_losses=",".join(f"{v:.5g}" for v in vals))
        if len(losses) != epochs or not np.all(np.isfinite(losses + vals)):
            raise AssertionError(f"expert {i}: losses {losses}, val {vals}")
        if n_train >= 4 and not losses[-1] < losses[0]:
            raise AssertionError(f"expert {i}: loss did not fall: {losses}")
    for f in ("pca_encoder.npz", "kmeans_classifier.npz", "kmeans_scaler.npz"):
        if not os.path.exists(os.path.join(coll, f)):
            raise AssertionError(f"routing state {f} was not written")
    check_only("routed_train", {fwd: depth * (steps + evals),
                                bwd_k: depth * steps})
    return dict(fwd=n_fwd, bwd=n_bwd, steps=steps, evals=evals,
                subsets=sched.subset_indices)


@contextlib.contextmanager
def edge_budget_set(budget):
    """``FESR_PREDICT_EDGE_BUDGET`` set to ``budget`` (None: unchanged)
    while the block runs."""
    saved = os.environ.get("FESR_PREDICT_EDGE_BUDGET")
    if budget is not None:
        os.environ["FESR_PREDICT_EDGE_BUDGET"] = str(budget)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("FESR_PREDICT_EDGE_BUDGET", None)
        else:
            os.environ["FESR_PREDICT_EDGE_BUDGET"] = saved


def phase_routed_serve(root: str, datasets: dict, cfgs: dict) -> dict:
    """Routed serving from the trained experts: both full-size meshes (over
    the edge budget, so the routed predict: label groups cut into chunks,
    B1 launched depth x sum_k ceil(n_k / chunk_b) times); full mesh 0 again
    with a budget of one subdomain less than its largest label group
    (``full_padded``: every such group's tail chunk is padded by
    repetition) and with a budget that holds the whole request
    (``full_lane``: the routed lane, which must serve at least two label
    groups, B1 launched depth x groups times); and the small mesh (the
    routed lane).  Labels on the card equal the CPU's; each mesh-0 request
    on the card is held against the port's float32 plain one on the CPU
    from the same checkpoints."""
    log_dir = os.path.join(root, "logs")
    cfg = cfgs["full"]
    depth, n = cfg["num_layers"], cfg["n_clusters"]
    fwd = FWD[False][0]
    cases = [("full", "full", idx, None) for idx in cfg["idxs"]] + [
        ("full_padded", "full", 0, "padded"),
        ("full_lane", "full", 0, "lane"), ("small", "small", 0, None)]
    launches = {case: 0 for case, _, _, _ in cases}
    card = []
    for case, name, idx, budget_for in cases:
        ds = datasets[name]
        scheds = {dev: PartitionScheduler(
            "routed", n, ds, make_model(cfg), train=False, log_dir=log_dir,
            device=dev, **routing(cfg)) for dev in (None, "cpu")}
        x = ds.get_one_full_sample(idx)
        labels = scheds[None]._route(x)
        if not np.array_equal(labels, scheds["cpu"]._route(x)):
            raise AssertionError(f"routed {case} {idx}: card labels differ "
                                 "from the CPU's")
        counts = np.bincount(labels, minlength=n)
        b, _, e_pad = scheds[None]._request_shape(
            [_as_raw_graph(d) for d in x])
        budget = {None: None, "padded": (counts.max() - 1) * e_pad,
                  "lane": b * e_pad}[budget_for]
        with edge_budget_set(budget):
            chunk_b = max(1, min(b, edge_budget() // e_pad))
            if b * e_pad > edge_budget():
                # routed predict: chunks of each label group
                lane, want = "general", depth * sum(-(-c // chunk_b)
                                                    for c in counts)
            else:  # routed lane: one launch per label group and layer
                lane, want = "routed", depth * np.count_nonzero(counts)
            if budget_for == "padded" and not np.any(counts % chunk_b):
                raise AssertionError(f"routed {case}: no label group pads "
                                     f"its tail chunk ({counts}, {chunk_b})")
            if budget_for == "lane" and np.count_nonzero(counts) < 2:
                raise AssertionError(f"routed {case}: one label group only")
            reset_launches()
            t0 = time.time()
            lanes, (f,) = serve(ds, make_model(cfg), [idx], log_dir,
                                "routed", None, n, **routing(cfg))
            torch.cuda.synchronize()
            got = fwd.launches
        log("routed_serve", mesh=name, case=case, idx=idx, lane=lanes[0][1],
            reason=repr(lanes[0][2]), labels=",".join(map(str, labels)),
            chunk_b=chunk_b, launches=got, expected=want,
            nodes=len(f["pressure"]), cold_s=f"{time.time() - t0:.3f}")
        if lanes[0][1] != lane:
            raise AssertionError(f"routed {case} took lane {lanes[0][1]}")
        check_only(f"routed_serve {case} request", {fwd: want})
        launches[case] += got
        if idx == 0:
            card.append((case, name, f))
    refs = {}
    for case, name, f in card:
        t0 = time.time()
        if name not in refs:
            refs[name] = serve(datasets[name], make_model(cfg), [0], log_dir,
                               "routed", "cpu", n, gemm_dtype="float32",
                               **routing(cfg))[1][0]
        for key in ("velocity", "pressure"):
            r, g = refs[name][key], f[key]
            rel = np.abs(g - r).max() / np.abs(r).max()
            log("routed_serve", mesh=name, case=case, field=key,
                vs_cpu_f32=f"{rel:.3e}", tol=SERVE_TOL,
                cpu_s=f"{time.time() - t0:.1f}")
            if not rel <= SERVE_TOL:
                raise AssertionError(f"routed {case} {key}: {rel:.3e}")
    return launches


def phase_routed_times(root: str, datasets: dict, cfgs: dict, smi) -> dict:
    """Warm wall times of a routed full-size request (predict + host
    overlap average) and of a routed-lane request on the small mesh
    (``predict_full``), each with one profile."""
    log_dir = os.path.join(root, "logs")
    cfg = cfgs["full"]
    ms, request = warm_request(datasets["full"], make_model(cfg), log_dir,
                               "routed", cfg["n_clusters"], **routing(cfg))
    t = {"request_ms": ms}
    t.update(profile_call(request, "routed_request"))
    log_times("routed_times", "request", t, smi)
    ds = datasets["small"]
    sched = PartitionScheduler("routed", cfg["n_clusters"], ds,
                               make_model(cfg), train=False, log_dir=log_dir,
                               **routing(cfg))
    x = ds.get_one_full_sample(0)
    num_nodes = len(ds.full_mesh(0)["points"])

    def lane_request():
        return sched.predict_full(x, num_nodes)

    lt = {"routed_lane_ms": warm_ms(lane_request)}
    if sched.last_lane[0] != "routed":
        raise AssertionError(f"small mesh took lane {sched.last_lane}")
    lt.update({f"routed_lane_{k}": v for k, v in
               profile_call(lane_request, "routed_lane_request").items()})
    log_times("routed_times", "routed_lane", lt, smi)
    return {**t, **lt}


def run_routed(root, smi, datasets, cfgs) -> dict:
    """The routed path: training, serving, B1 and B2 against their plain
    versions on a routed chunk's operands (the largest label group of full
    mesh 0, as the routed predict cuts it) and on the largest expert's
    train and val batches, and times.  Returns what the kernels' JSON
    entries need."""
    t0 = time.time()
    cfg = cfgs["full"]
    train = phase_routed_train(root, datasets["full"], cfg)
    serve_launches = phase_routed_serve(root, datasets, cfgs)
    sched = PartitionScheduler("routed", cfg["n_clusters"], datasets["full"],
                               make_model(cfg), train=False,
                               log_dir=os.path.join(root, "logs"),
                               **routing(cfg))
    labels = sched._route(datasets["full"].get_one_full_sample(0))
    k = int(np.bincount(labels).argmax())
    raw = [_as_raw_graph(d) for d in datasets["full"].get_one_full_sample(0)]
    chunk_b = max(1, edge_budget() // sched._request_shape(raw)[2])
    idx = np.flatnonzero(labels == k)[:chunk_b]
    idx = np.concatenate([idx, np.repeat(idx[-1:], chunk_b - len(idx))])
    op = dict(chunk_operands(datasets["full"], sched.experts[k], "cuda", idx),
              tag="routed_", msg=None)
    errs = phase_kernel(op, "routed_chunk")
    bop = bwd_operands(op)
    errs_bwd = check_bwd(bop, "routed_chunk")
    largest = max(train["subsets"], key=len)
    batches = train_batches(datasets["full"], cfg, largest)
    phase_train_kernels(batches, errs, errs_bwd, "routed_")
    t = fwd_times(op, smi)
    t.update(phase_routed_times(root, datasets, cfgs, smi))
    tb = phase_bwd_times(bop, smi)
    t.update(phase_train_times(batches, cfg, smi, "routed_"))
    del op, bop, batches
    torch.cuda.empty_cache()
    log("routed_path", depth=cfg["num_layers"], expert=k,
        chunk=",".join(map(str, idx)), wall_s=f"{time.time() - t0:.1f}")
    return dict(errs=errs, errs_bwd=errs_bwd, serve=serve_launches,
                train=train, t=t, tb=tb)


def phase_coalesced(root: str, ds, model, smi) -> dict:
    """The coalesced lane on the small mesh: R seeded payloads on one
    geometry through ``predict_full_batch`` (B1 launched R x depth times),
    each against its own ``predict_full``; the warm wall time of the batch
    against R single requests, each with one profile."""
    sched = PartitionScheduler("small", 1, ds, model, train=False,
                               log_dir=os.path.join(root, "logs"))
    x = ds.get_one_full_sample(0)
    num_nodes = len(ds.full_mesh(0)["points"])
    rng = np.random.default_rng(SEED)
    reqs = [[dict(d, x=np.asarray(d["x"]) * rng.uniform(0.5, 1.5),
                  y=np.asarray(d["y"]) * rng.uniform(0.5, 1.5)) for d in x]
            for _ in range(COALESCED_R)]
    depth = model.depth
    reset_launches()
    got = sched.predict_full_batch(reqs, num_nodes)
    torch.cuda.synchronize()
    launches = FWD[False][0].launches
    log("coalesced", requests=COALESCED_R, lane=sched.last_lane[0],
        reason=repr(sched.last_lane[1]), launches=launches,
        nodes=num_nodes)
    if sched.last_lane[0] != "coalesced" or got is None:
        raise AssertionError(f"coalesced lane not taken: {sched.last_lane}")
    check_only("coalesced", {FWD[False][0]: COALESCED_R * depth})
    for i, (pred, ref) in enumerate(got):
        one_pred, one_ref = sched.predict_full(reqs[i], num_nodes)
        rel = max(np.abs(pred - one_pred).max() / np.abs(one_pred).max(),
                  np.abs(ref - one_ref).max() / np.abs(one_ref).max())
        log("coalesced", request=i, vs_predict_full=f"{rel:.3e}",
            tol=COALESCED_TOL, finite=bool(np.isfinite(pred).all()))
        if not (rel <= COALESCED_TOL and np.isfinite(pred).all()):
            raise AssertionError(f"coalesced request {i}: {rel:.3e}")

    def batch():
        return sched.predict_full_batch(reqs, num_nodes)

    def singles():
        return [sched.predict_full(r, num_nodes) for r in reqs]

    t = {"batch_ms": warm_ms(batch), "singles_ms": warm_ms(singles)}
    t.update({f"batch_{k}": v for k, v in
              profile_call(batch, "coalesced_batch").items()})
    t.update({f"singles_{k}": v for k, v in
              profile_call(singles, "coalesced_singles").items()})
    log_times("coalesced_times", f"r{COALESCED_R}", t, smi)
    return dict(launches=launches, t=t)


# -- physics post-passes, powerseries and 'lut' (phases 12-18) -------------
CARD = torch.device("cuda")
PHYS_FULL = (48, 24, 24)    # the full mesh's duct: 27 648 nodes
PHYS_SMALL = (16, 8, 8)     # the small mesh's: 1 024 nodes
# benchmarks/projection_scale.py's 4:1:1 proportions, cut from the
# reference's 500k-1M nodes to fit the script's time limit: 97 556 nodes
PHYS_SCALE = (116, 29, 29)
PHYS_OP_TOL = 1e-5       # one float32 operator, card vs CPU, other sum orders
PHYS_CGNR_TOL = 5e-3     # 20 CGNR iterations (tests/test_torch_physics.py)
# the whole outer loop, card vs CPU: the tolerance the JAX package holds its
# two loops to (tests/test_physics.py), final norm rtol and field / max
PHYS_LOOP_RTOL = 2e-2
VCYCLE_TOL = 1e-4        # one V-cycle: ~10 float32 operator passes
WSS_TOL = 1e-5           # of the magnitude's max
GENERAL_TOL = 1e-4       # float32 general-lane request, card vs CPU
BF16_GENERAL_TOL = 5e-3  # bf16 per-edge matrices: a last-bit f32 difference
#                          can flip one bf16 rounding (2^-8 of that entry)


def noisy_duct(shape, seed: int = 0):
    """(mesh, edges, velocity, pressure): the analytic duct field plus
    noise 0.05 from ``seed``, as benchmarks/projection_scale.py builds it."""
    mesh = make_duct_mesh(*shape)
    v, p = duct_field(mesh.points)
    rng = np.random.default_rng(seed)
    v = v + 0.05 * rng.normal(size=v.shape).astype(np.float32)
    return mesh, cells_to_edges(mesh.cells), v, p[:, 0]


def rel_err(got, ref) -> float:
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = ref.detach().cpu().numpy() if torch.is_tensor(ref) else np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def hold(phase: str, what: str, got, ref, tol: float, **extra) -> float:
    """Logs ``got`` against ``ref`` relative to ref's max and raises past
    ``tol``."""
    err = rel_err(got, ref)
    log(phase, check=what, rel_err=f"{err:.3e}", tol=tol, **extra)
    if not err <= tol:
        raise AssertionError(f"{phase} {what}: {err:.3e} > {tol}")
    return err


def pair_bound_ms(proj) -> tuple[float, int]:
    """(bound ms, bytes) of one composite pair A^T (A q) on ``proj``'s
    mesh: each array it reads once (nbr int64, mask, the weights [N, 3, K];
    the transposed table's sources int64 and weights [N, KT, 3], the row
    sums [N, 3]; q) and its output written once, at 3.35 TB/s."""
    n, k = proj.nbr.shape
    kt = proj.table[0].shape[1]
    nbytes = n * k * (8 + 1 + 12) + n * kt * (8 + 12) + n * 12 + 2 * n * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def phase_physics_ops(smi) -> dict:
    """Every physics operator on the full mesh, card against the port's CPU
    result (float32, TF32 off): both weight operators (and the nodes on the
    fallback branch), both divergences, the Laplacian, the composite A and
    A^T in both forms, the pressure correction, one CGNR solve at 20
    iterations; the adjoint's dot-product test on the card; the composite
    pair's time against its bound and the masked CG's cost per inner
    iteration."""
    mesh, edges, v, p = noisy_duct(PHYS_FULL)
    t0 = time.time()
    card = DivergenceFreeProjection(mesh.points, edges, v, p, device=CARD)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    cpu = DivergenceFreeProjection(mesh.points, edges, v, p, device="cpu")
    n, k = card.nbr.shape
    log("physics_ops", nodes=n, edges=len(edges), K=k,
        KT=card.table[0].shape[1], mean_neighbors=f"{cpu.mask.sum(1).float().mean():.2f}",
        setup_s=f"{setup_s:.3f}")
    cuda = CARD
    for faithful, fn in ((True, pdiv.compute_weights),
                         (False, pdiv.compute_gradient_weights)):
        args = (card.points, card.nbr, card.mask)
        cargs = (cpu.points, cpu.nbr, cpu.mask)
        if faithful:
            got, s_card = fn(*args, return_simple=True)
            ref, s_cpu = fn(*cargs, return_simple=True)
            log("physics_ops", simple_nodes_card=int(s_card.sum()),
                simple_nodes_cpu=int(s_cpu.sum()))
            if int(s_card.sum()) != int(s_cpu.sum()):
                raise AssertionError("simple-branch node counts differ")
        else:
            got, ref = fn(*args), fn(*cargs)
        hold("physics_ops", f"weights_faithful={faithful}", got, ref,
             PHYS_OP_TOL)
    # the operators on the same (the CPU's) weights on both sides
    for faithful in (True, False):
        w = (pdiv.compute_weights if faithful else pdiv.compute_gradient_weights)(
            cpu.points, cpu.nbr, cpu.mask)
        sides = {"cpu": (cpu.nbr, cpu.mask, w, cpu.table),
                 "card": (card.nbr, card.mask, w.to(cuda), card.table)}
        vel = {"cpu": cpu.velocity, "card": card.velocity}
        q = torch.as_tensor(np.random.default_rng(1).standard_normal(n)
                            .astype(np.float32))
        qs = {"cpu": q, "card": q.to(cuda)}
        out = {}
        for side, (nbr, mask, ws, table) in sides.items():
            mv, gf = pdiv.make_consistent_matvec(nbr, mask, ws,
                                                 trace=not faithful)
            rmv = pdiv.make_consistent_rmatvec(nbr, mask, ws, table,
                                               trace=not faithful)
            lw = pdiv.laplacian_weights(ws, mask)
            lmv, diag = pdiv.make_laplacian_matvec(nbr, mask, lw)
            out[side] = {
                "divergence": pdiv.compute_divergence(vel[side], nbr, mask, ws),
                "divergence_trace": pdiv.compute_divergence_trace(
                    vel[side], nbr, mask, ws),
                "laplacian": lmv(qs[side]), "laplacian_diag": diag,
                "composite": mv(qs[side]), "grad_field": gf(qs[side]),
                "adjoint": rmv(qs[side]),
                "pressure_correction": pdiv.apply_pressure_correction(
                    vel[side], qs[side], nbr, mask, ws, alpha=0.7)}
        for key in out["cpu"]:
            hold("physics_ops", f"{key}_faithful={faithful}", out["card"][key],
                 out["cpu"][key], PHYS_OP_TOL)
        # <y, A q> = <A^T y, q> on the card in float64
        w64 = w.double().to(cuda)
        mv, _ = pdiv.make_consistent_matvec(card.nbr, card.mask, w64,
                                            trace=not faithful)
        rmv = pdiv.make_consistent_rmatvec(card.nbr, card.mask, w64,
                                           card.table, trace=not faithful)
        y = torch.as_tensor(np.random.default_rng(2).standard_normal(n),
                            device=cuda)
        x = q.double().to(cuda)
        lhs, rhs = float(y @ mv(x)), float(rmv(y) @ x)
        gap = abs(lhs - rhs) / max(abs(lhs), 1.0)
        log("physics_ops", check=f"dot_product_faithful={faithful}",
            lhs=f"{lhs:.12e}", rhs=f"{rhs:.12e}", rel_gap=f"{gap:.2e}",
            tol=1e-10)
        if not gap <= 1e-10:
            raise AssertionError(f"adjoint dot-product test: {gap:.2e}")
    # one CGNR solve, each side on its own weights
    p_card = card.solve_pressure_poisson(card.calculate_divergence(),
                                         tol=1e-5, maxiter=20)
    p_cpu = cpu.solve_pressure_poisson(cpu.calculate_divergence(),
                                       tol=1e-5, maxiter=20)
    hold("physics_ops", "cgnr_maxiter=20", p_card, p_cpu, PHYS_CGNR_TOL,
         iterations=card.cg_iterations[-1])
    # the unit of cost of every inner iteration: A q then A^T y
    q = torch.randn(n, generator=torch.Generator().manual_seed(0)).to(cuda)
    pair_ms = cuda_ms(lambda: card.normal_matvec(q))
    bound_ms, nbytes = pair_bound_ms(card)
    div = card.calculate_divergence()
    per_iter = {}
    for every in (1, pproj.CHECK_EVERY):
        def solve():
            return pproj.cg(card.normal_matvec,
                            card.consistent_rmatvec(div), tol=1e-30,
                            maxiter=200, check_every=every)
        per_iter[every] = warm_ms(solve, reps=3) / 200
    log("physics_ops", pair_ms=f"{pair_ms:.4f}", pair_bound_ms=f"{bound_ms:.5f}",
        pair_bytes=nbytes, bound_by="bytes",
        cg_iter_ms_check_every_1=f"{per_iter[1]:.4f}",
        **{f"cg_iter_ms_check_every_{pproj.CHECK_EVERY}":
           f"{per_iter[pproj.CHECK_EVERY]:.4f}"}, card=repr(smi))
    return {"pair_ms": pair_ms, "pair_bound_ms": bound_ms,
            "cg_iter_ms": per_iter[pproj.CHECK_EVERY]}


class _Tee:
    """Writes to the real stdout and keeps a copy of the text."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _printed(text: str, prefix: str) -> list[str]:
    return [ln[len(prefix):].strip() for ln in text.splitlines()
            if ln.startswith(prefix)]


def phase_physics_smooth(root: str, datasets: dict, models: dict,
                         cfgs: dict, smi) -> int:
    """``pred_graph_ALDD(smooth=True)`` on both full meshes from the serve
    phase's KernelNN checkpoint (general lane, B1 8 times each): the
    projection's initial and final divergence and wall time; the .vtu
    velocity finite and moved off the unsmoothed prediction.  Two
    projections of one field on the card give the same bits, and on the
    small mesh the card's whole loop (host and device) agrees with the
    CPU's.  Returns B1's launches in the smoothed requests."""
    log_dir = os.path.join(root, "logs")
    launches = 0
    for idx in cfgs["full"]["idxs"]:
        _, (plain,) = serve(datasets["full"], models["full"], [idx], log_dir,
                            "full", None)
        reset_launches()
        tee = _Tee(sys.stdout)
        t0 = time.time()
        with contextlib.redirect_stdout(tee):
            lanes, (fields,) = serve(datasets["full"], models["full"], [idx],
                                     log_dir, "full", None, smooth=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
        got = fused_conv.fused_edge_conv.launches
        check_only(f"smooth request {idx}",
                   {fused_conv.fused_edge_conv: CHUNKS["full"]
                    * cfgs["full"]["num_layers"]})
        launches += got
        text = "".join(tee.parts)
        init = float(_printed(text, "Initial divergence:")[0])
        final_s, _, iters = _printed(text, "Final divergence:")[0].partition(" in ")
        final = float(final_s)
        smooth_s = float(_printed(text, "Smoothing time:")[0])
        moved = float(np.abs(fields["velocity"] - plain["velocity"]).max())
        log("physics_smooth", mesh="full", idx=idx, lane=lanes[0][1],
            b1_launches=got, initial=f"{init:.6f}", final=f"{final:.6f}",
            ratio=f"{init / max(final, 1e-30):.3f}", iterations=iters,
            smooth_s=f"{smooth_s:.3f}", request_s=f"{wall:.3f}",
            max_velocity_change=f"{moved:.4e}", card=repr(smi))
        if not final < init:
            raise AssertionError(f"smooth {idx}: final {final} >= initial {init}")
        if not (np.isfinite(fields["velocity"]).all() and moved > 0):
            raise AssertionError(f"smooth {idx}: velocity not finite or unmoved")
        if idx == 0:
            first = plain
    # two projections of one field on the card: the same bits
    full = datasets["full"].full_mesh(0)
    edges = cells_to_edges(full["cells"])
    runs = []
    for _ in range(2):
        proj = DivergenceFreeProjection(full["points"], edges,
                                        first["velocity"], first["pressure"],
                                        device=CARD)
        t0 = time.time()
        v, pr, final, _ = proj.apply_divergence_free_projection(
            max_iterations=20, tolerance=1e-2)
        torch.cuda.synchronize()
        runs.append((v.cpu().numpy(), pr.cpu().numpy(), final,
                     time.time() - t0, proj))
    same = all(np.array_equal(a, b) for a, b in zip(runs[0][:2], runs[1][:2]))
    proj = runs[0][4]
    log("physics_smooth", check="repeat_bits", identical=same,
        final=f"{runs[0][2]:.6f}", pair_calls=proj.pair_calls,
        inner_iterations=sum(proj.cg_iterations),
        outer_iterations=len(proj.cg_iterations),
        wall_s=f"{runs[0][3]:.3f},{runs[1][3]:.3f}")
    if not same:
        raise AssertionError("two projections of one field differ on the card")
    # the small mesh: the card's whole loop against the CPU's
    mesh, edges, v, p = noisy_duct(PHYS_SMALL)
    for loop in ("host", "device"):
        res = {}
        for dev in (CARD, "cpu"):
            proj = DivergenceFreeProjection(mesh.points, edges, v, p,
                                            device=dev)
            if loop == "host":
                vel, _, final, _ = proj.apply_divergence_free_projection(
                    max_iterations=20, tolerance=1e-2)
            else:
                vel, _, final, _ = proj.apply_divergence_free_projection_device(
                    max_iterations=20, tolerance=1e-2)
            res[dev] = (vel, final)
        rel = abs(res[CARD][1] - res["cpu"][1]) / res["cpu"][1]
        log("physics_smooth", mesh="small", loop=loop,
            final_card=f"{res[CARD][1]:.6f}", final_cpu=f"{res['cpu'][1]:.6f}",
            final_rel=f"{rel:.3e}", tol=PHYS_LOOP_RTOL)
        if not rel <= PHYS_LOOP_RTOL:
            raise AssertionError(f"small {loop} loop: final norms {rel:.3e}")
        hold("physics_smooth", f"small_{loop}_velocity", res[CARD][0],
             res["cpu"][0], PHYS_LOOP_RTOL)
    return launches


def phase_physics_amg(smi) -> None:
    """The AMG hierarchy on the full mesh: its host build's seconds and
    level sizes, one V-cycle on the card against the CPU on the same
    hierarchy and weights, and the device loop with ``precond='amg'``
    against ``'none'`` on the same noisy field."""
    mesh, edges, v, p = noisy_duct(PHYS_FULL)
    proj = DivergenceFreeProjection(mesh.points, edges, v, p, device=CARD)
    nbr, mask = proj.nbr.cpu().numpy(), proj.mask.cpu().numpy()
    w = proj.weights.cpu().numpy()
    t0 = time.time()
    N = pamg.assemble_normal(nbr, mask, w, a_drop=0.0)
    levels, cinv = pamg.build_hierarchy(N, implicit_level0=True)
    build_s = time.time() - t0
    log("physics_amg", nodes=len(nbr), normal_nnz=N.nnz,
        normal_nnz_per_row=f"{N.nnz / len(nbr):.1f}",
        levels=[lv["n"] for lv in levels] + [len(cinv)],
        host_build_s=f"{build_s:.2f}")
    r = np.random.default_rng(3).standard_normal(len(nbr)).astype(np.float32)
    out = {}
    for dev in (CARD, "cpu"):
        t = (lambda a, dev=dev: a.to(dev))
        mv, _ = pdiv.make_consistent_matvec(t(proj.nbr), t(proj.mask),
                                            t(proj.weights))
        rmv = pdiv.make_consistent_rmatvec(t(proj.nbr), t(proj.mask),
                                           t(proj.weights),
                                           [t(a) for a in proj.table])
        lv, ci = pamg.levels_from_arrays(levels, cinv, dev)
        vc = pamg.make_vcycle(lv, ci, cheb_degree=3, smooth_band=16.0,
                              matvec0=lambda q, mv=mv, rmv=rmv: rmv(mv(q)))
        rt = torch.as_tensor(r, device=dev)
        out[dev] = vc(rt)
        if dev == CARD:
            vcycle_ms = cuda_ms(lambda: vc(rt))
    hold("physics_amg", "vcycle", out[CARD], out["cpu"], VCYCLE_TOL,
         vcycle_ms=f"{vcycle_ms:.4f}", card=repr(smi))
    for precond in ("none", "amg"):
        proj = DivergenceFreeProjection(mesh.points, edges, v, p, device=CARD)
        init = float(torch.linalg.vector_norm(proj.calculate_divergence()))
        t0 = time.time()
        _, _, final, it = proj.apply_divergence_free_projection_device(
            max_iterations=20, tolerance=1e-2, cg_maxiter=200, precond=precond)
        torch.cuda.synchronize()
        log("physics_amg", precond=precond, initial=f"{init:.6f}",
            final=f"{final:.6f}", ratio=f"{init / max(final, 1e-30):.3f}",
            outer=it, inner=sum(proj.cg_iterations),
            pair_calls=proj.pair_calls, wall_s=f"{time.time() - t0:.3f}")
        if not final < init:
            raise AssertionError(f"amg phase {precond}: no reduction")


def phase_physics_scale(smi, max_iterations: int = 20) -> None:
    """The device loop at 97 556 nodes (benchmarks/projection_scale.py's
    field): setup seconds, then plain CGNR and ``precond='amg'``: the
    ratio, outer and inner iterations, wall seconds, and the composite
    pair's time against its bound."""
    t0 = time.time()
    mesh, edges, v, p = noisy_duct(PHYS_SCALE)
    mesh_s = time.time() - t0
    for precond in ("none", "amg"):
        t0 = time.time()
        proj = DivergenceFreeProjection(mesh.points, edges, v, p, device=CARD)
        init = float(torch.linalg.vector_norm(proj.calculate_divergence()))
        setup_s = time.time() - t0
        amg_s = 0.0
        if precond == "amg":
            t0 = time.time()
            proj._amg_preconditioner()
            amg_s = time.time() - t0
        t0 = time.time()
        _, _, final, it = proj.apply_divergence_free_projection_device(
            max_iterations=max_iterations, tolerance=1e-2, cg_maxiter=200,
            precond=precond)
        torch.cuda.synchronize()
        wall = time.time() - t0
        q = torch.randn(len(mesh.points)).to(CARD)
        pair_ms = cuda_ms(lambda: proj.normal_matvec(q))
        bound_ms, nbytes = pair_bound_ms(proj)
        log("physics_scale", precond=precond, nodes=len(mesh.points),
            edges=len(edges), K=proj.nbr.shape[1], mesh_s=f"{mesh_s:.2f}",
            setup_s=f"{setup_s:.2f}", amg_build_s=f"{amg_s:.2f}",
            amg_levels=proj.amg_sizes, initial=f"{init:.4f}",
            final=f"{final:.4f}", ratio=f"{init / max(final, 1e-30):.3f}",
            outer=it, inner=sum(proj.cg_iterations),
            max_outer=max_iterations, wall_s=f"{wall:.3f}",
            pair_ms=f"{pair_ms:.4f}", pair_bound_ms=f"{bound_ms:.5f}",
            pair_bytes=nbytes, card=repr(smi))
        if not final < init:
            raise AssertionError(f"scale {precond}: no reduction")


def _read_vtp(path: str) -> dict:
    """PointData arrays of a .vtp written by ``write_vtp_polydata``."""
    import xml.etree.ElementTree as ET

    from fast_eng_super_resolution_tpu_torch.data.vtu import _decode_data_array

    piece = ET.parse(path).getroot().find(".//Piece")
    return {el.get("Name"): _decode_data_array(el)
            for el in piece.find("PointData").findall("DataArray")}


def phase_wss(root: str, smi) -> None:
    """``python -m fast_eng_super_resolution_tpu_torch.compute_wss`` on the
    first smoothed full-mesh .vtu (a subprocess: the entry point itself,
    on the card), each field's .vtp against the port's CPU post-pass; and
    the analytic shear u = (gamma y, 0, 0) on the duct, |tau| = mu gamma on
    the bottom wall (tests/test_physics.py's check)."""
    src = os.path.join(root, "logs", "vtk", "full", "pred_0.vtu")
    work = os.path.join(root, "wss")
    os.makedirs(work, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    run = subprocess.run([sys.executable, "-m",
                          "fast_eng_super_resolution_tpu_torch.compute_wss",
                          "--input", src], cwd=work, env=env,
                         capture_output=True, text=True, timeout=300)
    if run.returncode != 0:
        raise AssertionError(f"compute_wss failed: {run.stderr[-2000:]}")
    log("wss", cli_s=f"{time.time() - t0:.2f}", input=os.path.basename(src))
    grid = read_vtu(src)
    cells = np.asarray(grid["cells"])
    edges = cells_to_edges(cells)
    for field, tag in (("velocity", "pred"),
                       ("interpolated_velocity", "interpolated"),
                       ("ref_velocity", "reference")):
        got = _read_vtp(os.path.join(work, f"wall_shear_stress_results_{tag}.vtp"))
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            _, tau, mag = compute_wall_shear_stress(
                grid["points"], cells, edges, grid["point_data"][field], 1e-3,
                device="cpu")
        scale = float(mag.max())
        err = max(np.abs(got["WallShearStressMagnitude"] - mag).max(),
                  np.abs(got["WallShearStressVector"] - tau).max()) / scale
        log("wss", field=field, surface_points=len(mag),
            max_magnitude=f"{scale:.6e}", card_vs_cpu=f"{err:.3e}", tol=WSS_TOL)
        if not err <= WSS_TOL:
            raise AssertionError(f"wss {field}: {err:.3e} > {WSS_TOL}")
    mesh = make_duct_mesh(10, 6, 6)
    gamma, mu = 2.0, 1e-3
    vel = np.stack([gamma * mesh.points[:, 1], 0 * mesh.points[:, 0],
                    0 * mesh.points[:, 0]], 1).astype(np.float32)
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        ids, _, mag = compute_wall_shear_stress(
            mesh.points, mesh.cells, cells_to_edges(mesh.cells), vel, mu,
            device=CARD)
    pts = mesh.points[ids]
    bottom = (np.isclose(pts[:, 1], 0) & (pts[:, 0] > 0.3) & (pts[:, 0] < 1.7)
              & (pts[:, 2] > 0.15) & (pts[:, 2] < 0.35))
    err = float(np.abs(mag[bottom] / (mu * gamma) - 1).max())
    log("wss", check="analytic_shear", nodes=int(bottom.sum()),
        max_rel_err=f"{err:.3e}", tol=0.15, card=repr(smi))
    if not (bottom.sum() > 0 and err <= 0.15):
        raise AssertionError(f"analytic shear: {err:.3e}")


def general_request(label: str, phase: str, datasets: dict, model, tag: str,
                    root: str, tol: float) -> None:
    """One full-size request of ``model`` from exp ``full{tag}``'s
    checkpoint with FESR_FUSED_PREDICT=0 (general lane, plain ``apply``):
    no kernel launched; then the small mesh's request (exp
    ``small{tag}``) on the card against the CPU's within ``tol``."""
    log_dir = os.path.join(root, "logs")
    saved = os.environ.get("FESR_FUSED_PREDICT")
    os.environ["FESR_FUSED_PREDICT"] = "0"
    try:
        reset_launches()
        t0 = time.time()
        lanes, (f,) = serve(datasets["full"], model, [0], log_dir,
                            "full" + tag, None)
        torch.cuda.synchronize()
        log(phase, model=label, mesh="full", lane=lanes[0][1],
            reason=repr(lanes[0][2]), nodes=len(f["pressure"]),
            cold_s=f"{time.time() - t0:.3f}", **launches_of(*KERNELS))
        if lanes[0][1] != "general":
            raise AssertionError(f"{label} took lane {lanes[0][1]}")
        check_only(f"{label} request", {})
        _, (card,) = serve(datasets["small"], model, [0], log_dir,
                           "small" + tag, None)
        _, (cpu,) = serve(datasets["small"], model, [0], log_dir,
                          "small" + tag, "cpu")
        for key in ("velocity", "pressure"):
            hold(phase, f"{label}_small_{key}_vs_cpu", card[key], cpu[key], tol)
    finally:
        if saved is None:
            os.environ.pop("FESR_FUSED_PREDICT")
        else:
            os.environ["FESR_FUSED_PREDICT"] = saved


def phase_powerseries(root: str, datasets: dict, cfg: dict) -> None:
    """TEECNet at teecnet_ansys.yaml's width with the power-series kernel:
    no fused form, so the general lane; seeded checkpoints written for the
    full and small meshes."""
    model = TEECNet(cfg["in_channels"], cfg["width"], cfg["out_channels"],
                    cfg["num_layers"], kernel_type="powerseries", seed=SEED)
    for exp in ("full_ps", "small_ps"):
        ckpt.save_params(os.path.join(root, "logs", "models",
                                      f"collection_{exp}", "partition_0.npz"),
                         model.to_jax_params(), meta={"model": "TEECNet"})
    general_request("teecnet_powerseries", "powerseries", datasets, model,
                    "_ps", root, GENERAL_TOL)


def phase_lut(root: str, datasets: dict, cfg: dict) -> None:
    """KernelNN at full width from the serve phase's checkpoints in mode
    'lut' (512 knots), and with ``kernel_dtype='bfloat16'`` in mode
    'edge3d': both through the general lane's ``apply``."""
    w = cfg["width"]
    kw = dict(in_width=cfg["in_channels"], out_width=cfg["out_channels"],
              seed=SEED)
    general_request("kernelnn_lut", "lut", datasets,
                    KernelNN(w, w, cfg["num_layers"], mode="lut", **kw),
                    "", root, GENERAL_TOL)
    general_request("kernelnn_bf16_edge3d", "lut", datasets,
                    KernelNN(w, w, cfg["num_layers"], mode="edge3d",
                             kernel_dtype="bfloat16", **kw),
                    "", root, BF16_GENERAL_TOL)


# -- the grid family: FNO1d/2d/3d and DeepONet (no hand-written kernel) ----

def _make_grid_data(key: str, cfg: dict) -> float:
    """Generates (and caches under ``cfg['root']``) one grid dataset in a
    worker process; returns its seconds."""
    t0 = time.time()
    init_dataset(GRID[key]["dataset"], **cfg)
    return time.time() - t0


def grid_configs(root: str) -> dict:
    """Per grid path, (exp config, train config): the shipped configs with
    this run's root and sample cut, the recipe cut to GRID_EPOCHS epochs,
    and on the card."""
    out = {}
    for key, g in GRID.items():
        cfg = load_yaml(os.path.join(REPO, "configs", "exp_config", g["exp"]))
        n, k = g["num_samples"], g["train_samples"]
        cfg.update(root=os.path.join(root, "grid", key), num_samples=n,
                   train_samples=k, idxs=[k, (k + n) // 2, n - 1])
        cfg.setdefault("trunk_size", 2)  # as the JAX package's CLI test
        train = load_yaml(os.path.join(REPO, "configs", "train_config",
                                       g["train"]))
        out[key] = (cfg, dict(train, epochs=GRID_EPOCHS))
    return out


def start_grid_data(cfgs: dict):
    """Starts the grid datasets' generation (host numpy, one worker process
    each) so it overlaps the kernel phases; returns (pool, futures)."""
    import concurrent.futures as cf
    import multiprocessing as mp

    pool = cf.ProcessPoolExecutor(len(cfgs), mp_context=mp.get_context("spawn"))
    return pool, {key: pool.submit(_make_grid_data, key, cfg)
                  for key, (cfg, _) in cfgs.items()}


def grid_model(key: str, cfg: dict):
    return init_model(GRID[key]["model"], seed=SEED, **cfg)


def phase_grid_spectral(cfgs: dict) -> dict:
    """One spectral conv of each FNO at its config's padded grid and its
    recipe's batch: 'fft' (cuFFT) against 'matmul' on the card, both
    against the port's CPU 'fft' on the first two samples (same weights,
    TF32 off); the warm CUDA-event medians of each form, forward and
    forward + backward, and the form 'auto' resolves to."""
    import copy
    from unittest import mock

    from fast_eng_super_resolution_tpu_torch.models import fno
    from fast_eng_super_resolution_tpu_torch.models.fno import spectral_conv

    out = {}
    for key in ("fno2d", "fno3d", "fno1d"):
        cfg, train = cfgs[key]
        model = grid_model(key, cfg).cuda()
        grid = [cfg["resolution"] + model.padding] * model.ndim
        shape = (int(train["batch_size"]), model.width, *grid)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.randn(shape, device="cuda", generator=gen)
        with torch.no_grad():
            fft = spectral_conv(model, 0, x, "fft")
            mm = spectral_conv(model, 0, x, "matmul")
            ref = spectral_conv(copy.deepcopy(model).cpu(), 0, x[:2].cpu(),
                                "fft")
            errs = {"err_fft_matmul": float((fft - mm).abs().max()
                                            / mm.abs().max()),
                    "err_fft_cpu": rel_err(fft[:2], ref),
                    "err_matmul_cpu": rel_err(mm[:2], ref)}
            # recorded, not held: cuFFT's C2R on the raw spectrum (the DC
            # and Nyquist columns' imaginary parts left in)
            with mock.patch.object(fno, "_irfft_last",
                                   lambda u, n: torch.fft.irfft(u, n=n)):
                raw = spectral_conv(model, 0, x, "fft")
            raw_err = float((raw - mm).abs().max() / mm.abs().max())
            del fft, mm, raw
            t = {f"{impl}_ms": cuda_ms(
                lambda impl=impl: spectral_conv(model, 0, x, impl))
                for impl in ("fft", "matmul")}
        xg = x.clone().requires_grad_(True)
        for impl in ("fft", "matmul"):
            t[f"{impl}_fwd_bwd_ms"] = cuda_ms(
                lambda impl=impl: spectral_conv(model, 0, xg, impl).sum()
                .backward())
        auto = model.resolve_impl(torch.device("cuda"))
        log("grid_spectral", model=key, shape="x".join(map(str, shape)),
            auto=auto, **{k: f"{v:.2e}" for k, v in errs.items()},
            err_raw_c2r_matmul=f"{raw_err:.2e}",
            **{k: f"{v:.4f}" for k, v in t.items()}, tol=GRID_SPECTRAL_TOL)
        for k, v in errs.items():
            if not v < GRID_SPECTRAL_TOL:
                raise AssertionError(f"grid_spectral {key} {k}={v}")
        out[key] = dict(t, auto=auto, **errs)
        del x, xg
        torch.cuda.empty_cache()
    return out


def _train_losses(log_dir: str, exp: str) -> list:
    with open(os.path.join(log_dir, "metrics", f"{exp}.jsonl")) as f:
        return [json.loads(ln)["train_loss"] for ln in f]


def phase_grid_train(cfgs: dict, log_dir: str, futures: dict) -> dict:
    """``train_grid`` of each grid model on the card from its cut recipe:
    finite losses (FNO2d's train loss falls from the first logged epoch to
    the last), a checkpoint with its task-spec stamp, the warm train step
    (recipe batch) and the phase's peak memory."""
    from fast_eng_super_resolution_tpu_torch.grid_runner import train_grid
    from fast_eng_super_resolution_tpu_torch.parallel.grid_train import GridTrainer

    out = {}
    for key, (cfg, train) in cfgs.items():
        data_s = futures[key].result()
        ds = init_dataset(GRID[key]["dataset"], **cfg)
        model = grid_model(key, cfg)
        exp = f"grid_{key}"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = train_grid(exp, model, ds, train, cfg, log_dir=log_dir)
        torch.cuda.synchronize()
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = _train_losses(log_dir, exp)
        if not np.all(np.isfinite(losses)) or not np.isfinite(res["best_val"]):
            raise AssertionError(f"grid_train {key}: losses {losses}")
        if key == "fno2d" and not losses[-1] < losses[0]:
            raise AssertionError(f"grid_train fno2d: loss did not fall {losses}")
        meta = ckpt.load_meta(res["ckpt"])
        if meta.get("model") != type(model).__name__ or "task" not in meta:
            raise AssertionError(f"grid_train {key}: checkpoint meta {meta}")
        # the warm step: the trained weights, one recipe batch
        bs = min(int(train["batch_size"]), int(cfg["train_samples"]))
        xb = torch.as_tensor(ds.x[:bs], device="cuda")
        yb = torch.as_tensor(ds.y[:bs], device="cuda")
        tr = GridTrainer(model, lr=float(train["lr"]),
                         out_channels=int(ds.y.shape[-1]))
        tr.net.from_jax_params(ckpt.load_params(res["ckpt"]))
        opt = tr.optimizer()
        step_ms = warm_ms(lambda: tr.step(opt, xb, yb))
        impl, steps = "-", {}
        if hasattr(model, "resolve_impl"):  # the step in each spectral form
            impl = model.resolve_impl(torch.device("cuda"))
            for form in ("fft", "matmul"):
                model.spectral_impl = form
                ms = warm_ms(lambda: tr.step(opt, xb, yb))
                steps[f"step_ms_{form}"] = f"{ms:.3f}"
            model.spectral_impl = "auto"
        log("grid_train", model=key, impl=impl, data_s=f"{data_s:.1f}",
            train_s=f"{wall:.2f}", epochs=train["epochs"],
            steps_per_epoch=max(1, int(cfg["train_samples"]) // bs),
            first_loss=f"{losses[0]:.6f}", last_loss=f"{losses[-1]:.6f}",
            best_val=f"{res['best_val']:.6f}", step_ms=f"{step_ms:.3f}",
            **steps, peak_mib=f"{peak / 2**20:.0f}",
            ckpt=os.path.basename(res["ckpt"]))
        out[key] = dict(ds=ds, model=model, exp=exp, step_ms=step_ms,
                        peak_mib=peak / 2**20, impl=impl, losses=losses)
    return out


def phase_grid_parity() -> None:
    """Three Adam steps of FNO2d (fno_advected_256.yaml's width 16 and
    modes 12, at a 32x32 grid) from the same weights and batches on the
    card, in both spectral forms, and on the CPU: the losses agree."""
    from fast_eng_super_resolution_tpu_torch.parallel.grid_train import GridTrainer

    rng = np.random.default_rng(SEED)
    x = rng.random((6, 32, 32, 1)).astype(np.float32)
    y = rng.random((6, 32, 32, 1)).astype(np.float32)
    order = rng.permutation(6).reshape(3, 2)
    losses = {}
    for dev, impl in (("cpu", "fft"), ("cuda", "fft"), ("cuda", "matmul")):
        model = init_model("fno", 12, 12, width=16, in_feats=1, seed=SEED)
        model.spectral_impl = impl
        tr = GridTrainer(model.to(dev), lr=1e-3, out_channels=1)
        opt = tr.init(SEED, x)
        losses[(dev, impl)] = tr.epoch(
            opt, torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev),
            order).cpu().numpy()
    ref = losses[("cpu", "fft")]
    for k, v in losses.items():
        err = float(np.max(np.abs(v - ref) / ref))
        log("grid_parity", device=k[0], impl=k[1],
            losses=",".join(f"{a:.7f}" for a in v), rel_err=f"{err:.2e}",
            tol=GRID_PARITY_TOL)
        if not err < GRID_PARITY_TOL:
            raise AssertionError(f"grid_parity {k}: {v} vs {ref}")


def phase_grid_serve(cfgs: dict, trained: dict, log_dir: str) -> dict:
    """``pred_grid`` of each checkpoint on the card: every ``pred_{idx}.npz``
    finite, the improvement factors (recorded, not held to a value after a
    handful of epochs), then the warm time of a one-sample request
    (``pred_grid``: checkpoint load, upload, forward, fetch, .npz) and of
    its predict alone (upload, forward, fetch)."""
    import io

    from fast_eng_super_resolution_tpu_torch.grid_runner import pred_grid
    from fast_eng_super_resolution_tpu_torch.parallel.grid_train import GridTrainer

    out = {}
    for key, (cfg, _) in cfgs.items():
        r = trained[key]
        ds, model, exp = r["ds"], r["model"], r["exp"]
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            paths = pred_grid(cfg["idxs"], exp, model, ds, cfg,
                              log_dir=log_dir)
        for p in paths:
            with np.load(p) as z:
                if not np.all(np.isfinite(z["pred"])):
                    raise AssertionError(f"{p}: non-finite prediction")
        factors = [ln.rsplit("improvement ", 1)[1]
                   for ln in "".join(tee.parts).splitlines()
                   if "improvement" in ln]
        if len(factors) != len(cfg["idxs"]):
            raise AssertionError(f"grid_serve {key}: {factors}")
        idx = cfg["idxs"][0]
        with contextlib.redirect_stdout(io.StringIO()):
            request_ms = warm_ms(lambda: pred_grid([idx], exp, model, ds, cfg,
                                                   log_dir=log_dir))
        tr = GridTrainer(model, lr=0.0)
        tr.net.from_jax_params(ckpt.load_params(
            os.path.join(log_dir, "models", f"collection_{exp}",
                         "partition_0.npz")))
        x1 = ds[idx]["x"][None]
        predict_ms = warm_ms(
            lambda: tr.predict(torch.as_tensor(x1, device="cuda")).cpu())
        log("grid_serve", model=key, idxs=cfg["idxs"],
            improvement=",".join(factors), request_ms=f"{request_ms:.3f}",
            predict_ms=f"{predict_ms:.3f}")
        out[key] = dict(request_ms=request_ms, predict_ms=predict_ms,
                        improvement=factors)
    return out


def run_grid(cfgs: dict, root: str, futures: dict) -> dict:
    """The grid phases; the launch counters of B1-B5 stay at 0 (the grid
    path runs no hand-written kernel)."""
    t0 = time.time()
    reset_launches()
    log_dir = os.path.join(root, "grid_logs")
    spectral = phase_grid_spectral(cfgs)
    trained = phase_grid_train(cfgs, log_dir, futures)
    phase_grid_parity()
    served = phase_grid_serve(cfgs, trained, log_dir)
    check_only("grid phases", {})
    log("grid", launches=launches_of(*KERNELS), wall_s=f"{time.time() - t0:.1f}")
    return dict(spectral=spectral, served=served,
                train={k: {f: v[f] for f in ("step_ms", "peak_mib", "impl")}
                       for k, v in trained.items()})


def kernel_entries(r: dict, smi: str, rank, path: str) -> list:
    """The forward's and the backward's entries of the kernels JSON line,
    tagged with the ``path`` that ran them."""
    pkg = "fast_eng_super_resolution_tpu_torch/csrc/"
    # the bfloat16 numbers are the tensor-core design's, in its own source
    # (B3/B4 at a rank that is a multiple of 8); the float32 ones the FMA
    # design's
    suffix = {"bfloat16": "", "float32": ""}
    if fused_conv.design(torch.bfloat16, rank) == "wgmma":
        suffix["bfloat16"] = "_wgmma"
    if rank is None:
        names, lines = ("fused_edge_conv", "fused_edge_conv_bwd"), (322, 442)
    else:
        names = ("fused_edge_conv_lowrank", "fused_edge_conv_lowrank_bwd")
        lines = (637, 717)
    train, t, tb = r["train"], r["t"], r["tb"]
    entries = []
    for name, line, errs, times, launches, by_path, extra in (
            (names[0], lines[0], r["errs"], t,
             r["launches"] + train["fwd"] + train["served"],
             {"serve": r["launches"], "train": train["fwd"],
              "serve_trained": train["served"]},
             {"request_ms": t["request_ms"]}),
            (names[1], lines[1], r["errs_bwd"], tb, train["bwd"],
             {"train": train["bwd"]}, {"train_step_ms": t["train_step_ms"]})):
        entries.append({
            "name": name,
            "path": path,
            "route": "cuda",
            "source": pkg + name + suffix["bfloat16"] + ".cu",
            "design": "wgmma" if suffix["bfloat16"] else "fma",
            "replaces": f"fast_eng_super_resolution_tpu/ops/fused_conv.py:{line}",
            "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": errs["bfloat16"],
            "ms": times["ms_bfloat16"],
            "plain_ms": times["plain_ms_bfloat16"],
            "bound_ms": times["bound_ms_bfloat16"],
            "bound_by": times["bound_by_bfloat16"],
            "library_ms": None,
            "float32": {"source": pkg + name + ".cu", "design": "fma",
                        "max_abs_err": errs["float32"],
                        "ms": times["ms_float32"],
                        "plain_ms": times["plain_ms_float32"],
                        "bound_ms": times["bound_ms_float32"],
                        "bound_by": times["bound_by_float32"]},
            **extra,
            "card": smi,
        })
    return entries


def routed_entries(r: dict, smi: str) -> list:
    """B1's and B2's entries for the routed path: B1's launches by phase
    (full-size routed predicts, the small mesh's routed lane, training)
    and the routed lane's warm time beside the full-size request's."""
    serve, train = r["serve"], r["train"]
    entries = kernel_entries(dict(r, launches=0, train=dict(train, served=0)),
                             smi, None, "kernelnn_routed")
    entries[0].update(
        launches=sum(serve.values()) + train["fwd"],
        launches_by_path={"serve_full": serve["full"],
                          "serve_full_padded": serve["full_padded"],
                          "serve_full_routed_lane": serve["full_lane"],
                          "serve_routed_lane": serve["small"],
                          "train": train["fwd"]},
        routed_lane_ms=r["t"]["routed_lane_ms"])
    return entries


def messages_entry(t: dict, launches: dict, requests: dict,
                   smi: str) -> dict:
    """B5's entry: the numbers at KernelNN's chunk (K 48) at the top, those
    at TEECNet's (K 128) under ``teecnet_k128``, and each model's warm
    request time in modes 'pallas' and 'edge3d'."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "bound_basis", "bound_fma_ms", "k")
    return {
        "name": "fused_edge_messages",
        "path": "kernelnn_pallas",
        "route": "cuda",
        "source": "fast_eng_super_resolution_tpu_torch/csrc/"
                  "fused_edge_messages_wgmma.cu",
        "design": pallas_mp.design(),
        "replaces": "fast_eng_super_resolution_tpu/ops/pallas_mp.py:41",
        "launches": sum(launches.values()),
        "launches_by_path": {f"{k}_pallas": v for k, v in launches.items()},
        **{key: t["kernelnn"][key] for key in keys},
        "teecnet_k128": {key: t["teecnet"][key] for key in keys},
        "request_ms": requests,
        "card": smi,
    }


def main() -> int:
    name, smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    libs = fused_conv.build_kernel(force=True)
    log("build", seconds=f"{time.time() - t0:.1f}",
        libs=",".join(os.path.relpath(lib, REPO) for lib in libs))
    log_ptxas()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root, \
            contextlib.ExitStack() as workers:
        # the grid datasets are host numpy: generated in worker processes
        # while the kernel phases run (stopped before the directory goes)
        grid_cfgs = grid_configs(root)
        grid_pool, grid_futures = start_grid_data(grid_cfgs)
        workers.callback(grid_pool.shutdown, wait=True, cancel_futures=True)
        cfgs = {"full": make_config(os.path.join(root, "full"), FULL),
                "small": make_config(os.path.join(root, "small"), SMALL)}
        # the rank-16 path: the same config with kernel_rank added, at a
        # smaller depth
        cfgs_lr = {k: dict(v, kernel_rank=RANK, num_layers=RANK_DEPTH)
                   for k, v in cfgs.items()}
        # TEECNet: teecnet_ansys.yaml with the same synthetic meshes, hence
        # the same datasets
        cfgs_tc = {k: make_config(os.path.join(root, k), sizes,
                                  TEECNET_CONFIG, "teecnet", TEECNET_TRAIN,
                                  TEECNET_EPOCHS)
                   for k, sizes in (("full", FULL), ("small", SMALL))}
        datasets, models, models_lr, models_tc = {}, {}, {}, {}
        for key, cfg in cfgs.items():
            t1 = time.time()
            datasets[key] = init_dataset("synthetic", **cfg)
            # the same seeded weights for the card's and the CPU's run
            logs = os.path.join(root, "logs")
            for exp, c, into in ((key, cfg, models),
                                 (key + "_r16", cfgs_lr[key], models_lr),
                                 (key + "_teecnet", cfgs_tc[key], models_tc)):
                into[key] = write_checkpoint(logs, exp, c)
                write_checkpoint(logs, exp + "_cpu", c)
            for k in ("root", "partition", "sub_size", "n_high", "n_low",
                      "num_cases"):
                if cfgs_tc[key].get(k) != cfg.get(k):
                    raise AssertionError(f"teecnet config {k} differs")
            log("data", mesh=key, subdomains=len(datasets[key]),
                etl_s=f"{time.time() - t1:.1f}")

        full = run_path(root, name, smi, datasets, models, cfgs)
        lowrank = run_path(root, name, smi, datasets, models_lr, cfgs_lr,
                           "_r16")
        teecnet = run_path(root, name, smi, datasets, models_tc, cfgs_tc,
                           "_teecnet")
        t1 = time.time()
        pallas_launches, pallas_requests = phase_pallas(
            root, datasets, {"kernelnn": (cfgs["full"], ""),
                             "teecnet": (cfgs_tc["full"], "_teecnet")}, smi)
        msg_t = phase_messages({"kernelnn": full["msg"],
                                "teecnet": teecnet["msg"]}, smi)
        log("pallas", wall_s=f"{time.time() - t1:.1f}")
        routed_cfg = load_yaml(ROUTED_CONFIG)
        cfgs_rt = {k: dict(v, n_clusters=routed_cfg["n_clusters"],
                           n_components=routed_cfg["n_components"])
                   for k, v in cfgs.items()}
        routed = run_routed(root, smi, datasets, cfgs_rt)
        coalesced = phase_coalesced(root, datasets["small"], models["small"],
                                    smi)
        t1 = time.time()
        phase_physics_ops(smi)
        smooth_launches = phase_physics_smooth(root, datasets, models, cfgs,
                                               smi)
        phase_physics_amg(smi)
        phase_physics_scale(smi)
        phase_wss(root, smi)
        log("physics", wall_s=f"{time.time() - t1:.1f}")
        t1 = time.time()
        phase_powerseries(root, datasets, cfgs_tc["full"])
        phase_lut(root, datasets, cfgs["full"])
        log("general_modes", wall_s=f"{time.time() - t1:.1f}")
        run_grid(grid_cfgs, root, grid_futures)

    kernels = (kernel_entries(full, smi, None, "kernelnn")
               + kernel_entries(lowrank, smi, RANK, "kernelnn_rank16")
               + kernel_entries(teecnet, smi, None, "teecnet")
               + [messages_entry(msg_t, pallas_launches, pallas_requests,
                                 smi)]
               + routed_entries(routed, smi))
    # the coalesced lane serves the KernelNN path's small-mesh checkpoint
    kernels[0]["launches"] += coalesced["launches"]
    kernels[0]["launches_by_path"]["coalesced"] = coalesced["launches"]
    kernels[0]["coalesced_ms"] = {k: coalesced["t"][k]
                                  for k in ("batch_ms", "singles_ms")}
    # smooth: true serves through the same B1 lane before the projection
    kernels[0]["launches"] += smooth_launches
    kernels[0]["launches_by_path"]["smooth"] = smooth_launches
    log("done", seconds=f"{time.time() - t0:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
