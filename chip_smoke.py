"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, each printing its own lines; any failure raises and the script exits
non-zero without the final result line:

1. device  — needs CUDA; prints the card's name and power limit.
2. build   — compiles the four kernels (csrc/fused_edge_conv.cu, the forward
             B1, csrc/fused_edge_conv_bwd.cu, the backward B2, and their
             rank-r counterparts csrc/fused_edge_conv_lowrank.cu, B3, and
             csrc/fused_edge_conv_lowrank_bwd.cu, B4) from the checkout, one
             nvcc each, started together.
3. kernel  — B1 against its plain PyTorch version on the card, at the
             full-size serving chunk shape, on operands from the real dataset
             chunk: float32 (TF32 off) and bfloat16, compact and dense S.
4. bwd     — B2 against its plain version at the same shape and operands with
             a seeded output gradient, both types and both S forms; then the
             differentiable layer's gradients on the card against the CPU's
             plain ones on the small mesh's graph.
   train batch — both kernels again at the shapes training gives them: the
             first layer's operands of the 12-subdomain train batch and the
             4-subdomain val batch, built as the scheduler builds them (one
             common blk); B1 on both, B2 on the train batch with a seeded
             output gradient, both types and both S forms.
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
edge kernels): B3 and B4 against their plain versions at the same shapes
(``[lowrank_kernel]``, ``[lowrank_bwd]``), serving with 8 B3 launches per
full-size request and none of B1, training with B4 launched depth x steps
times and neither B1 nor B2, card-vs-CPU parity, and their times
(``[lowrank_*]`` lines).

The second-to-last line is a JSON object with the kernels' numbers, the last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

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
from fast_eng_super_resolution_tpu_torch.data.vtu import read_vtu  # noqa: E402
from fast_eng_super_resolution_tpu_torch.models.registry import init_model  # noqa: E402
from fast_eng_super_resolution_tpu_torch.ops import fused_conv  # noqa: E402
from fast_eng_super_resolution_tpu_torch.ops.message_passing import apply_edge_mlp_hidden  # noqa: E402
from fast_eng_super_resolution_tpu_torch.parallel.train import (  # noqa: E402
    Trainer, make_fused_batch, make_fused_batches, train_val_split)
from fast_eng_super_resolution_tpu_torch.runner import pred_graph_ALDD, train_graph_ALDD  # noqa: E402
from fast_eng_super_resolution_tpu_torch.sched.scheduler import PartitionScheduler  # noqa: E402
from fast_eng_super_resolution_tpu_torch.sched.serving import _as_raw_graph, edge_budget  # noqa: E402
from fast_eng_super_resolution_tpu_torch.utils.config import load_yaml  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
BASE_CONFIG = os.path.join(REPO, "configs", "exp_config",
                           "neuralop_synthetic_full.yaml")
TRAIN_CONFIG = os.path.join(REPO, "configs", "train_config",
                            "synthetic_full.yaml")
TRAIN_EPOCHS = 10  # the one cut of synthetic_full.yaml (300 epochs)
FULL = dict(n_high=(48, 24, 24), n_low=(20, 10, 10), sub_size=8, num_cases=2)
SMALL = dict(n_high=(16, 8, 8), n_low=(8, 4, 4), sub_size=4, num_cases=1)
SEED = 0
LAUNCHES = {"full": 8, "small": 4}  # per request: chunks x depth
RANK = 16  # the rank-r path's kernel_rank (the JAX package's lowrank16 rows)
KERNELS = (fused_conv.fused_edge_conv, fused_conv.fused_edge_conv_bwd,
           fused_conv.fused_edge_conv_lowrank,
           fused_conv.fused_edge_conv_lowrank_bwd)
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
# the GEMM inputs (2^-8 relative) through 4 layers -> 3e-2 of the max.
SERVE_TOL = 3e-2

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


def tagged(phase: str, rank) -> str:
    """The log label of ``phase`` on the rank-r path."""
    return phase if rank is None else f"lowrank_{phase}"


def make_model(cfg: dict):
    """The seeded model of ``cfg`` (full rank, or rank ``kernel_rank``)."""
    return init_model("neuralop", cfg["in_channels"], cfg["out_channels"],
                      seed=SEED, kernel_rank=cfg.get("kernel_rank"),
                      **{k: cfg[k] for k in ("width", "num_layers")})


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


def make_config(root: str, sizes: dict) -> dict:
    """The shipped full-width config with this run's mesh sizes and root."""
    cfg = load_yaml(BASE_CONFIG)
    cfg.update(sizes, root=os.path.join(root, "data"),
               idxs=list(range(sizes["num_cases"])))
    return cfg


def write_checkpoint(log_dir: str, exp: str, cfg: dict):
    model = make_model(cfg)
    ckpt.save_params(os.path.join(log_dir, "models", f"collection_{exp}",
                                  "partition_0.npz"),
                     model.to_jax_params(), meta={"model": "KernelNN"})
    return model


def chunk_operands(dataset, model, device):
    """The first serving chunk of mesh 0 (the scheduler's chunking) and the
    first layer's fused operands on ``device``."""
    raw = [_as_raw_graph(d) for d in dataset.get_one_full_sample(0)]
    (_, _, batch), = pad_and_bucket(raw, uniform=True)
    chunk_b = max(1, edge_budget() // batch.senders.shape[1])
    chunk = batch.map(lambda a: a[:chunk_b])
    merged, _ = merge_batch(chunk)
    ea_b, sp, sm, rows_blk, blk = model.prepare_fused(
        merged.senders, merged.receivers, merged.edge_attr,
        merged.x.shape[0], merged.edge_mask, compact=True)
    m = model.to(device)
    with torch.no_grad():
        h_e = apply_edge_mlp_hidden(m.edge_mlp,
                                    torch.as_tensor(ea_b, device=device),
                                    torch.relu).contiguous()
        x = m.fc1(torch.as_tensor(merged.x, device=device)).contiguous()
        w3 = m.edge_mlp[-1].weight.t().contiguous()
        b3 = m.edge_mlp[-1].bias.detach().contiguous()
    return dict(h=h_e, x=x, sp=torch.as_tensor(sp, device=device),
                w3=w3, b3=b3, s=sm.to(device), rows_blk=rows_blk, blk=blk,
                n=merged.x.shape[0], b=chunk.x.shape[0],
                rank=model.kernel_rank)


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


def phase_kernel(op, at: str = "chunk", errs: dict | None = None) -> dict:
    """B1 (B3 on the rank-r path) against its plain version on ``op`` (the
    operands at shape ``at``); returns ``errs`` with each type's largest
    absolute error."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    slots, k = op["h"].shape
    label = tagged("kernel", op["rank"])
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
                    max_abs_err=f"{abs_err:.3e}", rel_to_max=f"{rel:.3e}",
                    tol=KERNEL_TOL[dt])
                if not (rel <= KERNEL_TOL[dt]):
                    raise AssertionError(f"{label} at {at} {dt} dense={dense}: "
                                         f"{rel:.3e} > {KERNEL_TOL[dt]}")
                errs[dt] = max(errs.get(dt, 0.0), abs_err)
            del ref, got
    torch.cuda.empty_cache()
    return errs


def serve(ds, model, idxs, log_dir, exp, device, **kw):
    lanes = []
    paths = pred_graph_ALDD(idxs, exp, model, ds, 1, log_dir=log_dir,
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
    rank = models["full"].kernel_rank
    label = tagged("serve", rank)
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
            check_only(f"{label} {name} request", {kernel: LAUNCHES[name]})
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
    log_times(tagged("times", rank), "fwd", t, smi)
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
    from fast_eng_super_resolution_tpu_torch.data.reconstruct import overlap_average

    sched = PartitionScheduler("full" + tag, 1, datasets["full"],
                               models["full"], train=False,
                               log_dir=os.path.join(root, "logs"))
    x = datasets["full"].get_one_full_sample(0)
    num_nodes = len(datasets["full"].full_mesh(0)["points"])
    gids = [d["global_node_ids"] for d in x]

    def request():
        pred_l, _, _, _ = sched.predict(x)
        return overlap_average(pred_l, gids, num_nodes)

    request()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    label = tagged("times", models["full"].kernel_rank)
    t = {"request_ms": statistics.median(walls) * 1e3}
    t.update(profile_call(request, label + "_request"))
    log_times(label, "request", t, smi)
    return t


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
    with torch.no_grad():
        h = apply_edge_mlp_hidden(model.edge_mlp, torch.as_tensor(ea),
                                  torch.relu)
        x = model.fc1(torch.as_tensor(merged.x))
        w3 = model.edge_mlp[-1].weight.t().contiguous()
        b3 = model.edge_mlp[-1].bias.detach().clone()
    c = x.shape[1]
    g = torch.randn(len(s.row_weight), c,
                    generator=torch.Generator().manual_seed(SEED + 1))
    leaves = [t.to(device).requires_grad_() for t in (h, x, w3, b3)]
    aux = {k: torch.as_tensor(v, device=device) for k, v in aux.items()}
    kw = dict(c_in=c, c_out=c, rows_blk=rows_blk, blk=blk,
              gemm_dtype="float32")
    if model.kernel_rank is None:
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
    label = tagged("bwd", bop["rank"])
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
                        max_abs_err=f"{abs_err:.3e}",
                        rel_to_max=f"{rel:.3e}", tol=BWD_TOL[dt])
                    if not rel <= BWD_TOL[dt]:
                        raise AssertionError(
                            f"{label} kernel at {at} {dt} dense={dense} {name}: "
                            f"{rel:.3e} > {BWD_TOL[dt]}")
                    errs[dt] = max(errs.get(dt, 0.0), abs_err)
            del ref, got
    torch.cuda.empty_cache()
    return errs


def phase_bwd(bop, small_merged, small_model) -> dict:
    """B2 (B4) against its plain version at the chunk shape, then the
    differentiable layer on the card against the CPU."""
    errs = check_bwd(bop)
    model = small_model.cpu()
    rank = model.kernel_rank
    fn = "FusedEdgeConv" if rank is None else "FusedEdgeConvLowrank"
    card = layer_grads(small_merged, model, "cuda")
    torch.cuda.synchronize()
    for name, a, b in zip(("h", "x", "w3", "b3"), card,
                          layer_grads(small_merged, model, "cpu")):
        rel = (a - b).abs().max().item() / b.abs().max().item()
        log(tagged("bwd", rank), layer=fn, grad=name,
            card_vs_cpu=f"{rel:.3e}", tol=GRAD_TOL)
        if not rel <= GRAD_TOL:
            raise AssertionError(f"{fn} grad {name}: {rel:.3e}")
    return errs


def train_batches(ds, cfg: dict):
    """(model, [train batch, val batch], rows_blk, blk): the fused batches
    ``PartitionScheduler.train`` builds for ``ds`` with seed 0 and a batch
    size of at least 12 — the train and val subdomains each merged into one
    graph, both blocked with one common blk — on the card, with a seeded
    full-width model."""
    tr_idx, va_idx = train_val_split(len(ds), 0.2, 0)
    model = make_model(cfg).cuda()
    fbs, rows_blk, blk = make_fused_batches(
        [merged_subdomains(ds, ix) for ix in (tr_idx, va_idx)], model)
    for fb, ix in zip(fbs, (tr_idx, va_idx)):
        fb["subdomains"] = len(ix)
    return model, fbs, rows_blk, blk


def batch_operands(fb, model, rows_blk: int, blk: int) -> dict:
    """The first conv layer's operands of a fused training batch, as
    ``apply_fused_ad`` hands them to the layer."""
    g, fused = fb["graph"], fb["fused"]
    with torch.no_grad():
        h_e = apply_edge_mlp_hidden(model.edge_mlp, fused["edge_attr"],
                                    torch.relu).contiguous()
        x = model.fc1(g.x).contiguous()
        w3 = model.edge_mlp[-1].weight.t().contiguous()
        b3 = model.edge_mlp[-1].bias.detach().contiguous()
    return dict(h=h_e, x=x, sp=fused["aux"]["senders_perm"], w3=w3, b3=b3,
                s=fused["s"], rows_blk=rows_blk, blk=blk, n=g.x.shape[0],
                b=fb["subdomains"], rank=model.kernel_rank)


def phase_train_kernels(batches, errs: dict, errs_bwd: dict) -> None:
    """Both kernels against their plain versions at the shapes training
    gives them: B1 (B3) on the train and val batches, B2 (B4) on the train
    batch."""
    model, fbs, rows_blk, blk = batches
    for at, fb in zip(("train_batch", "val_batch"), fbs):
        op = batch_operands(fb, model, rows_blk, blk)
        phase_kernel(op, at, errs)
        if at == "train_batch":
            check_bwd(bwd_operands(op), at, errs_bwd)
        del op
        torch.cuda.empty_cache()


def phase_train(root: str, datasets: dict, cfgs: dict, tag: str = "") -> dict:
    """The training slice end to end: train_graph_ALDD on the full-size
    meshes (exp ``train_full{tag}``), launch counts (B1 and B2, or B3 and
    B4 for a rank-r config, and no other kernel), then the trained
    checkpoint served."""
    log_dir = os.path.join(root, "logs")
    cfg, ds = cfgs["full"], datasets["full"]
    rank = cfg.get("kernel_rank")
    label = tagged("train", rank)
    fwd, bwd_k = FWD[rank is not None][0], BWD[rank is not None][0]
    exp = "train_full" + tag
    train_cfg = load_yaml(TRAIN_CONFIG)
    log(label, config=os.path.relpath(TRAIN_CONFIG, REPO),
        cut=f"epochs {train_cfg['epochs']} -> {TRAIN_EPOCHS}",
        val_interval=f"{train_cfg['val_interval']} -> 1")
    train_cfg.update(epochs=TRAIN_EPOCHS, val_interval=1)
    depth = cfg["num_layers"]
    tr_idx, va_idx = train_val_split(len(ds), 0.2, 0)
    n_batches = [-(-len(ix) // min(train_cfg["batch_size"], len(tr_idx)))
                 for ix in (tr_idx, va_idx)]
    model = make_model(cfg)
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
    steps = TRAIN_EPOCHS * n_batches[0]
    evals = len(vals) * n_batches[1]
    log(label, subdomains=len(ds), train=len(tr_idx), val=len(va_idx),
        epochs=len(losses), steps=steps, val_evals=evals,
        first_loss=f"{losses[0]:.5g}", last_loss=f"{losses[-1]:.5g}",
        best_val=f"{min(vals):.5g}", rank=rank, fwd_launches=n_fwd,
        bwd_launches=n_bwd, wall_s=f"{wall:.1f}",
        losses=",".join(f"{v:.5g}" for v in losses),
        val_losses=",".join(f"{v:.5g}" for v in vals))
    if len(losses) != TRAIN_EPOCHS or not np.all(np.isfinite(losses + vals)):
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
               {fwd: LAUNCHES["full"]})
    return dict(fwd=n_fwd, bwd=n_bwd, served=served, steps=steps,
                evals=evals, losses=losses)


def phase_parity(small_merged, cfg: dict) -> None:
    """Three float32 fused train steps on the card (kernels) and on the CPU
    (plain versions), from the same seeded weights."""
    lr = load_yaml(TRAIN_CONFIG)["lr"]
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
        log(tagged("parity", cfg.get("kernel_rank")), step=step,
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
    log_times(tagged("times", rank), "bwd", t, smi)
    return t


def phase_train_times(batches, smi) -> dict:
    """Warm wall time of one fused bf16 train step on the training batch
    (the 12 train subdomains merged), and one profiled step."""
    model, (fb, _), rows_blk, blk = batches
    s = fb["fused"]["s"]
    label = tagged("times", model.kernel_rank)
    log(label, train_batch=fb["subdomains"], nodes=fb["graph"].x.shape[0],
        edges=int(fb["graph"].edge_mask.sum()), blk=blk,
        slots=len(s.slot_rows), real_slots=int((s.slot_rows >= 0).sum()))
    trainer = Trainer(model, lr=load_yaml(TRAIN_CONFIG)["lr"], layout="fused",
                      fused_rows_blk=rows_blk, fused_blk=blk)
    opt = trainer.init(SEED)

    def step():
        return trainer.step(opt, fb)

    step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    t = {"train_step_ms": statistics.median(walls) * 1e3}
    t.update({f"train_{k}": v for k, v in
              profile_call(step, label + "_train_step").items()})
    log_times(label, "train_step", t, smi)
    return t


def run_path(root, name, smi, datasets, models, cfgs, tag: str = "") -> dict:
    """Phases 3-8 for one model configuration (full rank, or rank r with
    ``tag``): kernels against their plain versions at the chunk and the
    training batches, serving, training, parity, times.  Returns what the
    kernels' JSON entries need."""
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
    t.update(phase_train_times(batches, smi))
    del op, bop, batches
    torch.cuda.empty_cache()
    return dict(errs=errs, errs_bwd=errs_bwd, launches=launches, train=train,
                t=t, tb=tb)


def kernel_entries(r: dict, smi: str, rank) -> list:
    """The forward's and the backward's entries of the kernels JSON line."""
    pkg = "fast_eng_super_resolution_tpu_torch/csrc/"
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
            "route": "cuda",
            "source": pkg + name + ".cu",
            "replaces": f"fast_eng_super_resolution_tpu/ops/fused_conv.py:{line}",
            "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": errs["bfloat16"],
            "ms": times["ms_bfloat16"],
            "plain_ms": times["plain_ms_bfloat16"],
            "bound_ms": times["bound_ms_bfloat16"],
            "bound_by": times["bound_by_bfloat16"],
            "library_ms": None,
            "float32": {"max_abs_err": errs["float32"],
                        "ms": times["ms_float32"],
                        "plain_ms": times["plain_ms_float32"],
                        "bound_ms": times["bound_ms_float32"],
                        "bound_by": times["bound_by_float32"]},
            **extra,
            "card": smi,
        })
    return entries


def main() -> int:
    name, smi = phase_device()
    t0 = time.time()
    libs = fused_conv.build_kernel(force=True)
    log("build", seconds=f"{time.time() - t0:.1f}",
        libs=",".join(os.path.relpath(lib, REPO) for lib in libs))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        cfgs = {"full": make_config(os.path.join(root, "full"), FULL),
                "small": make_config(os.path.join(root, "small"), SMALL)}
        # the rank-16 path: the same config with kernel_rank added
        cfgs_lr = {k: dict(v, kernel_rank=RANK) for k, v in cfgs.items()}
        datasets, models, models_lr = {}, {}, {}
        for key, cfg in cfgs.items():
            t1 = time.time()
            datasets[key] = init_dataset("synthetic", **cfg)
            # the same seeded weights for the card's and the CPU's run
            logs = os.path.join(root, "logs")
            models[key] = write_checkpoint(logs, key, cfg)
            write_checkpoint(logs, key + "_cpu", cfg)
            models_lr[key] = write_checkpoint(logs, key + "_r16", cfgs_lr[key])
            write_checkpoint(logs, key + "_r16_cpu", cfgs_lr[key])
            log("data", mesh=key, subdomains=len(datasets[key]),
                etl_s=f"{time.time() - t1:.1f}")

        full = run_path(root, name, smi, datasets, models, cfgs)
        lowrank = run_path(root, name, smi, datasets, models_lr, cfgs_lr,
                           "_r16")

    kernels = (kernel_entries(full, smi, None)
               + kernel_entries(lowrank, smi, RANK))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
