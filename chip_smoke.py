"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, each printing its own line; any failure raises and the script exits
non-zero without the final result line:

1. device  — needs CUDA; prints the card's name and power limit.
2. build   — compiles the fused edge-conv kernel (csrc/fused_edge_conv.cu)
             from the checkout with nvcc.
3. kernel  — the kernel against its plain PyTorch version on the card, at the
             full-size serving chunk shape, on operands from the real dataset
             chunk: float32 (TF32 off) and bfloat16, compact and dense S.
4. serve   — the port's ``pred_graph_ALDD`` on the synthetic duct at the full
             width of configs/exp_config/neuralop_synthetic_full.yaml (width
             48, depth 4) with a seeded checkpoint: two full-size meshes
             (general lane, 2 chunks x 4 layers = 8 launches each) and one
             small mesh (fast lane, 4 launches); every .vtu finite; the card's
             prediction against the port's float32 plain prediction on the CPU.
5. times   — CUDA-event medians of the kernel and its plain version, and the
             warm wall time of one full-size request.

The second-to-last line is a JSON object with the kernel's numbers, the last
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
from fast_eng_super_resolution_tpu_torch.runner import pred_graph_ALDD  # noqa: E402
from fast_eng_super_resolution_tpu_torch.sched.scheduler import PartitionScheduler  # noqa: E402
from fast_eng_super_resolution_tpu_torch.sched.serving import _as_raw_graph, edge_budget  # noqa: E402
from fast_eng_super_resolution_tpu_torch.utils.config import load_yaml  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
BASE_CONFIG = os.path.join(REPO, "configs", "exp_config",
                           "neuralop_synthetic_full.yaml")
FULL = dict(n_high=(48, 24, 24), n_low=(20, 10, 10), sub_size=8, num_cases=2)
SMALL = dict(n_high=(16, 8, 8), n_low=(8, 4, 4), sub_size=4, num_cases=1)
SEED = 0
LAUNCHES = {"full": 8, "small": 4}  # per request: chunks x depth

# Kernel vs plain version on the card, relative to the output's max.  Both
# round h, x and w3 to the GEMM type identically and then work in float32,
# summing ~2.4k products per slot in different orders: ~1e-6 expected.
KERNEL_TOL = {"float32": 5e-5, "bfloat16": 1e-4}
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
    model = init_model("neuralop", cfg["in_channels"], cfg["out_channels"],
                       seed=SEED, **{k: cfg[k] for k in ("width", "num_layers")})
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
                n=merged.x.shape[0], b=chunk.x.shape[0])


def layer(op, gemm_dtype, plain=False, dense=False):
    fn = fused_conv.fused_edge_conv_plain if plain else fused_conv.fused_edge_conv
    s = op["s"]
    if dense:
        s = fused_conv.expand_s(s.slot_rows, s.row_weight,
                                rows_blk=op["rows_blk"], blk=op["blk"])
    c = op["x"].shape[1]
    return fn(op["h"], op["x"], op["sp"], op["w3"], op["b3"], s, c_in=c,
              c_out=c, rows_blk=op["rows_blk"], blk=op["blk"],
              gemm_dtype=gemm_dtype)


def phase_kernel(op) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    slots, k = op["h"].shape
    log("kernel", n=op["n"], subdomains=op["b"], num_blocks=slots // op["blk"],
        blk=op["blk"], slots=slots,
        real_slots=int((op["s"].slot_rows >= 0).sum()), k=k,
        c=op["x"].shape[1])
    errs = {}
    with torch.no_grad():
        for dt in ("float32", "bfloat16"):
            ref = layer(op, dt, plain=True)
            for dense in (False, True):
                got = layer(op, dt, dense=dense)
                torch.cuda.synchronize()
                abs_err = (got - ref).abs().max().item()
                rel = abs_err / ref.abs().max().item()
                log("kernel", dtype=dt, s="dense" if dense else "compact",
                    max_abs_err=f"{abs_err:.3e}", rel_to_max=f"{rel:.3e}",
                    tol=KERNEL_TOL[dt])
                if not (rel <= KERNEL_TOL[dt]):
                    raise AssertionError(f"kernel {dt} dense={dense}: "
                                         f"{rel:.3e} > {KERNEL_TOL[dt]}")
                errs.setdefault(dt, 0.0)
                errs[dt] = max(errs[dt], abs_err)
    return errs


def serve(ds, model, cfg, idxs, log_dir, exp, device, **kw):
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


def phase_serve(root: str, datasets: dict, models: dict, cfgs: dict) -> int:
    log_dir = os.path.join(root, "logs")
    launches = 0
    card = {}
    for name, idxs in (("full", cfgs["full"]["idxs"]), ("small", [0])):
        for idx in idxs:
            fused_conv.fused_edge_conv.launches = 0
            t0 = time.time()
            lanes, fields = serve(datasets[name], models[name], cfgs[name],
                                  [idx], log_dir, name, None)
            torch.cuda.synchronize()
            got = fused_conv.fused_edge_conv.launches
            launches += got
            want_lane = "general" if name == "full" else "fast"
            log("serve", mesh=name, idx=idx, lane=lanes[0][1],
                reason=repr(lanes[0][2]), launches=got,
                nodes=len(fields[0]["pressure"]),
                cold_s=f"{time.time() - t0:.3f}")
            if lanes[0][1] != want_lane:
                raise AssertionError(f"{name} mesh took lane {lanes[0][1]}")
            if got != LAUNCHES[name]:
                raise AssertionError(f"{name} request launched the kernel "
                                     f"{got} times, expected {LAUNCHES[name]}")
            card[(name, idx)] = fields[0]
    # the card's bf16 serving against the port's float32 plain version on the
    # CPU, same checkpoint and mesh
    for name in ("full", "small"):
        t0 = time.time()
        _, (ref,) = serve(datasets[name], models[name], cfgs[name], [0],
                          log_dir, name + "_cpu", "cpu", gemm_dtype="float32")
        for key in ("velocity", "pressure"):
            r, g = ref[key], card[(name, 0)][key]
            rel = np.abs(g - r).max() / np.abs(r).max()
            log("serve", mesh=name, field=key, vs_cpu_f32=f"{rel:.3e}",
                tol=SERVE_TOL, cpu_s=f"{time.time() - t0:.1f}")
            if not rel <= SERVE_TOL:
                raise AssertionError(f"{name} {key}: {rel:.3e} > {SERVE_TOL}")
    return launches


def phase_times(op, datasets, models, root, smi) -> dict:
    t = {}
    c = op["x"].shape[1]
    with torch.no_grad():
        for dt in ("bfloat16", "float32"):
            # operands already in the GEMM type, as apply_fused hands them
            # over (it casts h and w3 once per forward, x once per layer)
            tdt = getattr(torch, dt)
            h, x, w3 = (op[key].to(tdt).contiguous() for key in ("h", "x", "w3"))
            t[f"ms_{dt}"] = cuda_ms(lambda: fused_conv.fused_edge_conv_cuda(
                h, x, op["sp"], w3, op["b3"], op["s"], c_in=c, c_out=c,
                rows_blk=op["rows_blk"], blk=op["blk"]))
            t[f"plain_ms_{dt}"] = cuda_ms(
                lambda: fused_conv.fused_edge_conv_plain(
                    h, x, op["sp"], w3, op["b3"], op["s"], c_in=c, c_out=c,
                    rows_blk=op["rows_blk"], blk=op["blk"], gemm_dtype=dt),
                reps=5)
    # bound: real slots' operations at the input type's peak vs every input
    # byte read once and the output written once
    slots, k = op["h"].shape
    real = int((op["s"].slot_rows >= 0).sum())
    flops = real * (2 * (k + 1) * c * c + 2 * c)
    for dt, size in (("bfloat16", 2), ("float32", 4)):
        nbytes = (size * (op["h"].numel() + op["x"].numel() + op["w3"].numel())
                  + 4 * (op["b3"].numel() + op["sp"].numel()
                         + op["s"].slot_rows.numel() + op["s"].row_weight.numel()
                         + (slots // op["blk"]) * op["rows_blk"] * c))
        t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_PER_S
        t[f"bound_ms_{dt}"] = max(t_ops, t_bytes) * 1e3
        t[f"bound_by_{dt}"] = "operations" if t_ops >= t_bytes else "bytes"
        t[f"flops_{dt}"], t[f"bytes_{dt}"] = flops, nbytes
    # one warm full-size request: predict (2 chunks) + node weights + host
    # overlap average, on a scheduler whose operand cache is warm
    from fast_eng_super_resolution_tpu_torch.data.reconstruct import overlap_average

    sched = PartitionScheduler("full", 1, datasets["full"], models["full"],
                               train=False, log_dir=os.path.join(root, "logs"))
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
    t["request_ms"] = statistics.median(walls) * 1e3
    t.update(profile_request(request))
    for key, v in t.items():
        log("times", **{key: v if isinstance(v, (int, str)) else f"{v:.4f}"},
            card=repr(smi))
    return t


def profile_request(request) -> dict:
    """Where one warm request's time goes: torch.profiler's device time by
    kernel, and the device's busy share of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # self time: a kernel's own device time, not again under the op that
    # launched it
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    for key, us, count in rows[:8]:
        log("profile", kernel=repr(key[:60]), device_ms=f"{us / 1e3:.3f}",
            calls=count)
    busy = sum(us for _, us, _ in rows)
    if not rows:  # the profiler saw no device activity: no share to report
        log("profile", device_time="not measured")
        return {}
    return {"profiled_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us}


def main() -> int:
    name, smi = phase_device()
    t0 = time.time()
    lib = fused_conv.build_kernel(force=True)
    log("build", seconds=f"{time.time() - t0:.1f}", lib=os.path.relpath(lib, REPO))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        cfgs = {"full": make_config(os.path.join(root, "full"), FULL),
                "small": make_config(os.path.join(root, "small"), SMALL)}
        datasets, models = {}, {}
        for key, cfg in cfgs.items():
            t1 = time.time()
            datasets[key] = init_dataset("synthetic", **cfg)
            # the same seeded weights for the card's and the CPU's run
            models[key] = write_checkpoint(os.path.join(root, "logs"), key, cfg)
            write_checkpoint(os.path.join(root, "logs"), key + "_cpu", cfg)
            log("data", mesh=key, subdomains=len(datasets[key]),
                etl_s=f"{time.time() - t1:.1f}")

        op = chunk_operands(datasets["full"], models["full"], "cuda")
        errs = phase_kernel(op)
        launches = phase_serve(root, datasets, models, cfgs)
        t = phase_times(op, datasets, models, root, smi)

    kernels = [{
        "name": "fused_edge_conv",
        "route": "cuda",
        "source": "fast_eng_super_resolution_tpu_torch/csrc/fused_edge_conv.cu",
        "replaces": "fast_eng_super_resolution_tpu/ops/fused_conv.py:322",
        "launches": launches,
        "max_abs_err": errs["bfloat16"],
        "ms": t["ms_bfloat16"],
        "plain_ms": t["plain_ms_bfloat16"],
        "bound_ms": t["bound_ms_bfloat16"],
        "bound_by": t["bound_by_bfloat16"],
        "library_ms": None,
        "float32": {"max_abs_err": errs["float32"], "ms": t["ms_float32"],
                    "plain_ms": t["plain_ms_float32"],
                    "bound_ms": t["bound_ms_float32"],
                    "bound_by": t["bound_by_float32"]},
        "request_ms": t["request_ms"],
        "card": smi,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
