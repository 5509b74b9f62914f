"""A/B timing of B5 (conv mode 'pallas', csrc/fused_edge_messages_wgmma.cu)
on the card: this checkout's source against another checkout's, in turns in
one process.

    python3 messages_check.py --repo DIR [--pairs 10] [--edges 258048]

Compiles both sources (one nvcc each, started together, the package's
flags) into a temporary directory, loads them with ctypes, and on seeded
operands of ``--edges`` edges (the full-size serving chunk's 258 048 by
default) at each (K, c_in, c_out) of ``SHAPES`` times each library's launch
(the stage image, then the messages) as the median of 20 CUDA-event timed
calls, ``--pairs`` times, the order alternating (DIR first in even pairs).
Checks that both give the same bits.  Prints one ``[messages_ab]`` line per
shape with both sides' medians, every pair and the share of pairs this
checkout won, then the card's name and power limit.  Shapes past the other
checkout's limits run on this checkout alone."""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fast_eng_super_resolution_tpu_torch.ops import fused_conv  # noqa: E402

SOURCE = os.path.join("fast_eng_super_resolution_tpu_torch", "csrc",
                      "fused_edge_messages_wgmma.cu")
SHAPES = ((48, 48, 48), (128, 48, 48), (128, 128, 128), (128, 256, 256),
          (256, 256, 256))


def build(repos: dict, out_dir: str) -> dict:
    """label -> the ctypes library built from that checkout's B5 source."""
    jobs = {}
    for label, repo in repos.items():
        lib = os.path.join(out_dir, f"lib_{label}.so")
        jobs[label] = (lib, subprocess.Popen(
            [fused_conv._nvcc(), *fused_conv._NVCC_FLAGS, "-o", lib,
             os.path.join(repo, SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for label, (path, proc) in jobs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{err}")
        lib = ctypes.CDLL(path)
        fn = lib.fused_edge_messages_wgmma_forward
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        libs[label] = lib
    return libs


def launch(lib, ops: tuple, image: torch.Tensor, out: torch.Tensor) -> int:
    h, x, w3, b3 = ops
    e, k = h.shape
    c_in = x.shape[1]
    return lib.fused_edge_messages_wgmma_forward(
        h.data_ptr(), x.data_ptr(), w3.data_ptr(), b3.data_ptr(),
        image.data_ptr(), out.data_ptr(), e, k, c_in, w3.shape[1] // c_in,
        torch.cuda.current_stream().cuda_stream)


def median_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", required=True,
                    help="the other checkout (for example a parent's)")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--edges", type=int, default=258048)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("messages_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="messages_check_") as tmp:
        libs = build({"other": args.repo, "this": here}, tmp)
        gen = torch.Generator().manual_seed(0)
        for k, c_in, c_out in SHAPES:
            e = args.edges
            scale = (k * c_in) ** -0.5
            ops = tuple(t.cuda() for t in (
                torch.relu(torch.randn(e, k, generator=gen)),
                torch.randn(e, c_in, generator=gen),
                torch.randn(k, c_in * c_out, generator=gen) * scale,
                torch.randn(c_in * c_out, generator=gen) * scale))
            image = torch.empty(fused_conv.image_numel(k, c_out, c_in),
                                dtype=torch.bfloat16, device="cuda")
            outs = {name: torch.empty(e, c_out, device="cuda") for name in libs}
            errs = {name: launch(lib, ops, image, outs[name])
                    for name, lib in libs.items()}
            torch.cuda.synchronize()
            if errs["this"] != 0:
                raise RuntimeError(f"this checkout's launch failed: {errs}")
            sides = [name for name in libs if errs[name] == 0]
            same = (torch.equal(outs["this"], outs["other"])
                    if "other" in sides else None)
            runs = {name: [] for name in sides}
            for i in range(args.pairs):
                order = sides if i % 2 == 0 else sides[::-1]
                for name in order:
                    runs[name].append(median_ms(
                        lambda: launch(libs[name], ops, image, outs[name])))
            meds = {name: statistics.median(v) for name, v in runs.items()}
            wins = (sum(t < o for t, o in zip(runs["this"], runs["other"]))
                    if "other" in sides else None)
            print(f"[messages_ab] k={k} c_in={c_in} c_out={c_out} edges={e} "
                  f"same_bits={same} "
                  + " ".join(f"{name}_ms={m:.4f}" for name, m in meds.items())
                  + f" this_won={wins}/{args.pairs if wins is not None else 0} "
                  + " ".join(f"{name}_runs=" + ",".join(f"{t:.4f}" for t in v)
                             for name, v in runs.items()), flush=True)
            del ops, image, outs
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
