"""A/B timing of B1, B2 and B5 through their wrappers on the card: this
checkout's package against another checkout's, each run in a process of its
own, in the order other, this, this, other.

    python3 conv_check.py --repo DIR [--reps 10]

Each run imports one checkout's ``fast_eng_super_resolution_tpu_torch``
with its kernels built from that checkout's ``csrc/`` into a temporary
directory of that checkout's own (the first run of each builds, the second
loads; neither checkout's tree is written), and on seeded operands of the full-size serving chunk's
size (19 456 nodes, 247 856 edges in 64-row receiver blocks; B5 on the same
edges) times at widths 48 (K 48), 128 and 256 (K = width)
``fused_edge_conv_cuda`` and ``fused_edge_conv_bwd_cuda`` in bfloat16 and
float32 and ``fused_edge_messages_cuda``: the median of ``--reps`` CUDA-event
timed calls after 3 warm ones.  Each result's bytes are hashed, so the two
checkouts' bits are compared too.  Prints one ``[conv_ab]`` line per kernel,
type and width with every run's median, the ratio of this checkout's mean
to the other's and whether the bits agree, then the card's name and power
limit."""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
WIDTHS = (48, 128, 256)
NODES, EDGES = 19456, 247856


def child(repo: str, build_dir: str, reps: int, out: str) -> None:
    """One run: times every kernel of one checkout, its libraries built
    into (or loaded from) ``build_dir``, writes JSON to ``out``."""
    sys.path.insert(0, repo)
    import numpy as np
    import torch

    from fast_eng_super_resolution_tpu_torch.ops import fused_conv, pallas_mp

    pkg_dir = os.path.dirname(os.path.dirname(fused_conv.__file__))
    if os.path.dirname(pkg_dir) != os.path.abspath(repo):
        raise RuntimeError(f"imported {pkg_dir}, not {repo}'s package")
    torch.backends.cuda.matmul.allow_tf32 = False
    fused_conv._BUILD_DIR = build_dir  # the package's libraries go there
    fused_conv.build_kernel()
    rng = np.random.default_rng(0)
    recv = np.sort(rng.integers(0, NODES, EDGES)).astype(np.int32)
    send = rng.integers(0, NODES, EDGES).astype(np.int32)
    blocks = fused_conv.build_scatter_blocks(recv, send, NODES, dense=False)
    s = blocks.compact_s.to("cuda")
    sp = torch.as_tensor(blocks.senders_perm, device="cuda")
    slots = len(blocks.senders_perm)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    def median_ms(fn) -> float:
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

    def digest(result) -> str:
        ts = result if isinstance(result, tuple) else (result,)
        h = hashlib.sha1()
        for t in ts:
            h.update(t.contiguous().view(torch.int32).cpu().numpy().tobytes())
        return h.hexdigest()

    res = {}
    with torch.no_grad():
        for c in WIDTHS:
            k = c
            h = torch.relu(randn(slots, k))
            x = randn(NODES, c)
            w3 = randn(k, c * c, scale=(k * c) ** -0.5)
            b3 = randn(c * c, scale=0.1)
            g = randn(blocks.n_pad, c)
            kw = dict(c_in=c, c_out=c, rows_blk=64, blk=blocks.blk)
            for dt in (torch.bfloat16, torch.float32):
                hd, xd, wd = h.to(dt), x.to(dt), w3.to(dt)
                xs = xd[sp.long()].contiguous()
                name = str(dt).split(".")[1]
                for kernel, fn in (
                        ("B1", lambda: fused_conv.fused_edge_conv_cuda(
                            hd, xd, sp, wd, b3, s, **kw)),
                        ("B2", lambda: fused_conv.fused_edge_conv_bwd_cuda(
                            g, hd, xs, wd, b3, s, **kw))):
                    res[f"{kernel} {name} {c}"] = dict(
                        ms=median_ms(fn), bits=digest(fn()))
            # B5 on the same edges: h per edge, the sender's features
            he = h[:EDGES].contiguous()
            xe = x[torch.as_tensor(send, device="cuda").long()].contiguous()

            def b5():
                return pallas_mp.fused_edge_messages_cuda(he, xe, w3, b3)
            res[f"B5 float32 {c}"] = dict(ms=median_ms(b5), bits=digest(b5()))
            del h, x, w3, b3, g, hd, xd, wd, xs, he, xe
            torch.cuda.empty_cache()
    with open(out, "w") as f:
        json.dump(res, f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", help="the other checkout (required)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--build", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.build, args.reps, args.out)
        return 0
    if not args.repo:
        ap.error("--repo is required")
    other = os.path.abspath(args.repo)
    runs = []
    with tempfile.TemporaryDirectory(prefix="conv_check_") as tmp:
        for i, (label, repo) in enumerate((("other", other), ("this", HERE),
                                           ("this", HERE), ("other", other))):
            out = os.path.join(tmp, f"{i}.json")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", repo,
                            "--build", os.path.join(tmp, f"build_{label}"),
                            "--out", out, "--reps", str(args.reps)],
                           check=True)
            with open(out) as f:
                runs.append((label, json.load(f)))
    for key in runs[0][1]:
        kernel, dtype, width = key.split()
        ms = {lab: [r[key]["ms"] for lb, r in runs if lb == lab]
              for lab in ("other", "this")}
        same = len({r[key]["bits"] for _, r in runs}) == 1
        ratio = statistics.mean(ms["this"]) / statistics.mean(ms["other"])
        print(f"[conv_ab] kernel={kernel} dtype={dtype} width={width} "
              f"other_ms={','.join(f'{v:.4f}' for v in ms['other'])} "
              f"this_ms={','.join(f'{v:.4f}' for v in ms['this'])} "
              f"ratio={ratio:.4f} same_bits={same}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[conv_ab] card={smi!r} order=other,this,this,other", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
