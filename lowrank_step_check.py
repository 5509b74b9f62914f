"""Warm wall time of a rank-r path's fused train step on the card, in
bfloat16 and in float32, and optionally B3's and B4's times at other ranks.

    python3 lowrank_step_check.py [--repo DIR] [--rank R] [--width W]
                                  [--kernel-ranks R1,R2,...]

Builds ``chip_smoke.py``'s rank-r path (neuralop_synthetic_full.yaml at
width 48 with ``kernel_rank: R``, default 16, depth cut to 2; with
``--width`` 128 or 256, its width-128 rank-r path's config,
neuralop_synthetic_w64.yaml at that width and K, depth 2) on its
full-size synthetic duct, the first train batch the scheduler builds (12
subdomains merged, the fused layout), and times fused Adam steps on it with
``chip_smoke.warm_ms`` (median of 5 after a warm-up, each ending in a
sync): bfloat16 (B3/B4 bfloat16) and float32 (B3/B4 float32).  With
``--kernel-ranks``, also B3 and B4 (and their plain versions) at each of
those ranks on the full-size serving chunk, with a seeded model of that
rank, in both types (``chip_smoke.fwd_times`` and ``phase_bwd_times``:
CUDA-event medians, and the bound of the real rank's work; past width 48
the plain versions on the chunk's leading ``chip_smoke.WIDE_SLICE_BLOCKS``
receiver blocks, over ``chip_smoke.WIDE_REPS`` launches), each with the
design ``fused_conv.design`` names.  Prints the card, the package's
directory and the times as one JSON line, last.  ``--repo`` names the
checkout whose ``fast_eng_super_resolution_tpu_torch`` is imported
(default: this one), so a parent commit's package can be measured with
this script beside this one's in one call.  Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=REPO,
                    help="checkout whose package is imported")
    ap.add_argument("--rank", type=int, default=16,
                    help="the path's kernel_rank")
    ap.add_argument("--width", type=int, default=48, choices=(48, 128, 256),
                    help="the path's width (and K)")
    ap.add_argument("--kernel-ranks", default="",
                    help="comma-separated ranks at which B3 and B4 are timed")
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    kernel_ranks = [int(r) for r in args.kernel_ranks.split(",") if r]
    # the package of --repo first; chip_smoke.py (this checkout's) then
    # finds it already imported
    sys.path.insert(0, repo)
    import torch

    import fast_eng_super_resolution_tpu_torch as pkg
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="lowrank_step_") as root:
        wide = args.width != 48
        base = dict(cs.make_config(root, cs.FULL, cs.W64_CONFIG),
                    width=args.width) if wide else cs.make_config(root,
                                                                  cs.FULL)
        cfg = dict(base, kernel_rank=args.rank, num_layers=cs.RANK_DEPTH)
        ds = cs.init_dataset("synthetic", **cfg)
        model, (fb, _), rows_blk, blk = cs.train_batches(ds, cfg)
        lr = cs.load_yaml(cfg["train_config"])["lr"]
        out = {"card": smi, "package": os.path.dirname(pkg.__file__),
               "rank": args.rank, "width": args.width,
               "depth": cs.RANK_DEPTH,
               "train_batch": fb["subdomains"],
               "real_slots": int((fb["fused"]["s"].slot_rows >= 0).sum())}
        for dt in ("bfloat16", "float32"):
            trainer = cs.Trainer(model, lr=lr, layout="fused",
                                 fused_rows_blk=rows_blk, fused_blk=blk,
                                 fused_dtype=dt)
            opt = trainer.init(cs.SEED)
            out[f"train_step_ms_{dt}"] = cs.warm_ms(
                lambda: trainer.step(opt, fb))
        del model, fb
        kernels = {}
        for rank in kernel_ranks:
            op = cs.chunk_operands(ds, cs.make_model(dict(cfg,
                                                          kernel_rank=rank)),
                                   "cuda")
            if wide:  # the plain versions on the chunk's leading slice
                w = args.width
                sop = cs.wide_slice(op, w, w, w, rank)
                t = cs.fwd_times(op, smi, plain_op=sop, reps=cs.WIDE_REPS)
                tb = cs.phase_bwd_times(cs.bwd_operands(op), smi,
                                        plain_bop=cs.bwd_operands(sop),
                                        reps=cs.WIDE_REPS)
                del sop
            else:
                t, tb = cs.fwd_times(op, smi), cs.phase_bwd_times(
                    cs.bwd_operands(op), smi)
            kernels[str(rank)] = {
                "design": {dt: cs.design_of(op, dt)
                           for dt in ("bfloat16", "float32")},
                **{f"{name}_{k}_{dt}": times[f"{k}_{dt}"]
                   for name, times in (("b3", t), ("b4", tb))
                   for dt in ("bfloat16", "float32")
                   for k in ("ms", "plain_ms", "bound_ms")}}
            del op
            torch.cuda.empty_cache()
        if kernels:
            out["kernels"] = kernels
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
