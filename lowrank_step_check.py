"""Warm wall time of the rank-16 path's fused train step on the card, in
bfloat16 and in float32.

    python3 lowrank_step_check.py [--repo DIR]

Builds ``chip_smoke.py``'s rank-16 path (neuralop_synthetic_full.yaml at
width 48 with ``kernel_rank: 16``, depth cut to 2) on its full-size
synthetic duct, the first train batch the scheduler builds (12 subdomains
merged, the fused layout), and times fused Adam steps on it with
``chip_smoke.warm_ms`` (median of 5 after a warm-up, each ending in a
sync): bfloat16 (B3/B4 bfloat16) and float32 (B3/B4 float32).  Prints the
card, the package's directory and both times as one JSON line.  ``--repo``
names the checkout whose ``fast_eng_super_resolution_tpu_torch`` is
imported (default: this one), so a parent commit's package can be measured
with this script beside this one's in one call.  Needs a card.
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
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
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
        cfg = dict(cs.make_config(root, cs.FULL), kernel_rank=cs.RANK,
                   num_layers=cs.RANK_DEPTH)
        ds = cs.init_dataset("synthetic", **cfg)
        model, (fb, _), rows_blk, blk = cs.train_batches(ds, cfg)
        lr = cs.load_yaml(cfg["train_config"])["lr"]
        out = {"card": smi, "package": os.path.dirname(pkg.__file__),
               "rank": cs.RANK, "depth": cs.RANK_DEPTH,
               "train_batch": fb["subdomains"],
               "real_slots": int((fb["fused"]["s"].slot_rows >= 0).sum())}
        for dt in ("bfloat16", "float32"):
            trainer = cs.Trainer(model, lr=lr, layout="fused",
                                 fused_rows_blk=rows_blk, fused_blk=blk,
                                 fused_dtype=dt)
            opt = trainer.init(cs.SEED)
            out[f"train_step_ms_{dt}"] = cs.warm_ms(
                lambda: trainer.step(opt, fb))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
