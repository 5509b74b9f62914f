"""Phase 7's float32 parity of chip_smoke.py's width-256 paths, three ways:
the card through the kernels, the card through the kernels' plain versions,
and the CPU through the plain versions, from the same seeded weights.

    python3 parity_plain_check.py [--ranks 32,64] [--full-rank]

For each ``kernel_rank`` of ``--ranks`` (and, with ``--full-rank``, the
full-rank model) builds chip_smoke.py's width-256 small-mesh config
(neuralop_synthetic_w64.yaml at width 256, K 256, depth 2, on the small
synthetic duct's merged subdomains) and runs three free-running float32
fused Adam steps at the config's lr on each side from the seeded weights
(``chip_smoke.py``'s phase 7 starts each card step from the CPU's state at
that step instead, for the reason this script measures).  The
card's plain side runs the same model with the layer's wrappers pointed at
their plain versions.  Prints each step's loss on each side and its
relative difference from the CPU's, and, for the first step's gradients
(Adam's first update is lr g / (|g| + eps), about lr sign(g)), the entries
whose sign differs from the CPU's: their count, the count of those larger
than Adam's eps on either side (which move the weights 2 lr apart), and the
largest of them relative to its tensor's largest entry.  Prints the card
and the results as one JSON line, last.  Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
from fast_eng_super_resolution_tpu_torch.ops import fused_conv  # noqa: E402

ADAM_EPS = 1e-8  # the Trainer's Adam eps
WRAPPERS = ("fused_edge_conv", "fused_edge_conv_bwd",
            "fused_edge_conv_lowrank", "fused_edge_conv_lowrank_bwd")


@contextlib.contextmanager
def plain_wrappers():
    """The conv layers' wrappers replaced by their plain versions while the
    block runs, so that the model runs them on CUDA tensors."""
    saved = {name: getattr(fused_conv, name) for name in WRAPPERS}
    try:
        for name in WRAPPERS:
            setattr(fused_conv, name, getattr(fused_conv, name + "_plain"))
        yield
    finally:
        for name, fn in saved.items():
            setattr(fused_conv, name, fn)


def steps(small_merged, cfg: dict, dev: str) -> tuple:
    """(the three losses, the first step's gradients by parameter name, on
    the CPU) of ``cfg``'s seeded model on ``dev``."""
    lr = cs.load_yaml(cfg["train_config"])["lr"]
    model = cs.make_model(cfg)
    fb, rows_blk, blk = cs.make_fused_batch(small_merged, model, device=dev)
    trainer = cs.Trainer(model.to(dev), lr=lr, layout="fused",
                         fused_rows_blk=rows_blk, fused_blk=blk,
                         fused_dtype="float32")
    opt = trainer.init()
    losses, grads = [], None
    for _ in range(3):
        losses.append(float(trainer.step(opt, fb)))
        if grads is None:
            grads = {name: p.grad.detach().cpu().clone()
                     for name, p in model.named_parameters()
                     if p.grad is not None}
    return losses, grads


def sign_flips(grads: dict, ref: dict) -> dict:
    """The first step's gradient entries whose sign differs from ``ref``'s."""
    n = moved = 0
    worst = 0.0
    for name, g in grads.items():
        r = ref[name]
        flip = torch.sign(g) != torch.sign(r)
        n += int(flip.sum())
        moved += int((flip & (torch.maximum(g.abs(), r.abs())
                              > ADAM_EPS)).sum())
        if flip.any():
            top = float(r.abs().max())
            worst = max(worst, float(r.abs()[flip].max()) / top if top else 0)
    return {"entries": sum(g.numel() for g in ref.values()), "flips": n,
            "flips_past_eps": moved, "largest_flip_rel": worst}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", default="32,64",
                    help="comma-separated kernel_ranks")
    ap.add_argument("--full-rank", action="store_true",
                    help="also the full-rank model")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    ranks = [int(r) for r in args.ranks.split(",") if r]
    out = {"card": smi, "width": cs.WIDER, "depth": cs.WIDE_DEPTH,
           "tol": cs.PARITY_TOL, "runs": {}}
    with tempfile.TemporaryDirectory(prefix="parity_plain_") as root:
        cfg = dict(cs.make_config(root, cs.SMALL, cs.W64_CONFIG),
                   width=cs.WIDER, num_layers=cs.WIDE_DEPTH)
        small_merged = cs.merged_subdomains(
            cs.init_dataset("synthetic", **cfg))
        for rank in ([None] if args.full_rank else []) + ranks:
            c = dict(cfg, kernel_rank=rank)
            cpu, g_cpu = steps(small_merged, c, "cpu")
            card, g_card = steps(small_merged, c, "cuda")
            with plain_wrappers():
                plain, g_plain = steps(small_merged, c, "cuda")
            run = {"cpu": cpu}
            for side, losses, grads in (("kernels", card, g_card),
                                        ("card_plain", plain, g_plain)):
                run[side] = losses
                run[f"{side}_rel"] = [abs(a - b) / abs(b)
                                      for a, b in zip(losses, cpu)]
                run[f"{side}_sign"] = sign_flips(grads, g_cpu)
            run["kernels_vs_card_plain_sign"] = sign_flips(g_card, g_plain)
            key = "full" if rank is None else f"rank{rank}"
            for side in ("kernels", "card_plain"):
                cs.log(f"parity_{key}", side=side,
                       losses=",".join(f"{v:.8g}" for v in run[side]),
                       cpu=",".join(f"{v:.8g}" for v in cpu),
                       rel=",".join(f"{v:.3e}" for v in run[f"{side}_rel"]),
                       **run[f"{side}_sign"])
            out["runs"][key] = run
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
