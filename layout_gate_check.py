"""Three training steps of a power-series TEECNet on the card and on the CPU.

    python3 layout_gate_check.py [--repo DIR]

Trains ``TEECNet(kernel_type='powerseries')`` (teecnet_ansys.yaml's width
48 and 5 layers) through ``runner.train_graph_ALDD`` in the training layout
the scheduler picks by default, once on ``cuda`` and once on the CPU, from
the same seeded weights, on a small synthetic duct: 3 epochs of one batch
each, so each logged train loss is one step's.  Prints the losses of both
and their largest relative difference as one JSON line.  The model has no
fused form, so both must train through its own ``apply`` and agree to
float32 rounding.  ``--repo`` names the checkout whose
``fast_eng_super_resolution_tpu_torch`` is imported (default: this one), so
a parent commit's package can be measured with this script.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
SMALL = dict(n_high=(16, 8, 8), n_low=(8, 4, 4), sub_size=4, num_cases=1)
STEPS = 3


def powerseries_train_losses(root: str, device: str) -> list[float]:
    """The per-step train losses of ``STEPS`` steps of a seeded
    power-series TEECNet through ``train_graph_ALDD`` on ``device``, with
    the default layout, on the small duct under ``root``."""
    import numpy as np

    from fast_eng_super_resolution_tpu_torch.data.dataset import init_dataset
    from fast_eng_super_resolution_tpu_torch.models.teecnet import TEECNet
    from fast_eng_super_resolution_tpu_torch.runner import train_graph_ALDD
    from fast_eng_super_resolution_tpu_torch.utils.config import load_yaml

    cfg = load_yaml(os.path.join(REPO, "configs", "exp_config",
                                 "teecnet_ansys.yaml"))
    cfg.update(SMALL, root=os.path.join(root, "data"))
    ds = init_dataset("synthetic", **cfg)
    train_cfg = load_yaml(os.path.join(REPO, "configs", "train_config",
                                       "teecnet.yaml"))
    # one batch per epoch: the batch holds every training subdomain
    train_cfg.update(epochs=STEPS, batch_size=len(ds), val_interval=1,
                     log_interval=1)
    model = TEECNet(cfg["in_channels"], cfg["width"], cfg["out_channels"],
                    cfg["num_layers"], kernel_type="powerseries", seed=0)
    exp = f"ps_{device}"
    log_dir = os.path.join(root, "logs")
    train_graph_ALDD(exp, model, ds, 1, train_cfg, log_dir=log_dir,
                     device=device)
    with open(os.path.join(log_dir, "metrics",
                           f"{exp}_partition_0.jsonl")) as f:
        losses = [json.loads(ln)["train_loss"] for ln in f
                  if "train_loss" in ln]
    if len(losses) != STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{device}: losses {losses}")
    return losses


def compare(root: str) -> dict:
    """Both devices' losses and their largest relative difference."""
    card = powerseries_train_losses(root, "cuda")
    cpu = powerseries_train_losses(root, "cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    return {"card": card, "cpu": cpu, "max_rel": rel}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=REPO)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch

    if not torch.cuda.is_available():
        print("layout_gate_check: needs a CUDA device", file=sys.stderr)
        return 2
    import fast_eng_super_resolution_tpu_torch as port

    with tempfile.TemporaryDirectory(prefix="layout_gate_") as root:
        out = compare(root)
    out.update(package=os.path.dirname(port.__file__),
               device=torch.cuda.get_device_name(0))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
