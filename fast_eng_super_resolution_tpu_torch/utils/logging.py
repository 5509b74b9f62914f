"""Structured metrics logging + timing spans.

The reference logs scalars to wandb (project 'domain_partition_scheduler',
scheduler_gnn.py:124, 164, 179, 422-423) and times spans with bare prints
(run_ALDS_3D.py:19-29).  Here: a MetricLogger that always writes JSONL under
``logs/metrics`` and mirrors to wandb when it imports and is configured;
timing spans that print the same "Prediction time:"/"Reconstruction time:"
lines as the reference's harness.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager


class MetricLogger:
    def __init__(self, exp_name: str, log_dir: str = "logs",
                 use_wandb: bool | None = None, config: dict | None = None):
        self.exp_name = exp_name
        self.path = os.path.join(log_dir, "metrics", f"{exp_name}.jsonl")
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._f = open(self.path, "a")
        self.step = 0
        self._wandb = None
        if use_wandb is None:
            use_wandb = bool(os.environ.get("WANDB_API_KEY"))
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project="domain_partition_scheduler",
                           group="partition_training", config=config or {})
            except Exception:
                self._wandb = None

    def log(self, metrics: dict, step: int | None = None):
        rec = {"ts": time.time(), "step": self.step if step is None else step,
               **{k: float(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        self.step = rec["step"] + 1
        if self._wandb is not None:
            # explicit step: wandb's auto-increment counts calls, which
            # diverges from the epoch when val logs less often than train
            self._wandb.log(metrics, step=int(rec["step"]))

    def finish(self):
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()


@contextmanager
def span(name: str, sink: list | None = None):
    """Timing span printing '<name> time: <seconds>' (run_ALDS_3D.py:23, 29)."""
    t0 = time.time()
    yield
    dt = time.time() - t0
    print(f"{name} time: {dt}")
    if sink is not None:
        sink.append((name, dt))
