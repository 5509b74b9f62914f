"""Profiling hooks: structured spans + torch.profiler traces.

Parity target: the JAX package's ``utils/tracing.py`` (``jax.profiler``
there):
- ``trace_dir()``: captures a ``torch.profiler`` trace (CPU and, where
  there is a card, CUDA activity) of a code region into
  ``$FESR_TRACE_DIR/<name>/trace.json`` (Chrome trace format) when
  FESR_TRACE_DIR is set, and does nothing otherwise;
- ``annotate``: a named region in the trace timeline;
- ``span``: re-exported wall-clock spans (utils.logging).
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import torch

from .logging import span  # noqa: F401  (re-export)


@contextmanager
def trace_dir(name: str = "trace"):
    """Captures a profiler trace into $FESR_TRACE_DIR/<name> when set."""
    base = os.environ.get("FESR_TRACE_DIR")
    if not base:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(base, name)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


def annotate(name: str):
    """Named region in the trace timeline (``record_function``)."""
    return torch.profiler.record_function(name)
