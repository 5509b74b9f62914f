"""Timing spans.

Prints the same ``"Prediction time:"``/``"Reconstruction time:"`` lines as the
reference's harness (run_ALDS_3D.py:19-29).
"""

from __future__ import annotations

import time
from contextlib import contextmanager


@contextmanager
def span(name: str, sink: list | None = None):
    """Timing span printing '<name> time: <seconds>' (run_ALDS_3D.py:23, 29)."""
    t0 = time.time()
    yield
    dt = time.time() - t0
    print(f"{name} time: {dt}")
    if sink is not None:
        sink.append((name, dt))
