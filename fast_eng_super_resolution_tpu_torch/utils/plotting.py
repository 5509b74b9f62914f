"""Prediction visualization — 3-panel 3D scatter (input / truth / prediction).

A copy of the JAX package's ``utils/plotting.py``; matplotlib is imported
only when a figure is drawn.  Parity target: plot_3d_prediction (reference
utils.py:126-166): same
panel layout, plasma colormap, colorbars, save modes ('wandb', 'plt', 'save'
pdf, 'save_png').  Takes plain arrays instead of a pyg Data object.
"""

from __future__ import annotations

import os

import numpy as np


def plot_3d_prediction(pos: np.ndarray, x: np.ndarray, y: np.ndarray,
                       pred: np.ndarray, save_mode: str = "save_png", **kwargs):
    import matplotlib

    if save_mode != "plt":
        # headless backend for the save/wandb modes only: forcing Agg
        # unconditionally would make save_mode='plt' (reference
        # utils.py:158-159 shows the figure) a silent no-op
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(20, 5))
    panels = [("Input", x), ("Ground truth", y), ("Prediction", pred)]
    for i, (title, field) in enumerate(panels):
        ax = fig.add_subplot(1, 3, i + 1, projection="3d")
        c = np.linalg.norm(field[:, :1], axis=1)
        sc = ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], c=c, cmap="plasma")
        ax.set_title(title)
        ax.axis("off")
        plt.colorbar(sc, ax=ax, orientation="vertical")

    if save_mode == "wandb":
        try:
            import wandb

            wandb.log({"prediction": wandb.Image(plt)})
        except Exception:
            pass
    elif save_mode == "plt":
        plt.show()
    elif save_mode in ("save", "save_png"):
        path = kwargs["path"]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        ext = "pdf" if save_mode == "save" else "png"
        plt.savefig(f"{path}.{ext}", format=ext, dpi=300)
    plt.close(fig)
    return fig
