"""Index-subset dataset views.

Parity target: SubGraphDataset (reference dataset/GraphDataset.py:1487-1494),
"take these indices of an already-processed dataset" — also what the
scheduler's ``train_meshes`` restriction needs.  The grid family's
``SubJHTDB`` comes with the rest of that family (ROADMAP.md queue A item
14 (ii)).
"""

from __future__ import annotations

import numpy as np


class Subset:
    """View over any indexable dataset (the torch.utils.data.Subset role)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices, np.int64)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]

    def get(self, i):
        return self.dataset.get(int(self.indices[i]))


class SubGraphDataset(Subset):
    """SubGraphDataset equivalent: subset of a processed graph dataset by
    indices (GraphDataset.py:1487-1494)."""
