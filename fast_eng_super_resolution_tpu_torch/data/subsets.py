"""Index-subset dataset views.

Parity targets: SubGraphDataset (reference dataset/GraphDataset.py:
1487-1494) and Sub_JHTDB (reference dataset/MatDataset.py:21-39), "take
these indices of an already-processed dataset" — also what the scheduler's
``train_meshes`` restriction needs.
"""

from __future__ import annotations

import os
import warnings

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


class SubJHTDB:
    """Sub_JHTDB equivalent (MatDataset.py:21-39): subset of a processed
    array-record file.  Verifies the processed file exists, like the
    reference's 'JHTDB data is not processed yet' guard (:28-29).

    The record file is ``processed/jhtdb_data.npz`` (NOT ``data.npz``, which
    is this package's processed-marker metadata file — reading that would
    silently serve metadata as samples).  Keys are sorted NUMERICALLY when
    they follow np.savez's ``arr_<i>`` convention: a lexicographic sort maps
    index 2 to sample 10 once there are 11+ entries."""

    _FILENAME = "jhtdb_data.npz"

    def __init__(self, root: str, indices):
        self.root = root
        path = os.path.join(root, "processed", self._FILENAME)
        if not os.path.exists(path):
            # legacy record name (pre-rename): accept with a warning so
            # out-of-repo-processed caches aren't stranded
            legacy = os.path.join(root, "processed", "data.npz")
            if os.path.exists(legacy):
                warnings.warn(
                    f"{legacy}: legacy JHTDB record name — rename to "
                    f"{self._FILENAME} (data.npz is also this package's "
                    "processed-marker filename)")
                path = legacy
            else:
                raise ValueError("JHTDB data is not processed yet")

        def key(k: str):
            tail = k.rsplit("_", 1)[-1]
            return (0, int(tail)) if tail.isdigit() else (1, k)

        with np.load(path, allow_pickle=True) as z:
            data = [z[k] for k in sorted(z.files, key=key)]
        self.data = [data[i] for i in indices]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return self.data[idx]
