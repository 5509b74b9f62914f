"""Least-squares nodal gradients, divergence and graph Laplacian, in torch.

Port of the JAX package's ``physics/divergence.py`` (which replaces the
reference's numba kernels, reference dataset/GraphDataset.py:1509-1746).
Every operator works on the device of its tensors, over fixed-K neighbour
arrays ``nbr`` [N, K] (int) and ``mask`` [N, K] (bool) from
``build_node_neighbors``:

- ``compute_weights`` (:1509-1591): per-node pseudo-inverse of the normalized
  neighbour-direction matrix through the 3x3 normal equations' ``eigh``,
  with the reference's fallbacks (cond >= 1e8, weight norm > 100, fewer than
  3 neighbours -> 1/k-scaled directions; one neighbour -> its direction).
- ``compute_gradient_weights``: the true-gradient operator (pseudo-inverse
  of the raw displacements), exact on linear fields.
- ``compute_divergence`` (:1594-1608) sums all nine entries of W_i @ dV_i,
  as the reference does; ``compute_divergence_trace`` is the true trace.
- ``make_laplacian_matvec`` (:1679-1746) and ``make_consistent_matvec``,
  the composite A = D o G the projection solves, with its adjoint
  ``make_consistent_rmatvec``.
- ``apply_pressure_correction`` (:1664-1676, with the relaxation factor).

Sums run as elementwise products reduced by ``sum``, never as a matmul, so
no TF32 setting changes them.  No operator here scatters: the adjoint of the
gather ``p[nbr]`` is a gather over the transposed neighbour table
(``build_transposed_neighbors``), so no float atomics run and a result has
the same bits on every run.
"""

from __future__ import annotations

import numpy as np
import torch


def build_node_neighbors(edges: np.ndarray, num_nodes: int,
                         max_neighbors: int | None = None):
    """[N, K] neighbour ids + mask from a directed edge list (host numpy).

    Neighbours of i = all j with an edge (i -> j); the reference builds the
    same symmetric adjacency from cell cliques (GraphDataset.py:1767-1796).
    """
    order = np.argsort(edges[:, 0], kind="stable")
    src, dst = edges[order, 0], edges[order, 1]
    counts = np.bincount(src, minlength=num_nodes)
    k = int(max_neighbors or counts.max())
    nbr = np.zeros((num_nodes, k), np.int32)
    mask = np.zeros((num_nodes, k), bool)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    col = np.arange(len(src)) - starts[src]
    keep = col < k
    nbr[src[keep], col[keep]] = dst[keep]
    mask[src[keep], col[keep]] = True
    return nbr, mask


def build_transposed_neighbors(nbr: np.ndarray, mask: np.ndarray):
    """The transposed neighbour table (host numpy): for each node j, the flat
    slots s = i * K + k with ``nbr[i, k] == j`` and ``mask[i, k]``, in
    ascending order, padded to the largest count with slot 0.

    Returns (slots [N, KT] int64, valid [N, KT] bool).  With it the adjoint
    of a gather over ``nbr`` is a gather too (``make_consistent_rmatvec``).
    """
    nbr, mask = np.asarray(nbr), np.asarray(mask, bool)
    n, k = nbr.shape
    flat = np.flatnonzero(mask.reshape(-1))            # ascending slots
    dst = nbr.reshape(-1)[flat].astype(np.int64)
    order = np.argsort(dst, kind="stable")
    flat, dst = flat[order], dst[order]
    counts = np.bincount(dst, minlength=n)
    kt = max(int(counts.max()) if n else 0, 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    col = np.arange(len(dst)) - starts[dst]
    slots = np.zeros((n, kt), np.int64)
    valid = np.zeros((n, kt), bool)
    slots[dst, col] = flat
    valid[dst, col] = True
    return slots, valid


# cuSOLVER's batched eigh refuses large batches of 3x3 matrices
# (CUSOLVER_STATUS_INVALID_VALUE on the H100 with CUDA 12.8 at 32 768 and
# 97 556 matrices; 27 648 run), so the nodes go through it in chunks; each
# matrix's result does not depend on its batch
EIGH_CHUNK = 16384


def _eigh(g: torch.Tensor):
    """Batched ``torch.linalg.eigh`` of [N, 3, 3] in chunks of EIGH_CHUNK."""
    parts = [torch.linalg.eigh(c) for c in torch.split(g, EIGH_CHUNK)]
    return (torch.cat([a for a, _ in parts]), torch.cat([b for _, b in parts]))


def _pinv_from_eigh(s2: torch.Tensor, vec: torch.Tensor,
                    keep: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """V diag(1/s^2 where keep) V^T rows^T: the pseudo-inverse applied to
    ``rows`` [N, K, 3] -> [N, 3, K]."""
    s_inv2 = torch.where(keep, 1.0 / s2.clamp_min(1e-30), 0.0)
    ginv = (vec[:, :, None, :] * s_inv2[:, None, None, :]
            * vec[:, None, :, :]).sum(-1)                    # [N, 3, 3]
    return (ginv[:, :, None, :] * rows[:, None, :, :]).sum(-1)


def compute_weights(points: torch.Tensor, nbr: torch.Tensor,
                    mask: torch.Tensor, return_simple: bool = False):
    """Per-node LSQ gradient weights [N, 3, K] (GraphDataset.py:1509-1591).

    The pseudo-inverse comes from the float32 normal equations (``eigh`` of
    A^T A), as in the JAX package; ``eigh`` may return another eigenvector
    basis inside a repeated eigenvalue, and V S^-2 V^T does not depend on
    that choice.  At near-degenerate nodes the f32 thresholds (cond >= 1e8,
    weight norm > 100) can flip against the reference's float64 SVD (the JAX
    package's drift note).  ``return_simple=True`` also returns the [N] bool
    of nodes that took the 1/k-scaled fallback.
    """
    v = points[nbr] - points[:, None, :]                      # [N, K, 3]
    norm = torch.linalg.vector_norm(v, dim=2, keepdim=True)
    a = torch.where((norm > 1e-10) & mask[..., None],
                    v / norm.clamp_min(1e-30), 0.0)
    n_neighbors = mask.sum(1)

    g = (a[:, :, :, None] * a[:, :, None, :]).sum(1)          # [N, 3, 3]
    s2, vec = _eigh(g)                            # ascending
    s = s2.clamp_min(0.0).sqrt()                              # singular values
    max_s = s[:, -1]
    min_s = torch.where(s[:, 0] > 0, s[:, 0],
                        torch.where(s[:, 1] > 0, s[:, 1], 1e-10))
    cond = max_s / min_s.clamp_min(1e-30)
    pinv = _pinv_from_eigh(s2, vec, s > (max_s * 1e-6)[:, None], a)

    w_norm = (pinv ** 2 * mask[:, None, :]).sum((1, 2))
    simple = (a / n_neighbors.clamp_min(1)[:, None, None]).transpose(1, 2)
    use_simple = (cond >= 1e8) | (w_norm > 100.0) | (n_neighbors < 3)
    weights = torch.where(use_simple[:, None, None], simple, pinv)
    # single neighbour: unit direction (GraphDataset.py:1524-1531)
    weights = torch.where((n_neighbors == 1)[:, None, None],
                          a.transpose(1, 2), weights)
    weights = weights * mask[:, None, :]
    return (weights, use_simple) if return_simple else weights


def compute_gradient_weights(points: torch.Tensor, nbr: torch.Tensor,
                             mask: torch.Tensor) -> torch.Tensor:
    """True-gradient LSQ weights [N, 3, K]: the pseudo-inverse of the raw
    displacements, so that W_i @ (u_nbr - u_i) == grad u for a linear u
    (the operator vtkGradientFilter gives the reference's WSS pass,
    compute_wss.py:36-42).  ``compute_weights`` instead normalizes the
    direction rows without dividing the differences by the distance."""
    d = (points[nbr] - points[:, None, :]) * mask[..., None]   # [N, K, 3]
    g = (d[:, :, :, None] * d[:, :, None, :]).sum(1)
    s2, vec = _eigh(g)
    thresh = (s2[:, -1].clamp_min(1e-30) * 1e-10)[:, None]
    return _pinv_from_eigh(s2, vec, s2 > thresh, d) * mask[:, None, :]


def _differences(field: torch.Tensor, nbr: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """(field[nbr] - field_i) * mask: [N, K] or [N, K, C]."""
    m = mask if field.dim() == 1 else mask[..., None]
    return (field[nbr] - field[:, None]) * m


def compute_divergence(velocity: torch.Tensor, nbr: torch.Tensor,
                       mask: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Sum of all entries of W_i @ (v_nbr - v_i) (GraphDataset.py:1594-1608)."""
    dv = _differences(velocity, nbr, mask)                      # [N, K, 3]
    return (weights[:, :, :, None] * dv[:, None, :, :]).sum((1, 2, 3))


def compute_divergence_trace(velocity: torch.Tensor, nbr: torch.Tensor,
                             mask: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    """True divergence: trace of the LSQ Jacobian, sum_d du_d/dx_d (the
    JAX package's intended operator; the reference's nine-entry sum makes
    the projection system indefinite)."""
    dv = _differences(velocity, nbr, mask)
    return (weights * dv.transpose(1, 2)).sum((1, 2))


def laplacian_weights(weights: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Row-normalized per-neighbour scalar weights (GraphDataset.py:1700-1743)."""
    w = torch.linalg.vector_norm(weights, dim=1) * mask          # [N, K]
    total = w.sum(1, keepdim=True)
    return torch.where(total > 1e-10, w / total.clamp_min(1e-30), 0.0)


def make_laplacian_matvec(nbr: torch.Tensor, mask: torch.Tensor,
                          lw: torch.Tensor):
    """L p with L[i,i] = sum_k w[i,k], L[i,j_k] = -w[i,k] (isolated rows ->
    identity).  Returns (matvec, diagonal)."""
    diag = lw.sum(1)
    isolated = diag <= 1e-10

    def matvec(p):
        off = (lw * p[nbr]).sum(1)
        return torch.where(isolated, p, diag * p - off)

    return matvec, torch.where(isolated, 1.0, diag)


def make_consistent_matvec(nbr: torch.Tensor, mask: torch.Tensor,
                           weights: torch.Tensor, trace: bool = True):
    """The composite operator A: p -> div(grad_correction(p)).

    (G p)_{i,d} = sum_k W[i,d,k] (p_{nbr[i,k]} - p_i), and A applies to
    G p the same divergence the outer loop measures: the trace (default,
    A = sum_d G_d G_d) or the reference's nine-entry sum (``trace=False``,
    A = S S with S = sum_d G_d).  Returns (matvec, grad_field).
    """

    def grad_field(p):
        dp = _differences(p, nbr, mask)                           # [N, K]
        return (weights * dp[:, None, :]).sum(2)                  # [N, 3]

    def matvec(p):
        dg = _differences(grad_field(p), nbr, mask)               # [N, K, 3]
        if trace:
            return (weights * dg.transpose(1, 2)).sum((1, 2))
        return (weights[:, :, :, None] * dg[:, None, :, :]).sum((1, 2, 3))

    return matvec, grad_field


def make_consistent_rmatvec(nbr: torch.Tensor, mask: torch.Tensor,
                            weights: torch.Tensor, table, trace: bool = True):
    """A^T of ``make_consistent_matvec``'s A, as gathers.

    (G_d^T y)_j = sum over the slots (i, k) with nbr[i, k] = j of
    W[i,d,k] y_i, minus (sum_k W[j,d,k]) y_j; ``table`` is
    ``build_transposed_neighbors``'s (slots, valid) as tensors on the
    weights' device.  A^T = sum_d G_d^T G_d^T (trace) or S^T S^T.
    """
    slots, valid = table
    k = nbr.shape[1]
    src = slots // k                                              # [N, KT]
    wm = weights * mask[:, None, :]
    wt = torch.where(valid[..., None],
                     wm.transpose(1, 2).reshape(-1, 3)[slots], 0.0)  # [N, KT, 3]
    rowsum = wm.sum(2)                                            # [N, 3]
    if not trace:
        wt, rowsum = wt.sum(2), rowsum.sum(1)

        def rmatvec(y):
            s = (wt * y[src]).sum(1) - rowsum * y
            return (wt * s[src]).sum(1) - rowsum * s

        return rmatvec

    def rmatvec(y):
        h = (wt * y[src][..., None]).sum(1) - rowsum * y[:, None]   # [N, 3]
        return (wt * h[src]).sum((1, 2)) - (rowsum * h).sum(1)

    return rmatvec


def apply_pressure_correction(velocity: torch.Tensor, pressure: torch.Tensor,
                              nbr: torch.Tensor, mask: torch.Tensor,
                              weights: torch.Tensor,
                              alpha: torch.Tensor | float = 1.0) -> torch.Tensor:
    """v_i -= alpha * W_i @ (p_nbr - p_i) (GraphDataset.py:1664-1676, :1965)."""
    dp = _differences(pressure, nbr, mask)
    return velocity - alpha * (weights * dp[:, None, :]).sum(2)
