"""Host-side (numpy) structural encodings: RWSE and LapPE.

Counterpart of ``graphgps_tpu/pe/host.py`` (``adjacency`` :22, ``laplacian``
:33, ``eigvec_normalizer`` :45, ``lap_eig`` :71, ``rwse`` :92,
``compute_posenc`` :229): random-walk landing probabilities (the diagonals of
``P^k`` with ``P = D^-1 A``) and the smallest Laplacian eigenpairs, computed
once per graph at load time.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..config import enabled_posenc, parse_times_func
from ..data.graph import Graph


def adjacency(g: Graph, undirected: bool = True) -> np.ndarray:
    n = g.num_nodes
    A = np.zeros((n, n), dtype=np.float64)
    s, r = g.edge_index
    A[s, r] = 1.0
    if undirected:
        A[r, s] = 1.0
    np.fill_diagonal(A, 0.0)
    return A


def laplacian(A: np.ndarray, norm: Optional[str] = "sym") -> np.ndarray:
    """``D - A`` (``norm`` None or "none") or ``I - D^-1/2 A D^-1/2``."""
    deg = A.sum(axis=1)
    if norm in (None, "none"):
        return np.diag(deg) - A
    with np.errstate(divide="ignore"):
        dinv_sqrt = np.where(deg > 0, deg ** -0.5, 0.0)
    return np.eye(A.shape[0]) - dinv_sqrt[:, None] * A * dinv_sqrt[None, :]


def eigvec_normalizer(evects: np.ndarray, evals: np.ndarray,
                      normalization: str = "L2",
                      eps: float = 1e-12) -> np.ndarray:
    """Eigenvectors normalized column by column."""
    if normalization == "L1":
        denom = np.abs(evects).sum(axis=0, keepdims=True)
    elif normalization == "L2":
        denom = np.linalg.norm(evects, axis=0, keepdims=True)
    elif normalization == "abs-max":
        denom = np.abs(evects).max(axis=0, keepdims=True)
    elif normalization == "wavelength":
        denom = np.abs(evects).max(axis=0, keepdims=True)
        wavelength = 2 * np.pi / np.sqrt(np.clip(evals, 0, None) + eps)
        return (evects / np.maximum(denom, eps) * wavelength[None, :]
                / (2 * np.pi))
    elif normalization == "wavelength-asin":
        denom = np.abs(evects).max(axis=0, keepdims=True)
        evals_c = np.clip(evals, 0, 4.0)
        wavelength = 2 * np.pi / (np.arcsin(np.sqrt(evals_c) / 2.0) + eps)
        return (evects / np.maximum(denom, eps) * wavelength[None, :]
                / (2 * np.pi))
    elif normalization in ("none", None):
        return evects
    else:
        raise ValueError(f"unknown eigvec normalization {normalization}")
    return evects / np.maximum(denom, eps)


def lap_eig(g: Graph, max_freqs: int, laplacian_norm: str = "sym",
            eigvec_norm: str = "L2") -> Tuple[np.ndarray, np.ndarray]:
    """The ``max_freqs`` smallest Laplacian eigenpairs as float32 (eigvals
    (max_freqs,), eigvecs (N, max_freqs)), NaN-padded when N < max_freqs."""
    n = g.num_nodes
    L = laplacian(adjacency(g),
                  None if laplacian_norm == "none" else laplacian_norm)
    evals, evects = np.linalg.eigh(L)
    k = min(n, max_freqs)
    idx = np.argsort(evals)[:k]
    evals_k, evects_k = evals[idx], evects[:, idx]
    evects_k = eigvec_normalizer(evects_k, evals_k, eigvec_norm)
    out_vals = np.full((max_freqs,), np.nan, dtype=np.float32)
    out_vecs = np.full((n, max_freqs), np.nan, dtype=np.float32)
    out_vals[:k] = evals_k
    out_vecs[:, :k] = evects_k
    return out_vals, out_vecs


def rwse(g: Graph, times: List[int]) -> np.ndarray:
    """(N, len(times)) float32 diagonals of ``P^k`` for k in ``times``,
    reusing the running power when consecutive k follow each other."""
    n = g.num_nodes
    A = adjacency(g)
    deg = A.sum(axis=1)
    with np.errstate(divide="ignore"):
        dinv = np.where(deg > 0, 1.0 / deg, 0.0)
    P = dinv[:, None] * A
    out = np.zeros((n, len(times)), dtype=np.float32)
    if not times:
        return out
    Pk = np.linalg.matrix_power(P, times[0])
    out[:, 0] = np.diag(Pk)
    for i, (k_prev, k) in enumerate(zip(times[:-1], times[1:]), start=1):
        if k == k_prev + 1:
            Pk = Pk @ P
        else:
            Pk = np.linalg.matrix_power(P, k)
        out[:, i] = np.diag(Pk)
    return out


def compute_posenc(graphs: List[Graph], cfg) -> None:
    """Attach every enabled encoding to ``g.pe`` in place."""
    for name in enabled_posenc(cfg):
        pcfg = cfg[f"posenc_{name}"]
        if name == "RWSE":
            times = (pcfg.kernel.times
                     or parse_times_func(pcfg.kernel.times_func))
            for g in graphs:
                g.pe["pestat_RWSE"] = rwse(g, times)
        elif name == "LapPE":
            for g in graphs:
                evals, evects = lap_eig(g, pcfg.eigen.max_freqs,
                                        pcfg.eigen.laplacian_norm,
                                        pcfg.eigen.eigvec_norm)
                g.pe["EigVecs"] = evects
                g.extras["EigVals"] = evals[None, :].copy()
        else:
            raise NotImplementedError(
                f"posenc_{name} is not ported (ROADMAP Queue 1 item 16)")
