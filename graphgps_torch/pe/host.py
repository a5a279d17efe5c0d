"""Host-side (numpy) structural encodings: RWSE only.

Counterpart of ``graphgps_tpu/pe/host.py`` (``adjacency`` :22, ``rwse`` :92,
``compute_posenc`` :229): random-walk landing probabilities, the diagonals of
``P^k`` with ``P = D^-1 A``, computed once per graph at load time.
"""
from __future__ import annotations

from typing import List

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
        if name != "RWSE":
            raise NotImplementedError(
                f"posenc_{name} is not ported (ROADMAP Queue 1 item 16)")
        pcfg = cfg.posenc_RWSE
        times = pcfg.kernel.times or parse_times_func(pcfg.kernel.times_func)
        for g in graphs:
            g.pe["pestat_RWSE"] = rwse(g, times)
