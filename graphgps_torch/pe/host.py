"""Host-side (numpy) structural encodings: RWSE, LapPE and the Graphormer
bias statistics.

Counterpart of ``graphgps_tpu/pe/host.py`` (``adjacency`` :22, ``laplacian``
:33, ``eigvec_normalizer`` :45, ``lap_eig`` :71, ``rwse`` :92,
``graphormer_bias`` :151, ``compute_posenc`` :229): random-walk landing
probabilities (the diagonals of ``P^k`` with ``P = D^-1 A``), the smallest
Laplacian eigenpairs, and all-pairs shortest-path types with the edge types
along each path, computed once per graph at load time.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

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


# the eigenpairs of the last LAP_EIG_KEEP distinct graphs, by content
LAP_EIG_KEEP = 8
_LAP_EIG: "OrderedDict[tuple, Tuple[np.ndarray, np.ndarray]]" = OrderedDict()


def lap_eig_memo(g: Graph, max_freqs: int, laplacian_norm: str = "sym",
                 eigvec_norm: str = "L2") -> Tuple[np.ndarray, np.ndarray]:
    """:func:`lap_eig`, computed once for a graph's node count and edge list
    while it is among the last LAP_EIG_KEEP distinct graphs: the split views
    of a transductive graph share both, a run loads its dataset more than
    once, and a dense ``eigh`` of a 5,201-node Laplacian takes tens of
    seconds. A repeat returns the arrays the one numpy call gave (a pure
    function of the key: nothing can go stale; callers copy, never write)."""
    key = (g.num_nodes, hashlib.sha1(
        np.ascontiguousarray(g.edge_index).tobytes()).hexdigest(),
        max_freqs, laplacian_norm, eigvec_norm)
    if key not in _LAP_EIG:
        _LAP_EIG[key] = lap_eig(g, max_freqs, laplacian_norm, eigvec_norm)
        while len(_LAP_EIG) > LAP_EIG_KEEP:
            _LAP_EIG.popitem(last=False)
    return _LAP_EIG[key]


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


def _bfs_all_sources(n: int, s: np.ndarray, r: np.ndarray, directed: bool):
    """(dist (n, n) int64, -1 where unreachable; parent (n, n)): breadth-first
    search from every source at once, picking the parent that the JAX
    package's per-source loop picks (``pe/host.py:166-190``). That loop
    appends to adjacency lists in edge order (edge i: ``adj[s_i]`` gets r_i,
    then, undirected, ``adj[r_i]`` gets s_i), walks a level's frontier in the
    order its nodes were appended, and gives a node the first frontier node
    that reaches it. So a node of the next level takes the frontier node of
    lowest rank among its neighbours as parent, and the next frontier is
    ordered by (that parent's rank, the first place of the node in the
    parent's list)."""
    E = len(s)
    if directed:
        src, dst, order = s, r, np.arange(E)
    else:
        src, dst = np.concatenate([s, r]), np.concatenate([r, s])
        order = np.concatenate([2 * np.arange(E), 2 * np.arange(E) + 1])
    big = np.iinfo(np.int64).max // 4
    K = 2 * E + 1
    # first[u, v]: the append index of v's first entry in adj[u]
    first = np.full((n, n), big, np.int64)
    np.minimum.at(first, (src, dst), order)
    adj = first < big
    idx = np.arange(n)
    dist = np.full((n, n), -1, np.int64)
    parent = np.full((n, n), -1, np.int64)
    dist[idx, idx] = 0
    rank = np.full((n, n), big, np.int64)     # [source, node]: frontier rank
    rank[idx, idx] = 0
    d = 0
    while True:
        d += 1
        # key[source, u, v]: when the loop would append v from frontier u
        key = np.where(adj[None] & (rank < big)[:, :, None],
                       rank[:, :, None] * K + first[None], big)
        best = key.min(axis=1)
        new = (best < big) & (dist < 0)
        if not new.any():
            return dist, parent
        dist[new] = d
        parent[new] = key.argmin(axis=1)[new]
        srt = np.argsort(np.where(new, best, big), axis=1, kind="stable")
        rank = np.full((n, n), big, np.int64)
        np.put_along_axis(rank, srt, np.broadcast_to(idx, (n, n)), axis=1)
        rank[~new] = big


def graphormer_bias(g: Graph, num_spatial_types: int, directed: bool = False,
                    with_edge_paths: bool = False) -> Dict[str, np.ndarray]:
    """All-pairs shortest-path types and in/out degrees for the Graphormer
    bias encoder (``graphgps_tpu/pe/host.py:151-227``), the same integers:
    ``spatial_types`` (N, N) int32 (the distance clamped to
    ``num_spatial_types - 1``, ``num_spatial_types`` where unreachable),
    ``in_degrees`` and ``out_degrees`` (N,) int32 (both the total degree on
    an undirected graph) and, with ``with_edge_paths``,
    ``shortest_path_types`` (N, N, num_spatial_types): the scalar edge type
    of each hop along the BFS shortest path, truncated to its first
    ``num_spatial_types`` nodes, zeros past the path, on the diagonal and
    where unreachable. That one is uint8 (edge types up to 255; ZINC has 4):
    at int64 a batch of 256 molecules would carry 65 MB of it."""
    n = g.num_nodes
    s, r = (np.asarray(a, np.int64) for a in g.edge_index)
    dist, parent = _bfs_all_sources(n, s, r, directed)
    spatial = np.where(dist < 0, num_spatial_types,
                       np.minimum(dist, num_spatial_types - 1)).astype(np.int32)
    in_deg = np.bincount(r, minlength=n).astype(np.int32)
    out_deg = np.bincount(s, minlength=n).astype(np.int32)
    if not directed:
        in_deg = out_deg = in_deg + out_deg
    out = dict(spatial_types=spatial, in_degrees=in_deg, out_degrees=out_deg)
    if with_edge_paths and g.edge_feat is not None:
        etype = np.zeros((n, n), dtype=np.int64)
        ef = g.edge_feat.reshape(g.num_edges, -1)[:, 0]
        etype[s, r] = ef
        if not directed:
            etype[r, s] = ef
        if etype.min(initial=0) < 0 or etype.max(initial=0) > 255:
            raise ValueError("shortest_path_types holds edge types in uint8: "
                             f"got types {etype.min()}..{etype.max()}")
        D = num_spatial_types
        # the path's nodes, walked back from j through the parents
        reach = dist > 0
        steps = int(dist.max(initial=0))
        nodes = np.zeros((n, n, steps + 1), np.int64)
        cur = np.broadcast_to(np.arange(n)[None, :], (n, n)).copy()
        rows = np.broadcast_to(np.arange(n)[:, None], (n, n))
        for t in range(steps + 1):
            p = dist - t
            ok = reach & (p >= 0)
            nodes[ok, p[ok]] = cur[ok]
            cur = np.where(ok & (p > 0), parent[rows, cur], cur)
        spt = np.zeros((n, n, D), np.uint8)
        hops = np.minimum(dist, D - 1)
        for k in range(min(steps, D - 1)):
            ok = reach & (k < hops)
            spt[ok, k] = etype[nodes[ok, k], nodes[ok, k + 1]]
        out["shortest_path_types"] = spt
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
                evals, evects = lap_eig_memo(g, pcfg.eigen.max_freqs,
                                             pcfg.eigen.laplacian_norm,
                                             pcfg.eigen.eigvec_norm)
                g.pe["EigVecs"] = evects
                g.extras["EigVals"] = evals[None, :].copy()
        elif name == "GraphormerBias":
            edge_paths = bool(pcfg.get("has_edge_attr", False))
            for g in graphs:
                stats = graphormer_bias(
                    g, pcfg.num_spatial_types, pcfg.directed_graphs,
                    with_edge_paths=edge_paths and g.edge_feat is not None)
                g.extras["spatial_types"] = stats["spatial_types"]
                if "shortest_path_types" in stats:
                    g.extras["shortest_path_types"] = \
                        stats["shortest_path_types"]
                g.pe["in_degrees"] = stats["in_degrees"][:, None]
                g.pe["out_degrees"] = stats["out_degrees"][:, None]
        else:
            raise NotImplementedError(
                f"posenc_{name} is not ported (ROADMAP Queue 1 item 16)")
