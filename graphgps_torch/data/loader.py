"""Batch assembly on the device: upload a split's arenas once, then send
only the (B,) graph indices per step.

Counterparts: ``graphgps_tpu/data/batching.py`` (``round_up`` :20,
``choose_caps`` :47) and ``graphgps_tpu/data/device_loader.py``
(``DeviceArenas`` :62, ``assemble_impl`` :162, ``DeviceLoader`` :234). The
layout is the same, array for array:

- node rows: ``arena[node_off[sel] + j]`` for ``j < max_nodes``, masked;
- edges: per-graph blocks of ``Ecap`` slots holding graph-local endpoints
  plus the graph's slot base, sorted by receiver at pack time; a padded edge
  points at the last real node of its own graph;
- a partial last batch is padded with graph index −1, which reads the last
  graph's arrays (as numpy/JAX negative indexing does) under
  ``graph_mask`` False, with NaN targets and zeroed features; integer class
  labels stay integers (int32), and a padded graph then keeps the label it
  read, as in the JAX loader (``device_loader.py`` :206-209);
- features keep their kind: integer codes as int32, float features as
  float32; on a node task the labels are a node arena gathered like the
  features, 0 on padded slots (``device_loader.py`` :130-138, :210-215);
- ``extras`` (per-graph arrays such as LapPE's ``EigVals``) are stacked per
  graph and gathered by graph index (:140-152, :217-222). Node-sized extras
  (the Graphormer ``spatial_types`` (N, N) and ``shortest_path_types``
  (N, N, D), ``batching.py`` :24-45, and a transductive split's
  ``split_mask`` (N,)) are zero-padded to the node cap on their node axes
  and zero for a padded graph, as the host ``collate`` gives them
  (:120-131); they keep their host dtype (the path types uint8, the split
  mask bool);
- ``pe`` columns keep their kind too: the Graphormer degrees stay integers.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from .graph import Graph, GraphBatch


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def choose_caps(graphs: Sequence[Graph], node_multiple: int = 8,
                edge_multiple: int = 32) -> tuple:
    """Static (max_nodes, max_edges-per-graph) caps for a dataset: the
    dataset maxima rounded up, large node caps to a multiple of 128."""
    max_n = max((g.num_nodes for g in graphs), default=1)
    max_e = max((g.num_edges for g in graphs), default=1)
    n_cap = round_up(max(max_n, 1), node_multiple)
    if n_cap >= 256:
        n_cap = round_up(n_cap, 128)
    return n_cap, round_up(max(max_e, 1), edge_multiple)


# node-sized extras: which axes pad to the node cap (``batching.py`` :33)
NODE_SIZED_AXES = {"spatial_types": (0, 1), "shortest_path_types": (0, 1),
                   "split_mask": (0,)}


def _stack_extras(key: str, arrays, node_cap: int) -> np.ndarray:
    """One extras entry of every graph stacked on a new axis 0; a
    node-sized one zero-padded to ``node_cap`` on its node axes first."""
    axes = NODE_SIZED_AXES.get(key)
    if axes is None:
        return np.stack(arrays)
    a0 = arrays[0]
    shape = [node_cap if i in axes else n for i, n in enumerate(a0.shape)]
    out = np.zeros((len(arrays), *shape), a0.dtype)
    for i, a in enumerate(arrays):
        out[(i, *(slice(0, n) for n in a.shape))] = a
    return out


def _arena_dtype(a: np.ndarray):
    """int32 for integer codes and labels, float32 for float features."""
    return np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32


class DeviceArenas:
    """One split's graphs packed into device-resident arrays, with each
    graph's edges in a block of ``edge_cap`` slots."""

    def __init__(self, graphs: Sequence[Graph], device, node_cap: int,
                 edge_cap: Optional[int] = None, y_graph_level: bool = True):
        """``node_cap``: the node slots per graph, which node-sized extras
        pad to."""
        G = len(graphs)
        g0 = graphs[0]
        max_e = max((g.num_edges for g in graphs), default=1)
        self.edge_cap = edge_cap or round_up(max(max_e, 1), 8)
        if self.edge_cap < max_e:
            raise ValueError(f"edge_cap {self.edge_cap} < max graph edges {max_e}")
        Ecap = self.edge_cap

        node_off = np.zeros(G + 1, np.int64)
        for i, g in enumerate(graphs):
            node_off[i + 1] = node_off[i] + g.num_nodes
        senders = np.zeros((G, Ecap), np.int32)
        receivers = np.zeros((G, Ecap), np.int32)
        e_count = np.zeros((G,), np.int64)
        edge_feat = None
        if g0.edge_feat is not None:
            edge_feat = np.zeros((G, Ecap, *g0.edge_feat.shape[1:]),
                                 _arena_dtype(g0.edge_feat))
        for i, g in enumerate(graphs):
            e = g.num_edges
            order = np.argsort(g.edge_index[1], kind="stable")
            senders[i, :e] = g.edge_index[0][order]
            receivers[i, :e] = g.edge_index[1][order]
            # padding edges sit on the graph's last node: sortedness holds
            pad = g.num_nodes - 1 if g.num_nodes else 0
            senders[i, e:] = pad
            receivers[i, e:] = pad
            e_count[i] = e
            if edge_feat is not None:
                edge_feat[i, :e] = g.edge_feat[order]

        def dev(a):
            return torch.as_tensor(a, device=device)

        self.num_graphs_total = G
        self.node_off = dev(node_off)
        self.n_count = dev(node_off[1:] - node_off[:-1])
        self.e_count = dev(e_count)
        self.node_feat = dev(np.concatenate(
            [g.node_feat for g in graphs], axis=0).astype(
                _arena_dtype(g0.node_feat)))
        self.senders = dev(senders)
        self.receivers = dev(receivers)
        self.edge_feat = dev(edge_feat) if edge_feat is not None else None
        self.pe = {k: dev(np.concatenate([g.pe[k] for g in graphs], axis=0)
                          .astype(_arena_dtype(g0.pe[k]))) for k in g0.pe}
        self.y = self.y_node = None
        if g0.y is not None and y_graph_level:
            y = np.stack([np.atleast_1d(np.asarray(g.y)) for g in graphs])
            self.y = dev(y.astype(_arena_dtype(y)))
        elif g0.y is not None:
            y = np.concatenate([np.asarray(g.y).reshape(g.num_nodes, -1)
                                for g in graphs], axis=0)
            self.y_node = dev(y.astype(_arena_dtype(y)))
        self.extras = {k: dev(_stack_extras(k, [g.extras[k] for g in graphs],
                                            node_cap))
                       for k in g0.extras}

    def assemble(self, sel: torch.Tensor, max_nodes: int) -> GraphBatch:
        """(B,) int64 graph indices on the device (−1 = padding) → batch."""
        B, Nmax, Ecap = sel.shape[0], max_nodes, self.edge_cap
        dev = sel.device
        off = self.node_off[sel]
        ncnt = self.n_count[sel]
        ecnt = self.e_count[sel]
        gmask = sel >= 0

        j = torch.arange(Nmax, device=dev)[None, :]
        node_idx = off[:, None] + torch.minimum(
            j, torch.clamp(ncnt[:, None] - 1, min=0))
        # a padded graph starts past the arena end: clamp, it is masked
        node_idx = node_idx.clamp(max=self.node_feat.shape[0] - 1).reshape(-1)
        node_mask = ((j < ncnt[:, None]) & gmask[:, None]).reshape(-1)
        nf = torch.where(node_mask[:, None], self.node_feat[node_idx], 0)

        k = torch.arange(Ecap, device=dev)[None, :]
        emask = ((k < ecnt[:, None]) & gmask[:, None]).reshape(-1)
        base = (torch.arange(B, device=dev, dtype=torch.int32) * Nmax)[:, None]
        snd = (self.senders[sel] + base).reshape(-1)
        rcv = (self.receivers[sel] + base).reshape(-1)
        ef = None
        if self.edge_feat is not None:
            ef = self.edge_feat[sel].reshape(B * Ecap, -1)
            ef = torch.where(emask[:, None], ef, 0)
        pe = {key: torch.where(node_mask[:, None], arena[node_idx], 0)
              for key, arena in self.pe.items()}
        y = None
        if self.y is not None:
            y = self.y[sel]
            if y.is_floating_point():
                y = torch.where(gmask[:, None], y, float("nan"))
        elif self.y_node is not None:
            y = torch.where(node_mask[:, None], self.y_node[node_idx], 0)
            if y.shape[-1] == 1:
                y = y[:, 0]
        return GraphBatch(
            node_feat=nf, edge_feat=ef, senders=snd, receivers=rcv,
            node_mask=node_mask, edge_mask=emask, graph_mask=gmask, y=y,
            pe=pe, num_graphs=B, max_nodes=Nmax, edge_block=Ecap,
            extras={k: self._extra(k, v, sel, gmask)
                    for k, v in self.extras.items()})

    @staticmethod
    def _extra(key: str, arena, sel, gmask):
        v = arena[sel]
        if key in NODE_SIZED_AXES:
            v = torch.where(gmask.reshape(-1, *[1] * (v.ndim - 1)), v,
                            torch.zeros((), dtype=v.dtype, device=v.device))
        return v


class DeviceLoader:
    """Epoch iterator yielding ``(real_graphs, GraphBatch)`` assembled on
    ``device``; only the index vector crosses from the host per step."""

    def __init__(self, graphs: Sequence[Graph], batch_size: int, device,
                 max_nodes: Optional[int] = None,
                 max_edges: Optional[int] = None, shuffle: bool = False,
                 seed: int = 0, y_graph_level: bool = True):
        edge_cap = (-(-max_edges // batch_size)) if max_edges else None
        if max_nodes:
            self.max_nodes = max_nodes
        else:
            self.max_nodes = round_up(max(g.num_nodes for g in graphs), 8)
            if self.max_nodes >= 256:
                self.max_nodes = round_up(self.max_nodes, 128)
        self.arenas = DeviceArenas(graphs, device, self.max_nodes,
                                   edge_cap=edge_cap,
                                   y_graph_level=y_graph_level)
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return -(-self.arenas.num_graphs_total // self.batch_size)

    def __iter__(self) -> Iterator:
        n = self.arenas.num_graphs_total
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        self.epoch += 1
        B = self.batch_size
        for s in range(0, n, B):
            chunk = idx[s:s + B]
            real = len(chunk)
            if real < B:
                chunk = np.concatenate([chunk, -np.ones(B - real, np.int64)])
            sel = torch.as_tensor(chunk, dtype=torch.int64, device=self.device)
            yield real, self.arenas.assemble(sel, self.max_nodes)
