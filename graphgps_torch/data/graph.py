"""Core graph containers (counterpart of ``graphgps_tpu/data/graph.py``).

One canonical padded layout is fixed when a batch is assembled:

- Nodes live in a flat tensor of ``num_graphs * max_nodes`` slots; graph ``g``
  owns the contiguous slot range ``[g*max_nodes, (g+1)*max_nodes)``. A view as
  ``(num_graphs, max_nodes, d)`` is the dense layout the attention reads.
- Edges are blocked per graph: edge slot ``j`` belongs to graph
  ``j // edge_block``, its endpoints lie inside that graph's node range, and a
  padded edge points at a node of its own graph with ``edge_mask`` False.
- Shapes are static per loader; masks decide what is real everywhere.

``Graph`` is the host-side (numpy) single-graph record produced by the dataset
loaders.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Graph:
    """Host-side single graph (numpy)."""

    node_feat: np.ndarray  # (N, Fn) int codes or float features
    edge_index: np.ndarray  # (2, E) int: [senders; receivers]
    edge_feat: Optional[np.ndarray] = None  # (E, Fe)
    y: Optional[np.ndarray] = None  # graph-level (T,), or node-level (N,)
    pe: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # per-graph arrays: LapPE's EigVals (1, K), and node-sized ones
    # (``loader.NODE_SIZED_AXES``) such as a transductive split's
    # ``split_mask`` (N,)
    extras: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def num_nodes(self) -> int:
        return int(self.node_feat.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    def view_with_extras(self, **extras) -> "Graph":
        """A view sharing the arrays, with its own ``pe`` and ``extras``
        dicts plus the given entries (``clone_with_extras`` of the JAX
        package): one graph behind the splits of a transductive task."""
        return dataclasses.replace(self, pe=dict(self.pe),
                                   extras={**self.extras, **extras})


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Padded batch of graphs on one device.

    Flat node layout: slot ``i`` belongs to graph ``i // max_nodes``; edge
    slot ``j`` to graph ``j // edge_block``.
    """

    node_feat: torch.Tensor  # (B*Nmax, Fn) int32 codes or float32 features
    edge_feat: Optional[torch.Tensor]  # (B*Ecap, Fe) int32 or float32
    senders: torch.Tensor  # (B*Ecap,) int32 into the flat node space
    receivers: torch.Tensor  # (B*Ecap,) int32
    node_mask: torch.Tensor  # (B*Nmax,) bool
    edge_mask: torch.Tensor  # (B*Ecap,) bool
    graph_mask: torch.Tensor  # (B,) bool
    # (B, T) with NaN on padded graphs; on a node task (B*Nmax,) labels, 0 on
    # padded slots
    y: Optional[torch.Tensor]
    pe: Dict[str, torch.Tensor]  # (B*Nmax, k) per encoding, 0 on padding
    num_graphs: int
    max_nodes: int
    edge_block: int
    # per-graph arrays (B, ...) by name; a padded graph holds what it read
    extras: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def num_node_slots(self) -> int:
        return self.num_graphs * self.max_nodes

    @property
    def device(self) -> torch.device:
        return self.node_mask.device

    def dense_view(self, x: torch.Tensor) -> torch.Tensor:
        """Flat node tensor (B*Nmax, ...) → (B, Nmax, ...)."""
        return x.reshape(self.num_graphs, self.max_nodes, *x.shape[1:])

    @functools.cached_property
    def front_index(self):
        """``(s_loc, r_loc, emask, nmask)``: graph-local endpoints as
        (B, Ecap) int32 and the masks as (B, Ecap)/(B, Nmax) float 1/0 -- the
        index layout the layer-front kernel takes. Made once per batch and
        shared by every layer."""
        B, N, E = self.num_graphs, self.max_nodes, self.edge_block
        base = (torch.arange(B, device=self.device, dtype=torch.int32)
                * N)[:, None]
        return (self.senders.reshape(B, E) - base,
                self.receivers.reshape(B, E) - base,
                self.edge_mask.reshape(B, E).float(),
                self.node_mask.reshape(B, N).float())

    @functools.cached_property
    def edge_gate_orders(self):
        """The long-graph edge gate's two edge orders of this batch (by
        receiver and by sender, with CSR offsets over the node slots:
        ``ops/kernels/edge_gate.py`` ``EdgeOrders``), built from
        ``front_index`` at first use and shared by every layer's forward
        and backward calls. A new batch builds its own."""
        from ..ops.kernels.edge_gate import edge_gate_orders

        s_loc, r_loc = self.front_index[:2]
        return edge_gate_orders(s_loc, r_loc, self.max_nodes)

    @functools.cached_property
    def counts(self):
        """(B,) int32 real nodes per graph (0 for a padded graph): the node
        masks are prefixes, so the wide attention kernel takes its key masks
        from these."""
        return self.node_mask.reshape(
            self.num_graphs, self.max_nodes).sum(1, dtype=torch.int32)

    @functools.cached_property
    def real_counts(self):
        """``(real nodes, real edges)`` as f32 scalars, at least 1: the row
        counts of the BatchNorm statistics."""
        return (torch.clamp(self.node_mask.float().sum(), min=1.0),
                torch.clamp(self.edge_mask.float().sum(), min=1.0))

    def to(self, device) -> "GraphBatch":
        def mv(t):
            return t.to(device) if t is not None else None
        return dataclasses.replace(
            self, node_feat=mv(self.node_feat), edge_feat=mv(self.edge_feat),
            senders=mv(self.senders), receivers=mv(self.receivers),
            node_mask=mv(self.node_mask), edge_mask=mv(self.edge_mask),
            graph_mask=mv(self.graph_mask), y=mv(self.y),
            pe={k: mv(v) for k, v in self.pe.items()},
            extras={k: mv(v) for k, v in self.extras.items()})
