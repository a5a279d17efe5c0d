"""Graph pooling, the san_graph, default graph, graphormer_graph and node
heads (counterpart of ``graphgps_tpu/models/heads.py``: ``global_mean_pool``
:38, ``graph_token_pool`` :52-60, ``SANGraphHead`` :67-89, ``GNNGraphHead``
:90-107, ``InductiveNodeHead`` :110-124, ``GraphormerGraphHead``
:128-138)."""
from __future__ import annotations

import torch
from torch import nn

from ..data.graph import GraphBatch
from .common import MLP, LayerNorm, get_act


def _masked_dense(x, batch: GraphBatch):
    xd = batch.dense_view(x)
    m = batch.dense_view(batch.node_mask)[..., None]
    return torch.where(m, xd, 0.0), m


def global_add_pool(x, batch: GraphBatch):
    return _masked_dense(x, batch)[0].sum(dim=1)


def global_mean_pool(x, batch: GraphBatch):
    xd, m = _masked_dense(x, batch)
    return xd.sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-6)


def graph_token_pool(x, batch: GraphBatch):
    """Each graph's first node slot: the Graphormer token where no token
    state is threaded through the layer stack (the head takes that state
    itself)."""
    return batch.dense_view(x)[:, 0, :]


POOLING = {"add": global_add_pool, "mean": global_mean_pool,
           "graph_token": graph_token_pool}


class SANGraphHead(nn.Module):
    """Pool → (layers − 1) halving Linears with activation → output Linear.
    Like the JAX head it ignores ``gnn.layers_post_mp`` and uses relu."""

    def __init__(self, dim_in: int, dim_out: int, pooling: str = "add",
                 layers: int = 3, act: str = "relu"):
        super().__init__()
        if pooling not in POOLING:
            raise NotImplementedError(f"graph_pooling {pooling!r} is not ported")
        self.pool = POOLING[pooling]
        self.act = get_act(act)
        dims = [dim_in // 2 ** i for i in range(layers)]
        self.hidden = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.out = nn.Linear(dims[-1], dim_out)

    def forward(self, batch: GraphBatch, x):
        g = self.pool(x, batch)
        for lin in self.hidden:
            g = self.act(lin(g))
        return self.out(g), batch.y


class GNNGraphHead(nn.Module):
    """The default graph head (``default`` or ``graph``): pool → ``layers``
    Linears of the input width with relu between them, the last to
    ``dim_out``. Like the JAX head it takes no BatchNorm, no dropout and
    not ``gnn.act``."""

    def __init__(self, dim_in: int, dim_out: int, pooling: str = "mean",
                 layers: int = 1, act: str = "relu"):
        super().__init__()
        if pooling not in POOLING:
            raise NotImplementedError(f"graph_pooling {pooling!r} is not ported")
        self.pool = POOLING[pooling]
        self.mlp = MLP(dim_in, dim_in, dim_out, num_layers=max(1, layers),
                       act=act)

    def forward(self, batch: GraphBatch, x):
        return self.mlp(self.pool(x, batch)), batch.y


class InductiveNodeHead(nn.Module):
    """Node-level MLP head: ``layers`` Linears of the input width with relu
    between them, the last to ``dim_out``; predictions for every node slot
    (the loss and the metrics take the real ones by the node mask)."""

    def __init__(self, dim_in: int, dim_out: int, layers: int = 3,
                 act: str = "relu"):
        super().__init__()
        self.mlp = MLP(dim_in, dim_in, dim_out, num_layers=max(1, layers),
                       act=act)

    def forward(self, batch: GraphBatch, x):
        return self.mlp(x), batch.y


class GraphormerGraphHead(nn.Module):
    """LayerNorm over the node rows → pool → Linear. As in the JAX package,
    ``graph_token`` pooling with a token returns the token's own state, so
    the LayerNorm's output reaches nothing there: its parameters exist
    (``norm``), get zero gradients and are decayed by adamW. (Upstream
    GraphGPS normalises the token, its node 0: ROADMAP Queue 3.)"""

    def __init__(self, dim_in: int, dim_out: int,
                 pooling: str = "graph_token"):
        super().__init__()
        if pooling not in POOLING:
            raise NotImplementedError(
                f"graph_pooling {pooling!r} is not ported")
        self.pooling = pooling
        self.norm = LayerNorm(dim_in)
        self.out = nn.Linear(dim_in, dim_out)

    def forward(self, batch: GraphBatch, x, tok=None):
        if self.pooling == "graph_token" and tok is not None:
            g = tok    # the LayerNorm's output would reach nothing
        else:
            g = POOLING[self.pooling](self.norm(x), batch)
        return self.out(g), batch.y
