"""GPSModel: FeatureEncoder → L × GPSLayer (CustomGatedGCN or GCN ∥
Transformer) → head, SANTransformer:
FeatureEncoder → L × SANLayer → head, and the dispatch to GraphormerNet
(``models/graphormer.py``) (counterpart of
``graphgps_tpu/models/networks.py:175-239`` ``GPSModel``, :153 ``_make_head``,
:240-268 ``SANTransformer``, :269 ``GraphormerNet`` and :411
``build_model``; a plain layer loop in place of ``nn.scan``, and the
activations stored for the backward in place of ``parallel.remat``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..data.graph import GraphBatch
from .encoders import FeatureEncoder
from .gps_layer import ATTN_IMPLS, GLOBAL_TYPES, LOCAL_TYPES, MIN_DIM, GPSLayer
from .heads import GraphormerGraphHead, InductiveNodeHead, SANGraphHead
from .san import SANLayer


def check_graphormer_supported(cfg) -> None:
    """The Graphormer configurations the port runs: graph tasks with the
    ``graphormer_graph`` head (the node-task recipes need transductive
    splits); the encoders raise on their own."""
    if cfg.dataset.task != "graph":
        raise NotImplementedError(
            f"model.type=Graphormer on dataset.task={cfg.dataset.task!r}: "
            "node tasks need transductive splits and the node head, not "
            "ported (ROADMAP Queue 1 item 17)")
    if cfg.gnn.head != "graphormer_graph":
        raise NotImplementedError(
            f"gnn.head={cfg.gnn.head!r} on a Graphormer: the port has "
            "graphormer_graph (ROADMAP Queue 1 item 17)")
    if cfg.train.get("log_attn_weights", False):
        raise NotImplementedError(
            "train.log_attn_weights is not ported (ROADMAP Queue 1 item 17)")


def check_san_supported(cfg) -> None:
    """The SANTransformer configurations the port runs: plain SAN (not
    SAN2's learnable γ), BatchNorm or no norm, ``full_graph`` either way,
    and ``check_stack_supported``. The encoders raise on their own."""
    gt = cfg.gt
    if gt.layer_type == "SAN2" or gt.gamma_learnable:
        raise NotImplementedError(
            "SAN2 / gt.gamma_learnable (a learnable γ, and its epoch γ "
            "logging, graphgps_tpu/train/loop.py:963-970) is not ported "
            "(ROADMAP Queue 1 item 15)")
    if gt.layer_norm:
        raise NotImplementedError(
            "gt.layer_norm=true on SAN: MaskedLayerNorm is not ported "
            "(ROADMAP Queue 1 item 15)")
    check_stack_supported(cfg)


def check_stack_supported(cfg) -> None:
    """What a GPSModel and a SANTransformer share: no ``layers_pre_mp``,
    the san_graph or the inductive_node head, no EquivStableLapPE, no
    attention-weight logging."""
    if cfg.gnn.layers_pre_mp > 0:
        raise NotImplementedError(
            "gnn.layers_pre_mp > 0 is not ported (ROADMAP Queue 1 item 17)")
    if cfg.gnn.head not in HEADS:
        what = ("an edge head, for edge and link tasks"
                if cfg.gnn.head in EDGE_HEADS else "the default graph head")
        raise NotImplementedError(
            f"gnn.head={cfg.gnn.head!r}: the port has {sorted(HEADS)} "
            f"({what}: ROADMAP Queue 1 item 17)")
    if cfg.posenc_EquivStableLapPE.enable:
        raise NotImplementedError(
            "EquivStableLapPE is not ported (ROADMAP Queue 1 item 16)")
    if cfg.train.get("log_attn_weights", False):
        raise NotImplementedError(
            "train.log_attn_weights is not ported (ROADMAP Queue 1 item 17)")


# local GNNs of the JAX GPSLayer the port does not run yet (local_gnn.py
# :332-519): ROADMAP Queue 1 item 13 brings them
LOCAL_TODO = ("GINE", "GIN", "GAT", "GENConv", "PNA")


def check_supported(cfg) -> None:
    """The configurations the port runs (GPSModel, CustomGatedGCN ∥
    Transformer or BigBird with BatchNorm or GCN ∥ Transformer or BigBird
    with BatchNorm or none,
    no LayerNorm, ``gt.attn_impl`` any of JAX's but ring, the san_graph,
    inductive_node or node head, at a width of 64 or more; a SANTransformer,
    ``check_san_supported``; or a Graphormer,
    ``check_graphormer_supported``); anything else names the ROADMAP item
    that brings it."""
    gt = cfg.gt
    if cfg.model.type == "Graphormer":
        return check_graphormer_supported(cfg)
    if cfg.model.type == "SANTransformer":
        return check_san_supported(cfg)
    if cfg.model.type != "GPSModel":
        raise NotImplementedError(
            f"model.type={cfg.model.type!r} is not ported (ROADMAP Queue 1 "
            "item 15)")
    local, _, glob = gt.layer_type.partition("+")
    if glob not in GLOBAL_TYPES or local not in LOCAL_TYPES:
        item = "Queue 1 item 13" if local in LOCAL_TODO else \
            "Queue 1 items 12-15"
        raise NotImplementedError(
            f"gt.layer_type={gt.layer_type!r}: the port runs "
            f"{' and '.join(LOCAL_TYPES)} with {' or '.join(GLOBAL_TYPES)} "
            f"(ROADMAP {item})")
    if gt.layer_norm:
        raise NotImplementedError(
            "gt.layer_norm=true: GPSLayer's LayerNorm option is not ported "
            "(ROADMAP Queue 1 item 15)")
    if local == "CustomGatedGCN" and not gt.batch_norm:
        raise NotImplementedError(
            "CustomGatedGCN+Transformer needs gt.batch_norm=true (ROADMAP "
            "Queue 1 item 15)")
    if gt.dim_hidden < MIN_DIM:
        raise NotImplementedError(
            f"gt.dim_hidden={gt.dim_hidden} < {MIN_DIM}: the layer's path "
            "without fused kernels is not ported (ROADMAP Queue 1 item 5)")
    if gt.attn_impl not in ATTN_IMPLS:
        item = "Queue 1 item 18" if gt.attn_impl == "ring" else \
            "Queue 1 item 14"
        raise NotImplementedError(
            f"gt.attn_impl={gt.attn_impl!r}: the port runs {ATTN_IMPLS} "
            f"(ROADMAP {item})")
    check_stack_supported(cfg)


# "node" is JAX's transductive alias of inductive_node (heads.py:110): the
# split masks ride the loss mask
HEADS = ("san_graph", "inductive_node", "node")
# the JAX package's heads over edges and links (graphgps_tpu/models/heads.py
# :142, :198), which the port does not build yet
EDGE_HEADS = ("inductive_edge", "infer_links")


def make_head(cfg, dim_in: int, dim_out: int) -> nn.Module:
    """The head ``gnn.head`` names: san_graph ignores ``gnn.layers_post_mp``
    (two halving layers and the output), the node head takes it."""
    if cfg.gnn.head == "san_graph":
        return SANGraphHead(dim_in, dim_out, pooling=cfg.model.graph_pooling)
    if cfg.gnn.head == "graphormer_graph":
        return GraphormerGraphHead(dim_in, dim_out,
                                   pooling=cfg.model.graph_pooling)
    return InductiveNodeHead(dim_in, dim_out,
                             layers=max(1, cfg.gnn.layers_post_mp))


class SANTransformer(nn.Module):
    """FeatureEncoder (Atom+LapPE, Bond on ogbg-molhiv) → L × SANLayer →
    head."""

    def __init__(self, cfg, dim_out: int):
        super().__init__()
        check_san_supported(cfg)
        gt, d = cfg.gt, cfg.gt.dim_hidden
        self.encoder = FeatureEncoder(cfg, d)
        self.layers = nn.ModuleList(
            SANLayer(d, gt.n_heads, gamma=gt.gamma, full_graph=gt.full_graph,
                     dropout=gt.dropout, batch_norm=gt.batch_norm,
                     residual=gt.residual)
            for _ in range(gt.layers))
        self.head = make_head(cfg, d, dim_out)

    def forward(self, batch: GraphBatch,
                gen: Optional[torch.Generator] = None):
        """Returns (pred, true) as ``GPSModel.forward``; in training ``gen``
        draws LapPE's sign flip and every dropout seed."""
        x, e = self.encoder(batch, gen)
        for layer in self.layers:
            x, e = layer(batch, x, e, gen)
        return self.head(batch, x)


class GPSModel(nn.Module):
    def __init__(self, cfg, dim_out: int):
        """Each batch takes the merged front where its node slots, the
        width and the settings allow (``GPSLayer.takes_merged``)."""
        super().__init__()
        check_supported(cfg)
        d = cfg.gt.dim_hidden
        self.encoder = FeatureEncoder(cfg, d)
        self.layers = nn.ModuleList(
            GPSLayer(d, cfg.gt.n_heads, act=cfg.gnn.act,
                     dropout=cfg.gt.dropout, attn_dropout=cfg.gt.attn_dropout,
                     local=cfg.gt.layer_type.split("+")[0],
                     batch_norm=cfg.gt.batch_norm,
                     attn_impl=cfg.gt.attn_impl,
                     global_type=cfg.gt.layer_type.split("+")[1],
                     bigbird=dict(cfg.gt.bigbird), layer_index=i)
            for i in range(cfg.gt.layers))
        self.head = make_head(cfg, d, dim_out)

    def forward(self, batch: GraphBatch,
                gen: Optional[torch.Generator] = None):
        """Returns (pred, true): (B, dim_out) and (B, T) from a graph head,
        (B*N, dim_out) and (B*N,) from the node head. In training, ``gen``
        (a host generator) draws LapPE's sign flip and every layer's dropout
        seeds."""
        x, e = self.encoder(batch, gen)
        for layer in self.layers:
            x, e = layer(batch, x, e, gen)
        return self.head(batch, x)


def build_model(cfg, dim_out: int):
    """The network ``model.type`` names: GPSModel, SANTransformer or
    GraphormerNet."""
    check_supported(cfg)
    if cfg.model.type == "SANTransformer":
        return SANTransformer(cfg, dim_out)
    if cfg.model.type == "Graphormer":
        from .graphormer import GraphormerNet

        return GraphormerNet(cfg, dim_out)
    return GPSModel(cfg, dim_out)
