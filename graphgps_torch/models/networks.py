"""GPSModel: FeatureEncoder → L × GPSLayer → san_graph head (counterpart
of ``graphgps_tpu/models/networks.py:175-239`` ``GPSModel`` and :411
``build_model``; a plain layer loop in place of ``nn.scan``, and the
activations stored for the backward in place of ``parallel.remat``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..data.graph import GraphBatch
from .encoders import FeatureEncoder
from .gps_layer import GPSLayer
from .heads import SANGraphHead


def check_supported(cfg) -> None:
    """The one configuration this slice runs; anything else names the
    ROADMAP item that brings it."""
    gt = cfg.gt
    if cfg.model.type != "GPSModel":
        raise NotImplementedError(
            f"model.type={cfg.model.type!r} is not ported (ROADMAP Queue 1 "
            "item 15)")
    if gt.layer_type != "CustomGatedGCN+Transformer":
        raise NotImplementedError(
            f"gt.layer_type={gt.layer_type!r}: the port runs "
            "CustomGatedGCN+Transformer only (ROADMAP Queue 1 items 12-15)")
    if not gt.batch_norm or gt.layer_norm:
        raise NotImplementedError(
            "the port needs gt.batch_norm=true and gt.layer_norm=false "
            "(ROADMAP Queue 1 item 15)")
    if cfg.gnn.layers_pre_mp > 0 or cfg.gnn.head != "san_graph":
        raise NotImplementedError(
            "gnn.layers_pre_mp > 0 or a head other than san_graph is not "
            "ported (ROADMAP Queue 1 item 17)")
    if cfg.posenc_EquivStableLapPE.enable:
        raise NotImplementedError(
            "EquivStableLapPE is not ported (ROADMAP Queue 1 item 16)")
    if cfg.train.get("log_attn_weights", False):
        raise NotImplementedError(
            "train.log_attn_weights is not ported (ROADMAP Queue 1 item 17)")


class GPSModel(nn.Module):
    def __init__(self, cfg, dim_out: int):
        super().__init__()
        check_supported(cfg)
        d = cfg.gt.dim_hidden
        self.encoder = FeatureEncoder(cfg, d)
        self.layers = nn.ModuleList(
            GPSLayer(d, cfg.gt.n_heads, act=cfg.gnn.act,
                     dropout=cfg.gt.dropout, attn_dropout=cfg.gt.attn_dropout)
            for _ in range(cfg.gt.layers))
        self.head = SANGraphHead(d, dim_out, pooling=cfg.model.graph_pooling)

    def forward(self, batch: GraphBatch,
                gen: Optional[torch.Generator] = None):
        """Returns (pred (B, dim_out), true (B, T)). In training, ``gen``
        (a host generator) draws every layer's dropout seeds."""
        x, e = self.encoder(batch)
        for layer in self.layers:
            x, e = layer(batch, x, e, gen)
        return self.head(batch, x)


def build_model(cfg, dim_out: int) -> GPSModel:
    return GPSModel(cfg, dim_out)
